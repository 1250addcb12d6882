"""K1's share of its roofline: the block-maxima kernel's operations,
2 N Q D a batch, and its bytes, the index's N D and the queries' Q D bf16
values read once, over the device time of the "K1 block_maxima" kernels a
batch in the traced window."""
from benchmark.roofline import bound_s, share_pct


def read(ctx):
    w, t = ctx["work"], ctx["trace"]
    seconds = t.group_s.get("K1 block_maxima", 0.0) / w["calls"]
    n, q, d = w["n"], w["q"], w["d"]
    return share_pct(bound_s(2 * (n * d + q * d), 2.0 * n * q * d), seconds)
