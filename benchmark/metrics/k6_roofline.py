"""K6's share of its roofline: the gathered rescore reads the candidate
rows of a batch, each block that the batch's queries select read once
however many queries select it (the driver counts them from the
reference's block maxima, k6_rows), and the queries, and writes Q k block
f32 scores; 2 Q k block D operations. Over the device time of the "K6/K9
gather_score" kernels a batch in the traced window."""
from benchmark.roofline import bound_s, share_pct


def read(ctx):
    w, t = ctx["work"], ctx["trace"]
    seconds = t.group_s.get("K6/K9 gather_score", 0.0) / w["calls"]
    q, k, d, block = w["q"], w["k"], w["d"], w["block"]
    scored = q * k * block
    nbytes = 2 * w["k6_rows"] * d + 2 * q * d + 4 * scored
    return share_pct(bound_s(nbytes, 2.0 * scored * d), seconds)
