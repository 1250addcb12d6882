"""F2's RMSNorm form's share of its roofline in the E5 cell: every norm of
the tower over the real tokens of the traced window's batches, and the
final norm of each row's last token (opcount_decoder.rms_work: x and the
residual read, the output and the sum written once, bf16), over the device
time of the "F2 add+LayerNorm" kernels; only the tower launches them in
this cell."""
from benchmark import opcount_decoder
from benchmark.roofline import PEAKS, bound_s, share_pct


def read(ctx):
    w, t = ctx["work"], ctx["trace"]
    lengths = [n for batch in w["batch_lengths"] for n in batch]
    flops, nbytes = opcount_decoder.rms_work(ctx["config"], lengths)
    return share_pct(bound_s(nbytes, flops, PEAKS["f32_flops"]),
                     t.group_s.get("F2 add+LayerNorm", 0.0))
