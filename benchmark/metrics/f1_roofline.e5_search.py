"""F1's SwiGLU form's share of its roofline in the E5 cell: every MLP's
epilogue over the real tokens of the traced window's batches
(opcount_decoder.swiglu_work: gate and up read and the output written
once, bf16, against the f32 peak for its 4 operations an element), over
the device time of the "F1 dense epilogue" kernels; only the tower
launches them in this cell."""
from benchmark import opcount_decoder
from benchmark.roofline import PEAKS, bound_s, share_pct


def read(ctx):
    w, t = ctx["work"], ctx["trace"]
    lengths = [n for batch in w["batch_lengths"] for n in batch]
    flops, nbytes = opcount_decoder.swiglu_work(ctx["config"], lengths)
    return share_pct(bound_s(nbytes, flops, PEAKS["f32_flops"]),
                     t.group_s.get("F1 dense epilogue", 0.0))
