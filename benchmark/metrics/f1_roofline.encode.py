"""F1's share of its roofline in the encode: every dense epilogue of the
tower over the real tokens of the traced window's calls
(opcount.epilogue_work: the f32 product read and the bf16 output written
once an element, GELU at 25 operations, against the f32 peak), over the
device time of the "F1 dense epilogue" kernels."""
from benchmark import opcount
from benchmark.roofline import PEAKS, bound_s, share_pct


def read(ctx):
    w, t = ctx["work"], ctx["trace"]
    flops, nbytes = opcount.epilogue_work(ctx["config"], w["row_lengths"])
    return share_pct(bound_s(nbytes, flops, PEAKS["f32_flops"]),
                     t.group_s.get("F1 dense epilogue", 0.0))
