"""K3's share of its roofline in the train step: the attention backward of
the paragraph tower (the tower whose padded width K3 takes),
8 L^2 H operations and 14 L H bytes a row and layer at each paragraph's
real length L (opcount.attention_backward_work), over the device time of
the "K3 attention backward" kernels in the traced window."""
from benchmark import opcount
from benchmark.roofline import bound_s, share_pct


def read(ctx):
    w, t = ctx["work"], ctx["trace"]
    flops, nbytes = opcount.attention_backward_work(ctx["config"], w["c_lengths"])
    layers = ctx["config"]["num_hidden_layers"]
    return share_pct(layers * bound_s(nbytes, flops), t.group_s.get("K3 attention backward", 0.0))
