"""K2's share of its roofline in the encode: the attention of the batches
that ran K2 (a "K2 attention" kernel launched inside the batch's span),
4 L^2 H operations and 8 L H bytes a row and layer at each row's real
length L (opcount.attention_work), over the device time of the K2 kernels
in the traced window."""
from benchmark import opcount
from benchmark.roofline import bound_s, share_pct

GROUP = "K2 attention"


def read(ctx):
    w, t = ctx["work"], ctx["trace"]
    seconds = t.group_s.get(GROUP, 0.0)
    if seconds == 0:
        return None
    lengths = [n for groups, rows in zip(t.batch_groups, w["batch_lengths"])
               if groups.get(GROUP, 0.0) > 0 for n in rows]
    flops, nbytes = opcount.attention_work(ctx["config"], lengths)
    layers = ctx["config"]["num_hidden_layers"]
    return share_pct(layers * bound_s(nbytes, flops), seconds)
