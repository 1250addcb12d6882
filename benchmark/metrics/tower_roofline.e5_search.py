"""The decoder tower's share of its roofline: each batch's forward at its
real lengths (opcount_decoder.forward_flops) and the weights read once
(opcount_decoder.weight_bytes), the larger of the two times on the card,
summed over the batches, over the device seconds of the kernels launched
inside the BATCH spans (TraceSummary.batch_groups) that drivers/e5_search.py
opens around encode_query alone."""
from benchmark import opcount_decoder
from benchmark.roofline import bound_s, share_pct


def read(ctx):
    w, t = ctx["work"], ctx["trace"]
    if not t.batch_groups:
        return None
    cfg = ctx["config"]
    bound = sum(bound_s(opcount_decoder.weight_bytes(cfg),
                        opcount_decoder.forward_flops(cfg, lengths))
                for lengths in w["batch_lengths"])
    return share_pct(bound, sum(sum(groups.values()) for groups in t.batch_groups))
