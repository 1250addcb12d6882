"""The whole retrieve batch's share of the card's bf16 peak: the decoder
tower's forward over the real tokens of each batch (opcount_decoder:
projections and causal attention pairs), plus the exact search's block
maxima, 2 N Q D, times the batches of the traced window, over the window's
seconds times 989 TFLOP/s."""
from benchmark import opcount_decoder
from benchmark.roofline import PEAKS


def read(ctx):
    w, t = ctx["work"], ctx["trace"]
    flops = sum(opcount_decoder.forward_flops(ctx["config"], lengths)
                for lengths in w["batch_lengths"])
    flops += 2.0 * w["n"] * w["q"] * w["d"] * w["calls"]
    return 100.0 * flops / (t.window_s * PEAKS["bf16_flops"])
