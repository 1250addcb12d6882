"""The whole search's share of the card's bf16 peak: the block maxima's
2 N Q D operations a batch, times the batches of the traced window, over
the window's seconds times 989 TFLOP/s. (The select and rescore add under
0.1% to the count.)"""
from benchmark.roofline import PEAKS


def read(ctx):
    w, t = ctx["work"], ctx["trace"]
    flops = 2.0 * w["n"] * w["q"] * w["d"] * w["calls"]
    return 100.0 * flops / (t.window_s * PEAKS["bf16_flops"])
