"""A BERT tower cell's share of the card's bf16 peak: the towers' forward
operations over the real tokens of the traced window, each row at its own
length (opcount.forward_flops), times the passes the driver records (1 for
an encode; 3 for a train step, forward and backward, remat's recompute not
counted), over the window's seconds times 989 TFLOP/s. The search's share
has its own reader, mfu.search.py."""
from benchmark import opcount
from benchmark.roofline import PEAKS


def read(ctx):
    w, t = ctx["work"], ctx["trace"]
    return 100.0 * w["passes"] * opcount.forward_flops(ctx["config"], w["row_lengths"]) / (
        t.window_s * PEAKS["bf16_flops"])
