"""The bucketing's padding: positions the tower was handed (B x T of every
batch of the traced window, recorded as the program hands them over) that
hold no real token, over all positions handed over. A count, exact."""


def read(ctx):
    w = ctx["work"]
    positions = sum(b * t for b, t in w["batch_shapes"])
    return 100.0 * (1.0 - w["tokens"] / positions) if positions else None
