"""The padding to each batch's longest row: positions the decoder tower
was handed in the traced window (B x T a call, the tower's own
`positions` counter) that hold no real token (its `tokens` counter), over
all positions handed over. A count, exact; None where the program has no
such counters."""


def read(ctx):
    w = ctx["work"]
    positions = w.get("tower_positions")
    return 100.0 * (1.0 - w["tower_tokens"] / positions) if positions else None
