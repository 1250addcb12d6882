"""Operations and bytes of the BERT tower's pieces, from a configuration and
the real (unpadded) lengths of the rows: what the inputs need, whatever
padding the program adds. Shared by the encode cell's readers."""
from __future__ import annotations


def dims(cfg: dict) -> tuple[int, int, int, int]:
    """hidden, intermediate, layers, embedding width."""
    return (cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"],
            cfg["projection_dim"] or cfg["hidden_size"])


def forward_flops(cfg: dict, lengths) -> float:
    """The tower's forward over rows of these lengths: the dense layers
    (2 L (4 H^2 + 2 H I) a layer), the attention products (4 L^2 H a layer),
    the pooler and the projection on the [CLS] row."""
    h, i, layers, e = dims(cfg)
    total = 0.0
    for n in lengths:
        total += layers * (2.0 * n * (4 * h * h + 2 * h * i) + 4.0 * n * n * h)
        total += 2.0 * h * h + 2.0 * h * e
    return total


def attention_work(cfg: dict, lengths) -> tuple[float, float]:
    """One attention layer's (operations, bytes) over rows of these lengths:
    QK^T and PV, 4 L^2 H; q, k, v read and the context written once, bf16."""
    h = cfg["hidden_size"]
    return (sum(4.0 * n * n * h for n in lengths), sum(8.0 * n * h for n in lengths))


def attention_backward_work(cfg: dict, lengths) -> tuple[float, float]:
    """One attention layer's backward (operations, bytes) over rows of these
    lengths: dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q, 8 L^2 H; q,
    k, v and dO read and dq, dk, dv written once, bf16."""
    h = cfg["hidden_size"]
    return (sum(8.0 * n * n * h for n in lengths), sum(14.0 * n * h for n in lengths))


def epilogue_work(cfg: dict, lengths) -> tuple[float, float]:
    """The dense epilogues' (operations, bytes) of the whole tower over rows
    of these lengths: each output element of q, k, v, attn_out, mlp_in
    (with GELU, 25 operations) and mlp_out read as the f32 product and
    written bf16 (6 bytes); the pooler's [CLS] row likewise and the
    projection's written f32 (8 bytes)."""
    h, i, layers, e = dims(cfg)
    tokens, rows = float(sum(lengths)), len(lengths)
    plain = layers * tokens * 5 * h + rows * h
    gelu = layers * tokens * i
    return (plain + 25.0 * gelu, 6.0 * (plain + gelu) + 8.0 * rows * e)
