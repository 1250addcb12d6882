"""Operations and bytes of a Mistral-style decoder tower's pieces, from a
configuration and the real (unpadded) lengths of the rows: what the inputs
need, whatever padding the program adds. Shared by the E5 cell's readers."""
from __future__ import annotations


def dims(cfg: dict) -> tuple[int, int, int, int, int, int]:
    """hidden, intermediate, layers, query heads, kv heads, head dim."""
    return (cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"],
            cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"])


def attention_pairs(n: int, window: int | None) -> int:
    """The (query, key) pairs causal attention over a row of n tokens takes:
    query i sees min(i + 1, window) keys."""
    w = n if window is None else min(n, window)
    return w * (w + 1) // 2 + (n - w) * w


def forward_flops(cfg: dict, lengths) -> float:
    """The tower's forward over rows of these lengths: the projections
    (2 H ((nq + 2 nkv) hd + nq hd + 3 I) a token and layer) and the
    attention products, q k^T and p v, 4 nq hd a (query, key) pair and
    layer; the pooled row's final norm and normalisation are not counted."""
    h, i, layers, nq, nkv, hd = dims(cfg)
    dense = 2.0 * h * ((nq + 2 * nkv) * hd + nq * hd + 3 * i)
    window = cfg.get("sliding_window")
    return sum(layers * (n * dense + 4.0 * nq * hd * attention_pairs(n, window))
               for n in lengths)


def weight_bytes(cfg: dict) -> float:
    """Every projection's and norm's weights read once, and one embedding
    row a token at most: the bytes a forward cannot avoid, in the weight
    dtype (bf16, 2 B)."""
    h, i, layers, nq, nkv, hd = dims(cfg)
    per_layer = h * ((nq + 2 * nkv) * hd + 3 * i) + nq * hd * h + 2 * h
    return 2.0 * (layers * per_layer + h)


def swiglu_work(cfg: dict, lengths) -> tuple[float, float]:
    """F1's SwiGLU form over the tower's real tokens: (operations, bytes).
    Each of the I outputs a token and layer reads its gate and up values
    and writes itself, bf16 (6 B), and takes silu's exp, add and divide and
    the product (4 operations, counted against the f32 peak)."""
    h, i, layers, *_ = dims(cfg)
    outputs = float(layers * i * sum(lengths))
    return 4.0 * outputs, 6.0 * outputs


def rms_work(cfg: dict, lengths) -> tuple[float, float]:
    """F2's RMSNorm form over the tower's real tokens: (operations, bytes).
    Two norms a layer and token: the first layer's first reads x and writes
    the output (4 B an element, bf16), every other reads x and the residual
    and writes the output and the sum (8 B); the final norm the same for
    each row's last token. 5 operations an element (the add, the square and
    its sum, two products)."""
    h, _, layers, *_ = dims(cfg)
    tokens, rows = float(sum(lengths)), len(lengths)
    plain = tokens * h
    fused = (2 * layers - 1) * tokens * h + rows * h
    return 5.0 * (plain + fused), 4.0 * plain + 8.0 * fused
