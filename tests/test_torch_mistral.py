"""The E5-Mistral decoder tower (models/mistral.py) on the CPU at a tiny
config (hidden 64, 4 query heads over 2 kv heads of 16, FFN 160, 2 layers,
vocabulary 128), seeded weights, held to the benchmark's plain reference
(benchmark/reference/mistral.py), to HF transformers' MistralModel where it
is installed, and the decoder's F1 and F2 forms (ops/fused_bert.py) to their
plain versions and choosers.

Tolerances, each with its reason (embed gaps are reference/bert.py:worst_gap,
the largest row distance over the rows' spread):
- EMBED_GAP_BF16: the program and the reference round at the same points;
  only the order of f32 sums differs (a batch's product against each
  token's), which can move a bf16 rounding by one ulp (2^-8 relative), and
  a few such flips through two layers stay far below 0.05;
- EMBED_GAP_F32: the same in f32, where a different order of sums moves the
  result by f32 ulps;
- HF_F32_TOL: HF's Mistral in f32 and the port in f32 do the same
  arithmetic but for the order of sums (HF's eager attention, the port's
  grouped products).
An e4m3-rounded run (the reference with reference/bert.py:fp8 at every
rounding point) fails each of them (test_e4m3_run_fails_each_tolerance).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark import decoder_weights as dw  # noqa: E402
from benchmark.reference import mistral as ref  # noqa: E402
from proqa_tpu_torch import _build  # noqa: E402
from proqa_tpu_torch.data.collate import collate_tokens  # noqa: E402
from proqa_tpu_torch.index.build import encode_corpus  # noqa: E402
from proqa_tpu_torch.index.dense import DenseIndex  # noqa: E402
from proqa_tpu_torch.models import hf_convert, mistral  # noqa: E402
from proqa_tpu_torch.ops import fused_bert, rope  # noqa: E402
from proqa_tpu_torch.testing import topk_disagreements  # noqa: E402

EMBED_GAP_BF16 = 0.05
EMBED_GAP_F32 = 1e-5
HF_F32_TOL = 1e-5

TINY = {"vocab_size": 128, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "intermediate_size": 160, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
        "sliding_window": 4096, "initializer_range": 0.02, "torch_dtype": "bfloat16"}


def _cfg(**kw) -> dict:
    return {**TINY, **kw}


def _model(cfg: dict, seed: int = 3):
    """The program's retriever with the benchmark's seeded weights, and them."""
    w = dw.decoder_weights(seed, cfg, "cpu")
    model = mistral.MistralRetriever(mistral.MistralConfig.from_json(cfg))
    model.load_state_dict(w)
    return model.eval(), w


def _rows(seed: int, lengths) -> list[list[int]]:
    """BOS, ids in [3, vocab), EOS: rows of these lengths."""
    g = torch.Generator().manual_seed(seed)
    return [[1] + torch.randint(3, TINY["vocab_size"], (n - 2,), generator=g).tolist() + [2]
            for n in lengths]


def _batch(rows):
    """Right-padded to the longest row, as the program pads (data/collate.py)."""
    ids = torch.from_numpy(collate_tokens(rows)).long()
    return ids, (ids != 0).to(torch.int32)


def _gap(got, want) -> float:
    return ref.worst_gap(list(got), list(want))


LENGTHS = (5, 9, 17, 3, 12, 28)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_embeddings_match_reference(dtype):
    cfg = _cfg(torch_dtype=dtype)
    model, w = _model(cfg)
    rows = _rows(0, LENGTHS)
    got = model.encode_query(*_batch(rows))
    rnd = ref.bf16 if dtype == "bfloat16" else (lambda x: x)
    want = ref.embed_rows(rows, w, cfg, "cpu", rnd=rnd)
    assert got.dtype == torch.float32 and got.shape == (len(rows), TINY["hidden_size"])
    assert _gap(got, want) <= (EMBED_GAP_BF16 if dtype == "bfloat16" else EMBED_GAP_F32)


def test_embeddings_have_unit_norm():
    model, _ = _model(_cfg())
    got = model.encode_context(*_batch(_rows(1, LENGTHS)))
    torch.testing.assert_close(got.norm(dim=-1), torch.ones(len(LENGTHS)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("tolerance", ["EMBED_GAP_BF16", "EMBED_GAP_F32", "HF_F32_TOL"])
def test_e4m3_run_fails_each_tolerance(tolerance):
    """The control: the reference rounded to e4m3 where the program rounds
    to bf16, against the bf16 reference (f32 for the f32 tolerances)."""
    dtype = "bfloat16" if tolerance == "EMBED_GAP_BF16" else "float32"
    cfg = _cfg(torch_dtype=dtype)
    _, w = _model(cfg)
    rows = _rows(0, LENGTHS)
    want = ref.embed_rows(rows, w, cfg, "cpu", rnd=ref.bf16 if dtype == "bfloat16" else
                          (lambda x: x))
    e4m3 = torch.stack(ref.embed_rows(rows, w, cfg, "cpu", rnd=ref.fp8))
    limit = globals()[tolerance]
    if tolerance == "HF_F32_TOL":  # an absolute tolerance on the embeddings
        assert (e4m3 - torch.stack(want)).abs().max() > 10 * limit
    else:
        assert _gap(e4m3, want) > 3 * limit


def test_right_padding_leaves_the_embedding_unchanged():
    """A row alone, and padded in a batch whose longest row is 3x longer,
    gives the same embedding: nothing past its last real token reaches it."""
    model, _ = _model(_cfg())
    rows = _rows(2, LENGTHS)
    batch = model.encode_query(*_batch(rows))
    for i, r in enumerate(rows):
        alone = model.encode_query(*_batch([r]))
        assert torch.equal(alone[0], batch[i]), i


def _every_position(b: int, t: int) -> mistral.Packing:
    """The packing of every position of a [B, T] batch, pads included."""
    return mistral.Packing.of(torch.full((b,), t), t, "cpu")


@torch.no_grad()
def _hidden_states(tower, ids, mask):
    """The final hidden state at every position, [B, T, H]: the layers over
    every position under the mask, and the final norm, which the pooling
    applies to one position a row."""
    b, t = ids.shape
    x, residual = tower._layers(ids.reshape(-1), mask, _every_position(b, t))
    return tower.norm(x, residual)[0].view(b, t, -1)


def test_appending_tokens_leaves_earlier_positions_unchanged():
    """Causality: every position of a prefix has the hidden state it has in
    the longer row, its mask all ones (so no key mask hides the tail)."""
    model, _ = _model(_cfg())
    long = _rows(3, [24])[0]
    tower = model.tower
    full = _hidden_states(tower, *_batch([long]))[0]
    for n in (2, 7, 16):
        part = _hidden_states(tower, *_batch([long[:n]]))[0]
        assert torch.equal(part, full[:n]), n
    # and the tail does change: the later positions see the earlier ones
    assert not torch.equal(_hidden_states(tower, *_batch([long[1:]]))[0][-1], full[-1])


def test_sliding_window_binds_at_4():
    """At window 4, query i sees keys i-3..i: the program equals the
    reference at that window and differs from the unwindowed tower."""
    cfg4 = _cfg(sliding_window=4)
    model4, w = _model(cfg4)
    rows = _rows(4, (3, 4, 5, 11, 20))
    got = model4.encode_query(*_batch(rows))
    assert _gap(got, ref.embed_rows(rows, w, cfg4, "cpu")) <= EMBED_GAP_BF16
    free, _ = _model(_cfg(sliding_window=None))
    unwindowed = free.encode_query(*_batch(rows))
    # rows of at most 4 tokens are untouched by the window; longer ones move
    assert torch.equal(got[:2], unwindowed[:2])
    assert all(not torch.equal(got[i], unwindowed[i]) for i in (2, 3, 4))
    bias = mistral.mask_bias(torch.ones(1, 8, dtype=torch.int32), 4)[0]
    seen = (bias == 0).int()
    assert seen.tolist() == [[1 if 0 <= i - j < 4 else 0 for j in range(8)] for i in range(8)]


def test_grouped_query_heads_read_kv_head_j_over_group():
    """Query head j reads kv head j // (heads / kv heads), HF's repeat_kv,
    without k and v repeated: one layer's attention against the plain
    per-head product, and against the wrong map j % kv heads."""
    cfg = _cfg(torch_dtype="float32")
    model, _ = _model(cfg)
    layer, c = model.tower.layers[0], model.tower.cfg
    g = torch.Generator().manual_seed(5)
    b, t = 2, 6
    x = torch.randn(b, t, c.hidden_size, generator=g)
    cos, sin = rope.rope_tables(t, c.head_dim, c.rope_theta, "cpu")
    bias = mistral.mask_bias(torch.ones(b, t, dtype=torch.int32), None)
    got = layer.attention(x.view(b * t, -1), cos, sin, bias, _every_position(b, t)).view(b, t, -1)

    def plain(head_map):
        nq, nkv, hd = c.num_heads, c.num_kv_heads, c.head_dim
        q, k, v = (x @ layer.qkv.kernel).split([nq * hd, nkv * hd, nkv * hd], -1)
        q = rope.apply_rope(q.view(b, t, nq, hd), cos, sin)
        k = rope.apply_rope(k.view(b, t, nkv, hd), cos, sin)
        v = v.view(b, t, nkv, hd)
        outs = []
        for j in range(nq):
            kv = head_map(j)
            s = q[:, :, j] @ k[:, :, kv].transpose(1, 2) / hd ** 0.5 + bias
            outs.append(torch.softmax(s, -1) @ v[:, :, kv])
        return torch.cat(outs, -1) @ layer.o.kernel

    group = c.num_heads // c.num_kv_heads
    torch.testing.assert_close(got, plain(lambda j: j // group), atol=1e-5, rtol=1e-5)
    assert (got - plain(lambda j: j % c.num_kv_heads)).abs().max() > 1e-3


def test_rope_is_hf_rotate_half_at_positions_0_to_t():
    c = mistral.MistralConfig.tiny()
    cos, sin = rope.rope_tables(9, c.head_dim, c.rope_theta, "cpu")
    hd = c.head_dim
    inv = 1.0 / (c.rope_theta ** (torch.arange(0, hd, 2).float() / hd))
    angle = torch.arange(9).float()[:, None] * inv[None]
    torch.testing.assert_close(cos, torch.cat([angle.cos()] * 2, -1), atol=0, rtol=0)
    torch.testing.assert_close(sin, torch.cat([angle.sin()] * 2, -1), atol=0, rtol=0)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(1, 9, 1, hd, generator=g)
    y = rope.apply_rope(x, cos, sin)[0, :, 0]
    # rotate-half: element i and i + hd/2 turn as one complex number by its angle
    z = torch.complex(x[0, :, 0, :hd // 2], x[0, :, 0, hd // 2:]) * torch.polar(
        torch.ones_like(angle), angle)
    torch.testing.assert_close(y, torch.cat([z.real, z.imag], -1), atol=1e-5, rtol=1e-5)
    # a score depends on the positions' difference alone
    q, k = torch.randn(hd, generator=g), torch.randn(hd, generator=g)
    rq = rope.apply_rope(q.expand(1, 9, 1, hd), cos, sin)[0, :, 0]
    rk = rope.apply_rope(k.expand(1, 9, 1, hd), cos, sin)[0, :, 0]
    torch.testing.assert_close(rq[5] @ rk[2], rq[8] @ rk[5], atol=1e-5, rtol=1e-5)
    assert not torch.allclose(rq[5] @ rk[2], rq[5] @ rk[4], atol=1e-3)


class _Shard:
    """What encode_corpus reads of a dataset: rows of ids and the longest."""

    def __init__(self, rows):
        self.rows, self.max_len = rows, max(map(len, rows))

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def test_retriever_on_encode_corpus_and_search_gives_the_reference_topk():
    """The retrieve path: passages through encode_corpus into a DenseIndex,
    queries through encode_query into DenseIndex.search; the top-k rows are
    the reference's (f32 tower, f32 index: no rounding between them)."""
    cfg = _cfg(torch_dtype="float32")
    model, w = _model(cfg)
    passages = _rows(7, [3 + (5 * i) % 29 for i in range(40)])
    queries = _rows(8, (6, 11, 4, 9))
    emb = encode_corpus(model, _Shard(passages), batch_size=16, buckets=(16, 32))
    index = DenseIndex.from_embeddings(emb, device="cpu", dtype=torch.float32)
    q = model.encode_query(*_batch(queries))
    vals, idx = index.search(q, 5)
    want_c = torch.stack(ref.embed_rows(passages, w, cfg, "cpu", rnd=lambda x: x))
    want_q = torch.stack(ref.embed_rows(queries, w, cfg, "cpu", rnd=lambda x: x))
    ref_vals, ref_idx = torch.topk(want_q @ want_c.T, 5, dim=1)
    assert topk_disagreements(vals, idx, ref_vals.numpy(), ref_idx.numpy(), atol=1e-5) == 0


def test_counters_and_spans():
    """positions and tokens count what the tower was handed; under a
    profiler a forward opens proqa.tower with one attention and one mlp span
    a layer and one pool span inside it."""
    from torch.profiler import ProfilerActivity, profile

    model, _ = _model(_cfg())
    ids, mask = _batch(_rows(9, (4, 10, 7)))
    mistral.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.encode_query(ids, mask)
    assert (mistral.calls, mistral.positions, mistral.tokens) == (1, 30, 21)
    names = [e.name for e in prof.events() if e.name.startswith("proqa.")]
    layers = TINY["num_hidden_layers"]
    assert sorted(set(names)) == ["proqa.tower", "proqa.tower.attention", "proqa.tower.mlp",
                                  "proqa.tower.pool"]
    assert [names.count(n) for n in ("proqa.tower", "proqa.tower.attention", "proqa.tower.mlp",
                                     "proqa.tower.pool")] == [1, layers, layers, 1]
    mistral.reset_counters()
    assert (mistral.calls, mistral.positions, mistral.tokens) == (0, 0, 0)


@pytest.mark.parametrize("mask,why", [
    ([[1, 1, 0], [1, 0, 0], [0, 0, 0]], "a row of no token"),
    ([[0, 1, 1], [1, 1, 1]], "left padding"),
    ([[1, 0, 1], [1, 1, 1]], "a hole"),
    ([[0, 0, 0], [1, 1, 1]], "a first row of no token"),
])
def test_mask_that_is_not_right_padding_is_refused(mask, why):
    """The packing reads a row's tokens as a prefix of at least one: a mask
    that is not (a row of none, left padding, a hole) raises before any
    work, and counts nothing."""
    model, _ = _model(_cfg())
    mask = torch.tensor(mask, dtype=torch.int32)
    ids = torch.randint(3, TINY["vocab_size"], mask.shape,
                        generator=torch.Generator().manual_seed(1))
    mistral.reset_counters()
    with pytest.raises(ValueError, match="right-padded rows of at least one token"):
        model.encode_query(ids * mask, mask)
    assert mistral.calls == 0


def test_batch_of_no_rows_gives_no_embeddings():
    model, _ = _model(_cfg())
    got = model.encode_query(torch.zeros(0, 5, dtype=torch.long),
                             torch.zeros(0, 5, dtype=torch.int32))
    assert got.shape == (0, TINY["hidden_size"]) and got.dtype == torch.float32


def _dense_embeddings(tower, ids, mask):
    """The tower over every padded position, pooled at each row's last real
    token."""
    hidden = _hidden_states(tower, ids, mask)
    last = mask.sum(dim=1).long() - 1
    return torch.nn.functional.normalize(hidden[torch.arange(len(ids)), last].float(), dim=-1)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("lengths,window,head_dim", [
    ((1, 5, 9, 2, 17), 4096, 16),  # a row of one token among longer ones
    ((3, 11, 20, 1, 6), 4, 16),  # rows longer than the window
    ((3, 11, 20, 1, 6), 4, 6),  # heads of 12 bytes in bf16, gathered as 4-byte words
    ((7, 7, 7), 4, 16),  # no padding: every position is packed
])
def test_packed_tower_equals_padded_dense_path(dtype, lengths, window, head_dim):
    """A batch through the tower, packed, gives row for row the embeddings
    of a run over every padded position: the same operands and rounding
    points, the window and mask kept."""
    model, _ = _model(_cfg(torch_dtype=dtype, sliding_window=window, head_dim=head_dim))
    rows = [r[:n] for r, n in zip(_rows(16, [max(n, 2) for n in lengths]), lengths)]
    ids, mask = _batch(rows)
    got = model.encode_query(ids, mask)
    assert torch.equal(got, _dense_embeddings(model.tower, ids, mask))


# --- the decoder's F1 and F2 forms ---

def test_swiglu_plain_version():
    g = torch.Generator().manual_seed(10)
    y = torch.randn(5, 3, 2 * 24, generator=g).bfloat16()
    gate, up = y.float()[..., :24], y.float()[..., 24:]
    want = (gate / (1 + torch.exp(-gate)) * up).bfloat16()
    got = fused_bert.swiglu(y)
    assert got.shape == (5, 3, 24) and got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max() <= 2 ** -7 * want.float().abs().max()
    torch.testing.assert_close(fused_bert.swiglu_reference(y), got, atol=0, rtol=0)


@pytest.mark.parametrize("residual", [True, False])
def test_rms_norm_plain_version(residual):
    g = torch.Generator().manual_seed(11)
    x = torch.randn(7, 40, generator=g).bfloat16()
    r = torch.randn(7, 40, generator=g).bfloat16() if residual else None
    scale = (1 + 0.1 * torch.randn(40, generator=g)).bfloat16()
    out, s = fused_bert.add_rms_norm(x, r, scale, 1e-5)
    want_s = x if r is None else (x.float() + r.float()).bfloat16()
    assert torch.equal(s, want_s)
    s32 = want_s.float()
    want = (s32 / torch.sqrt((s32 * s32).mean(-1, keepdim=True) + 1e-5) * scale.float())
    assert (out.float() - want).abs().max() <= 2 ** -7 * want.abs().max()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decoder_form_choosers_cover_every_width(dtype):
    """The RMSNorm form: a block a row up to 8,192, wider rows refused; the
    SwiGLU form: one layout at every width; the vector bodies where the
    width is whole 16-byte vectors (groups of 8 for SwiGLU) and the pointers
    aligned."""
    dt = getattr(torch, dtype)
    vec = 16 // dt.itemsize
    for h in (1, 7, 8, 64, 1024, 4096, 8191, 8192, 8193, 14336, 32768):
        for aligned in (True, False):
            if h <= 8192:
                form = fused_bert.layer_norm_form(h, dt, aligned, rms=True)
                assert form == "rms_row" + ("" if aligned and h % vec == 0 else "_scalar")
                assert form in fused_bert.LN_FORMS
            else:
                with pytest.raises(ValueError, match="past the RMSNorm form"):
                    fused_bert.layer_norm_form(h, dt, aligned, rms=True)
            form = fused_bert.dense_form(h, aligned, swiglu=True)
            assert form == "swiglu" + ("" if aligned and h % 8 == 0 else "_scalar")
            assert form in fused_bert.DENSE_FORMS


@pytest.fixture
def recorded_launches(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "launch", lambda entry, device, *args: calls.append((entry, args)))
    monkeypatch.setattr(fused_bert, "form_launches", {})
    return calls


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("h", [64, 4096, 8192])
def test_decoder_form_wrappers_pass_their_form(recorded_launches, h, aligned):
    """The kernels' wrappers pass the chooser's form for the pointers they
    launch on, count the launch under it (in F1's and F2's launches), and
    give the RMSNorm form a sum to write only with a residual."""
    x = torch.zeros(3, h, dtype=torch.bfloat16)
    if not aligned:
        x = torch.empty(x.numel() + 2, dtype=x.dtype)[2:].view_as(x).zero_()
    scale = torch.ones(h, dtype=torch.bfloat16)
    out, s = fused_bert._add_rms_norm_kernel(x, x, scale, 1e-5)
    out0, s0 = fused_bert._add_rms_norm_kernel(x, None, scale, 1e-5)
    y = torch.zeros(3, 2 * h, dtype=torch.bfloat16)
    y = y if aligned else torch.empty(y.numel() + 2, dtype=y.dtype)[2:].view_as(y)
    act = fused_bert._swiglu_kernel(y)
    (e1, a1), (e2, a2), (e3, a3) = recorded_launches
    assert (e1, e2, e3) == ("proqa_add_rms_norm", "proqa_add_rms_norm", "proqa_dense_swiglu")
    vector = aligned and h % 8 == 0
    ln = fused_bert.layer_norm_form(h, torch.bfloat16, vector, rms=True)
    assert fused_bert.LN_FORMS[a1[-1]] == fused_bert.LN_FORMS[a2[-1]] == ln
    assert a1[4] == s.data_ptr() and a2[4] is None and s0 is x
    assert fused_bert.DENSE_FORMS[a3[-1]] == fused_bert.dense_form(h, vector, swiglu=True)
    assert act.shape == (3, h)
    layout = ln.removesuffix("_scalar")
    assert fused_bert.form_launches == {f"F2 {layout}": 2, "F1 swiglu": 1}
    assert fused_bert.launches("F2") == 2 and fused_bert.launches("F1") == 1
    with pytest.raises(ValueError, match="scale"):
        fused_bert._add_rms_norm_kernel(x, None, scale.float(), 1e-5)
    with pytest.raises(ValueError, match="gate and up"):
        fused_bert._swiglu_kernel(torch.zeros(3, 7, dtype=torch.bfloat16))


def test_rope_qkv_layout():
    """The fused copy's plain version: q's kv head j holds query head j g +
    i at row i T + t, rotated; k rotated and v copied, head-major."""
    g = torch.Generator().manual_seed(15)
    b, t, nq, nkv, hd = 2, 5, 4, 2, 16
    qkv = torch.randn(b, t, (nq + 2 * nkv) * hd, generator=g).bfloat16()
    cos, sin = rope.rope_tables(t, hd, 10000.0, "cpu")
    q, k, v = rope.rope_qkv_reference(qkv, cos, sin, nq, nkv)
    assert q.shape == (b, nkv, 2 * t, hd) and k.shape == v.shape == (b, nkv, t, hd)
    heads = qkv.view(b, t, nq + 2 * nkv, hd)
    rq = rope.apply_rope(heads[:, :, :nq], cos, sin)
    rk = rope.apply_rope(heads[:, :, nq:nq + nkv], cos, sin)
    for j in range(nq):
        kv, i = divmod(j, nq // nkv)
        assert torch.equal(q[:, kv, i * t:(i + 1) * t], rq[:, :, j])
    for j in range(nkv):
        assert torch.equal(k[:, j], rk[:, :, j])
        assert torch.equal(v[:, j], heads[:, :, nq + nkv + j])


def _packed_qkv(seed, lengths, nq, nkv, hd, dtype=torch.bfloat16):
    """A packed product of rows of these lengths, [N, (nq + 2 nkv) hd], and
    its row offsets."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.tensor(lengths)
    cu = torch.zeros(len(lengths) + 1, dtype=torch.int64)
    cu[1:] = lengths.cumsum(0)
    return torch.randn(int(cu[-1]), (nq + 2 * nkv) * hd, generator=g).to(dtype), cu


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("lengths", [(5, 1, 3), (4, 4), (1,), (2, 7, 7, 3)])
def test_rope_qkv_packed_plain_version(dtype, lengths):
    """The packed form's plain version: at every real position
    rope_qkv_reference's output on the padded copy of the rows, zeros (+0)
    at every pad position of q, k and v."""
    nq, nkv, hd = 4, 2, 16
    qkv, cu = _packed_qkv(17, lengths, nq, nkv, hd, getattr(torch, dtype))
    t = max(lengths)
    cos, sin = rope.rope_tables(t, hd, 10000.0, "cpu")
    q, k, v = rope.rope_qkv_packed(qkv, cu, t, cos, sin, nq, nkv)
    b, g = len(lengths), nq // nkv
    padded = qkv.new_full((b, t, qkv.shape[1]), float("nan"))  # pads never read
    for r, n in enumerate(lengths):
        padded[r, :n] = qkv[cu[r]:cu[r + 1]]
    wq, wk, wv = rope.rope_qkv_reference(padded, cos, sin, nq, nkv)
    assert q.shape == wq.shape and k.shape == wk.shape and v.shape == wv.shape
    for r, n in enumerate(lengths):
        for got, want in ((q.view(b, nkv, g, t, hd), wq.view(b, nkv, g, t, hd)), (k, wk),
                          (v, wv)):
            assert torch.equal(got[r, ..., :n, :], want[r, ..., :n, :])
            pad = got[r, ..., n:, :]
            assert torch.equal(pad, torch.zeros_like(pad))
            assert not torch.signbit(pad).any()


@pytest.mark.parametrize("hd,aligned,form", [(128, True, "vec"), (16, True, "vec"),
                                             (24, True, "scalar"), (128, False, "scalar")])
def test_rope_qkv_packed_wrapper_passes_its_form(recorded_launches, hd, aligned, form):
    """The packed form's wrapper passes rope_form's answer, the row offsets'
    pointer and the padded shapes, and counts the launch in rope.launches."""
    nq, nkv, t = 4, 2, 7
    qkv, cu = _packed_qkv(18, (7, 2, 5), nq, nkv, hd)
    qkv.zero_()
    if not aligned:
        qkv = torch.empty(qkv.numel() + 2, dtype=qkv.dtype)[2:].view_as(qkv).zero_()
    cos = sin = torch.zeros(t, hd)
    before = rope.launches
    q, k, v = rope._rope_qkv_packed_kernel(qkv, cu, t, cos, sin, nq, nkv)
    ((entry, args),) = recorded_launches
    assert entry == "proqa_rope_qkv_packed" and args[:2] == (qkv.data_ptr(), cu.data_ptr())
    assert args[7:12] == (3, t, nq, nkv, hd)
    assert rope.ROPE_FORMS[args[-1]] == form == rope.rope_form(hd, aligned)
    assert q.shape == (3, nkv, 2 * t, hd) and k.shape == v.shape == (3, nkv, t, hd)
    assert rope.launches == before + 1
    with pytest.raises(ValueError, match="tables"):
        rope._rope_qkv_packed_kernel(qkv, cu, t, cos[:, :2], sin, nq, nkv)
    with pytest.raises(ValueError, match="cu_seqlens"):
        rope._rope_qkv_packed_kernel(qkv, cu.int(), t, cos, sin, nq, nkv)


# --- HF Mistral checkpoints ---

def _hf_state(cfg: mistral.MistralConfig, seed: int, prefix: str = "") -> dict:
    """An HF MistralModel state dict of cfg's shapes, f32 from a seed."""
    g = torch.Generator().manual_seed(seed)
    h, hd, inter = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size

    def t(*shape, scale=0.05):
        return torch.randn(*shape, generator=g) * scale

    state = {f"{prefix}embed_tokens.weight": t(cfg.vocab_size, h),
             f"{prefix}norm.weight": 1 + t(h, scale=0.1)}
    for i in range(cfg.num_layers):
        p = f"{prefix}layers.{i}."
        state.update({
            p + "self_attn.q_proj.weight": t(cfg.num_heads * hd, h),
            p + "self_attn.k_proj.weight": t(cfg.num_kv_heads * hd, h),
            p + "self_attn.v_proj.weight": t(cfg.num_kv_heads * hd, h),
            p + "self_attn.o_proj.weight": t(h, cfg.num_heads * hd),
            p + "mlp.gate_proj.weight": t(inter, h), p + "mlp.up_proj.weight": t(inter, h),
            p + "mlp.down_proj.weight": t(h, inter),
            p + "input_layernorm.weight": 1 + t(h, scale=0.1),
            p + "post_attention_layernorm.weight": 1 + t(h, scale=0.1)})
    return state


@pytest.mark.parametrize("prefix", ["", "model.", "module.model."])
def test_hf_mistral_names_map_onto_the_tower(prefix):
    """MistralModel's keys (E5-Mistral's checkpoint), MistralForCausalLM's
    under model. (its lm_head dropped) and a DDP prefix: every port key
    filled, Linear weights transposed, q/k/v and gate/up side by side."""
    cfg = mistral.MistralConfig.tiny(dtype=torch.float32)
    hf = _hf_state(cfg, 12, prefix.removeprefix("module."))
    state = {("module." if prefix.startswith("module.") else "") + k: v for k, v in hf.items()}
    if "model." in prefix:
        state[prefix.replace("model.", "") + "lm_head.weight"] = torch.zeros(cfg.vocab_size, 64)
    got = hf_convert.mistral_params_from_state_dict(state, cfg)
    model = mistral.MistralRetriever(cfg)
    assert set(got) == set(model.state_dict())
    model.load_state_dict(got)
    base = prefix.removeprefix("module.")
    layer = model.tower.layers[1]
    q, k, v = (hf[f"{base}layers.1.self_attn.{n}_proj.weight"] for n in "qkv")
    assert torch.equal(layer.qkv.kernel, torch.cat([q.t(), k.t(), v.t()], 1))
    assert torch.equal(layer.down.kernel, hf[f"{base}layers.1.mlp.down_proj.weight"].t())
    assert torch.equal(layer.gate_up.kernel[:, cfg.intermediate_size:],
                       hf[f"{base}layers.1.mlp.up_proj.weight"].t())
    assert torch.equal(model.tower.norm.scale, hf[f"{base}norm.weight"])
    bf = hf_convert.mistral_params_from_state_dict(state, mistral.MistralConfig.tiny())
    assert all(t.dtype == torch.bfloat16 for t in bf.values())


@pytest.mark.parametrize("window", [4096, 4])
def test_f32_tower_matches_transformers_mistral(window):
    """The converted tower in f32 against HF's MistralModel (eager
    attention, f32) on the same weights: last real token's final state,
    L2-normalised, within HF_F32_TOL, the window binding or not."""
    transformers = pytest.importorskip("transformers")
    cfg = mistral.MistralConfig.tiny(dtype=torch.float32, sliding_window=window)
    hf_cfg = transformers.MistralConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        sliding_window=window, attn_implementation="eager")
    hf_model = transformers.MistralModel(hf_cfg).eval()
    hf_model.load_state_dict(_hf_state(cfg, 13))
    model = mistral.MistralRetriever(cfg)
    model.load_state_dict(hf_convert.mistral_params_from_state_dict(hf_model.state_dict(), cfg))
    rows = _rows(14, (3, 9, 17, 6))
    ids, mask = _batch(rows)
    got = model.encode_query(ids, mask)
    with torch.no_grad():
        hidden = hf_model(input_ids=ids, attention_mask=mask).last_hidden_state
    last = mask.sum(1) - 1
    want = torch.nn.functional.normalize(hidden[torch.arange(len(rows)), last], dim=-1)
    assert (got - want).abs().max() <= HF_F32_TOL
    assert np.isfinite(got.numpy()).all()


def test_weights_drawn_on_a_device_match_reset_parameters():
    """on_device draws init_parameters' weights where the tower lives, from
    the same generator stream as reset_parameters: on the CPU the same bits,
    in the configuration's dtype, scales about 1 and kernels about 0.02."""
    cfg = mistral.MistralConfig.tiny()
    drawn = mistral.MistralRetriever.on_device(cfg, torch.device("cpu"), 5)
    reset = mistral.MistralRetriever(cfg).reset_parameters(5)
    want = reset.state_dict()
    for name, p in drawn.state_dict().items():
        assert p.dtype == cfg.dtype and torch.equal(p, want[name]), name
    scale = drawn.tower.norm.scale.float()
    assert abs(scale.mean().item() - 1.0) < 0.05 and 0.05 < scale.std().item() < 0.2
    kernel = drawn.tower.layers[0].gate_up.kernel.float()
    assert 0.015 < kernel.std().item() < 0.025
    assert not drawn.training
