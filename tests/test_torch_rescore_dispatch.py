"""Which rescore a search takes by default (ops/mips.py:rescore_impl_for):
kernel K6 ("stream") for CUDA tensors over a bf16 or f32 corpus of the
queries' dtype, without int8 scales, at every width the kernel takes (a
multiple of 16, rows of at most 16 KB); the `take` gather everywhere else. The rule reads the device and dtypes only, so it is
checked here without a card; on CPU and meta tensors the default rescore
runs the take path and never reaches the kernel's wrapper."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from proqa_tpu_torch.ops import mips, mips_kernel, rescore  # noqa: E402

CUDA = torch.device("cuda")
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("device,qdtype,cdtype,dim,scaled,want", [
    (CUDA, BF16, BF16, 128, False, "stream"),
    (CUDA, F32, F32, 128, False, "stream"),
    ("cuda:0", BF16, BF16, 128, False, "stream"),
    (CUDA, BF16, torch.int8, 128, True, "take"),     # the int8 index (K5's search)
    (CUDA, F32, torch.int8, 128, True, "take"),
    (CUDA, BF16, torch.int8, 128, False, "take"),
    (CUDA, BF16, BF16, 128, True, "take"),           # scales: K6 takes none
    (CUDA, BF16, BF16, 64, False, "stream"),         # every multiple of 16 (was 128 alone)
    (CUDA, BF16, BF16, 768, False, "stream"),        # DPR's width
    (CUDA, F32, F32, 768, False, "stream"),
    (CUDA, BF16, BF16, 72, False, "take"),           # not a multiple of 16: no kernel
    (CUDA, F32, F32, 8192, False, "take"),           # a 32 KB row: wider than a stage takes
    (CUDA, BF16, BF16, 8192, False, "stream"),       # the same width in bf16: 16 KB rows
    (CUDA, F32, BF16, 128, False, "take"),           # the kernel wants one dtype
    (CUDA, torch.float16, torch.float16, 128, False, "take"),
    (torch.device("cpu"), BF16, BF16, 128, False, "take"),
    (torch.device("cpu"), F32, F32, 128, False, "take"),
    (torch.device("meta"), BF16, BF16, 128, False, "take"),
    (torch.device("meta"), F32, F32, 128, False, "take"),
])
def test_rescore_impl_for(device, qdtype, cdtype, dim, scaled, want):
    assert mips.rescore_impl_for(device, qdtype, cdtype, dim, scaled) == want


def _inputs(device, dtype, seed=0, q=6, nb=40, block=16, kb=5):
    rng = np.random.default_rng(seed)
    corpus = torch.from_numpy(rng.standard_normal((nb, block, 128)).astype(np.float32))
    queries = torch.from_numpy(rng.standard_normal((q, 128)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, nb, (q, kb)))
    return queries.to(device, dtype), corpus.to(device, dtype), ids.to(device)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_default_rescore_off_the_card_is_the_take_path(monkeypatch, device, dtype):
    def no_kernel(*a, **kw):
        raise AssertionError("the default rescore reached K6 off the card")

    monkeypatch.setattr(mips, "gather_rescore", no_kernel)
    queries, corpus, ids = _inputs(device, dtype)
    got = mips.rescore_block_candidates(queries, ids, corpus, k=7, block=16, n_valid=600)
    want = mips.rescore_block_candidates(queries, ids, corpus, k=7, block=16, n_valid=600,
                                         impl="take")
    assert got[0].shape == want[0].shape == (6, 7)
    if device == "cpu":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("scales", ["block_scales", "row_scales"])
def test_default_rescore_of_int8_codes_is_the_take_path(monkeypatch, scales):
    monkeypatch.setattr(mips, "gather_rescore", lambda *a, **kw: pytest.fail("reached K6"))
    queries, _, ids = _inputs("cpu", BF16)
    codes = torch.from_numpy(np.random.default_rng(1).integers(-127, 128, (40, 16, 128),
                                                               dtype=np.int8))
    sc = {"block_scales": torch.rand(40) + 0.5, "row_scales": torch.rand(640) + 0.5}[scales]
    vals, idx = mips.rescore_block_candidates(queries, ids, codes, k=7, block=16, n_valid=640,
                                              **{scales: sc})
    assert vals.shape == idx.shape == (6, 7) and torch.isfinite(vals).all()
    with pytest.raises(ValueError, match="int8"):
        mips.rescore_block_candidates(queries, ids, codes, k=7, block=16, n_valid=640,
                                      impl="stream", **{scales: sc})


def test_explicit_impl_wins(monkeypatch):
    """impl="stream" reaches the K6 wrapper whatever the rule says; on the
    CPU the wrapper then runs the plain version (no launch is counted)."""
    calls = []

    def spy(*a, **kw):
        calls.append(a[0].device.type)
        return rescore.gather_rescore(*a, **kw)

    monkeypatch.setattr(mips, "gather_rescore", spy)
    queries, corpus, ids = _inputs("cpu", F32)
    before = rescore.launches
    stream = mips.rescore_block_candidates(queries, ids, corpus, k=7, block=16, n_valid=640,
                                           impl="stream")
    take = mips.rescore_block_candidates(queries, ids, corpus, k=7, block=16, n_valid=640)
    assert calls == ["cpu"] and rescore.launches == before
    np.testing.assert_array_equal(stream[1].numpy(), take[1].numpy())
    np.testing.assert_allclose(stream[0].numpy(), take[0].numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_pipelines_default_to_the_rule(monkeypatch, dtype):
    """mips_topk_v2 and mips_topk_v1 leave the rescore to the rule: on the
    CPU their default results are the take path's, and K6 is never called."""
    monkeypatch.setattr(mips, "gather_rescore", lambda *a, **kw: pytest.fail("reached K6"))
    rng = np.random.default_rng(3)
    queries = torch.from_numpy(rng.standard_normal((20, 128)).astype(np.float32)).to(dtype)
    corpus = torch.from_numpy(rng.standard_normal((4096, 128)).astype(np.float32)).to(dtype)
    v2 = mips_kernel.mips_topk_v2(queries, corpus, 10, block=16, n_valid=4000)
    v2_take = mips_kernel.mips_topk_v2(queries, corpus, 10, block=16, n_valid=4000,
                                       rescore_impl="take")
    assert all(torch.equal(a, b) for a, b in zip(v2, v2_take))
    v1 = mips_kernel.mips_topk_v1(queries, corpus, 10, block=16, tile_n=128, n_valid=4000)
    assert torch.equal(v1[1], v2[1])
