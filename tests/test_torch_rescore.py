"""Port parity for the gathered candidate scoring, kernels K6 (gather_rescore,
the `impl="stream"` rescore) and K9 (gather_score), against the JAX package's
Pallas kernels in interpret mode on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from proqa_tpu.ops import mips as jax_mips  # noqa: E402
from proqa_tpu.ops import pallas_mips  # noqa: E402
from proqa_tpu.ops.pallas_gather_score import gather_score as jax_gather_score  # noqa: E402
from proqa_tpu.ops.pallas_rescore import gather_rescore as jax_gather_rescore  # noqa: E402
from proqa_tpu_torch.ops import mips, mips_kernel, rescore  # noqa: E402
from proqa_tpu_torch.testing import topk_disagreements  # noqa: E402

# f32 sums of 128 products of standard-normal values (magnitude ~11) in
# another order: ~1e-5 apart
ATOL = 1e-4


def _blocks(nb, block, q, kb, seed, lo=0):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((nb, block, 128)).astype(np.float32)
    queries = rng.standard_normal((q, 128)).astype(np.float32)
    ids = rng.integers(lo, nb, (q, kb)).astype(np.int32)
    return corpus, queries, ids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nb,block,q,kb", [(128, 16, 16, 16), (64, 16, 40, 8)])
def test_gather_rescore_matches_jax(nb, block, q, kb, dtype):
    """K6 at the shapes of tests/test_pallas_mips.py:193-219 (the second one
    spans the JAX package's query chunks)."""
    corpus, queries, ids = _blocks(nb, block, q, kb, seed=20 + q)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_gather_rescore(jnp.asarray(queries, jdt), jnp.asarray(corpus, jdt),
                                         jnp.asarray(ids), block=block, interpret=True))
    tq, tc = torch.from_numpy(queries).to(tdt), torch.from_numpy(corpus).to(tdt)
    got = rescore.gather_rescore(tq, tc, torch.from_numpy(ids), block=block)
    assert got.shape == (q, kb * block) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-5)
    np.testing.assert_array_equal(rescore.gather_score(tq, tc, torch.from_numpy(ids),
                                                       block=block).numpy(), got.numpy())


def test_gather_score_matches_jax():
    """K9 at the shapes of tests/test_gather_score.py (block 64)."""
    corpus, queries, ids = _blocks(32, 64, 16, 4, seed=0)
    want = np.asarray(jax_gather_score(jnp.asarray(queries), jnp.asarray(corpus),
                                       jnp.asarray(ids), block=64, qb=8, jb=2, interpret=True))
    got = rescore.gather_score(torch.from_numpy(queries), torch.from_numpy(corpus),
                               torch.from_numpy(ids).long(), block=64)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-5)


def test_rescore_impl_stream_matches_jax():
    """rescore_block_candidates(impl="stream") returns the JAX stream and
    take results, values and indices, with the padding rows masked
    (tests/test_pallas_mips.py:222-242)."""
    rng = np.random.default_rng(22)
    n_valid, q, kb, block, nb = 2000, 16, 16, 16, 128  # blocks 125..127 straddle or pass n_valid
    corpus = np.zeros((nb * block, 128), np.float32)
    corpus[:n_valid] = -np.abs(rng.standard_normal((n_valid, 128)))
    queries = np.abs(rng.standard_normal((q, 128))).astype(np.float32)
    ids = rng.integers(120, nb, (q, kb)).astype(np.int32)
    jc = jnp.asarray(corpus.reshape(nb, block, 128))
    jv, ji = map(np.asarray, jax_mips.rescore_block_candidates(
        jnp.asarray(queries), jnp.asarray(ids), jc, k=8, block=block, n_valid=n_valid,
        impl="stream", interpret=True))
    tc = torch.from_numpy(corpus).view(nb, block, 128)
    results = {impl: mips.rescore_block_candidates(
        torch.from_numpy(queries), torch.from_numpy(ids).long(), tc, k=8, block=block,
        n_valid=n_valid, impl=impl) for impl in ("stream", "take")}
    for sv, si in results.values():
        assert si.max().item() < n_valid
        np.testing.assert_array_equal(si.numpy(), ji)
        np.testing.assert_allclose(sv.numpy(), jv, atol=ATOL, rtol=1e-5)
    with pytest.raises(ValueError, match="int8"):
        mips.rescore_block_candidates(torch.from_numpy(queries), torch.from_numpy(ids).long(), tc,
                                      k=8, block=block, n_valid=n_valid, impl="stream",
                                      block_scales=torch.ones(nb))


def test_mips_topk_v2_stream_matches_jax():
    """The K1 pipeline with the streamed rescore: the same ids as the take
    rescore and as the JAX pipeline with rescore_impl="stream"."""
    rng = np.random.default_rng(8)
    queries = (rng.standard_normal((64, 128)) / np.sqrt(128)).astype(np.float32)
    corpus = (rng.standard_normal((8192, 128)) / np.sqrt(128)).astype(np.float32)
    pv, pi = map(np.asarray, pallas_mips.mips_topk_pallas_v2(
        jnp.asarray(queries), jnp.asarray(corpus), 24, block=16, group=128, tile_q=64,
        n_valid=8000, rescore_impl="stream", interpret=True))
    pv, pi = map(np.asarray, jax_mips.sanitize_padding(pv, pi))
    tq, tc = torch.from_numpy(queries), torch.from_numpy(corpus)
    sv, si = mips_kernel.mips_topk_v2(tq, tc, 24, block=16, n_valid=8000, rescore_impl="stream")
    tv, ti = mips_kernel.mips_topk_v2(tq, tc, 24, block=16, n_valid=8000)
    assert si.max().item() < 8000
    assert topk_disagreements(sv.numpy(), si.numpy(), tv.numpy(), ti.numpy(), atol=ATOL) == 0
    assert topk_disagreements(sv.numpy(), si.numpy(), pv, pi, atol=ATOL) == 0
