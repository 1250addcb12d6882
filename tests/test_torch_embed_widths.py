"""The exact search at embedding widths other than 128: the block maxima
(K1, K5, K7, K8), the gathered rescore (K6, K9), mips_topk and DenseIndex
against the JAX package on the same numpy inputs (Pallas in interpret
mode), and the CLIs over a retriever checkpoint whose projections are 256
wide (the JAX package's init_retriever_params(embed_dim=256)). The port's
kernels run their plain versions here; tests/test_torch_cuda.py holds the
CUDA kernels to those at the same widths."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from proqa_tpu.cli.main import main as jax_main  # noqa: E402
from proqa_tpu.index.dense import DenseIndex as JaxDenseIndex  # noqa: E402
from proqa_tpu.index.idmap import IdMap as JaxIdMap  # noqa: E402
from proqa_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from proqa_tpu.models.reader import QAConfig as JaxQAConfig, init_qa_params  # noqa: E402
from proqa_tpu.models.retriever import init_retriever_params  # noqa: E402
from proqa_tpu.ops import mips as jax_mips, pallas_mips, quant as jax_quant  # noqa: E402
from proqa_tpu.ops.pallas_gather_score import gather_score as jax_gather_score  # noqa: E402
from proqa_tpu.ops.pallas_rescore import gather_rescore as jax_gather_rescore  # noqa: E402
from proqa_tpu.train.checkpoint import save_checkpoint  # noqa: E402
from proqa_tpu_torch.cli.main import main as torch_main  # noqa: E402
from proqa_tpu_torch.data.docdb import DocDB  # noqa: E402
from proqa_tpu_torch.index.dense import DenseIndex  # noqa: E402
from proqa_tpu_torch.index.idmap import IdMap  # noqa: E402
from proqa_tpu_torch.models.bert import BertConfig  # noqa: E402
from proqa_tpu_torch.models.convert import load_params, save_npz  # noqa: E402
from proqa_tpu_torch.models.retriever import Retriever, embed_dim_of  # noqa: E402
from proqa_tpu_torch.ops import mips, mips_kernel, rescore  # noqa: E402
from proqa_tpu_torch.testing import topk_disagreements  # noqa: E402

WIDTHS = (64, 96, 256, 768)
# f32 scores of unit-scale rows summed in another order: ~1e-6 apart
ATOL = 1e-4
# int8 codes (up to 127) against queries of unit entries: scores of ~100,
# f32 sums in another order ~1e-5 apart
INT8_ATOL = 1e-3


def _data(q, n, d, seed):
    rng = np.random.default_rng(seed)
    queries = rng.standard_normal((q, d)).astype(np.float32) / np.sqrt(d)
    corpus = rng.standard_normal((n, d)).astype(np.float32) / np.sqrt(d)
    return queries, corpus


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDTHS)
def test_block_maxima_grouped_matches_jax(d, dtype):
    """K1's plain version against the Pallas kernel at width d."""
    queries, corpus = _data(16, 512, d, seed=d)
    want = pallas_mips.block_maxima_grouped(
        jnp.asarray(queries, getattr(jnp, dtype)), jnp.asarray(corpus, getattr(jnp, dtype)),
        block=16, group=8, tile_q=16, interpret=True)
    got = mips_kernel.block_maxima_grouped(
        torch.from_numpy(queries).to(getattr(torch, dtype)),
        torch.from_numpy(corpus).to(getattr(torch, dtype)), block=16, group=8)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["scales", "scale_bounds"])
@pytest.mark.parametrize("d", WIDTHS)
def test_block_maxima_grouped_int8_matches_jax(d, kind):
    """K5 (per-block scales) and K7 (per-row scale bounds) at width d."""
    rng = np.random.default_rng(d + 1)
    n, block, group = 512, 8, 16
    emb = (rng.standard_normal((n, d)) * rng.uniform(0.25, 4.0, (n, 1))).astype(np.float32)
    queries = rng.standard_normal((16, d)).astype(np.float32)
    if kind == "scales":
        q8, sc = jax_quant.quantize_rows(emb, block=block)
        jkw, tkw = {"scales": jnp.asarray(sc)}, {"scales": torch.from_numpy(sc)}
    else:
        q8, rs = jax_quant.quantize_rows(emb, block=1)
        smax, smin = rs.reshape(-1, block).max(1), rs.reshape(-1, block).min(1)
        jkw = {"scale_bounds": (jnp.asarray(smax), jnp.asarray(smin))}
        tkw = {"scale_bounds": (torch.from_numpy(smax), torch.from_numpy(smin))}
    want = pallas_mips.block_maxima_grouped(
        jnp.asarray(queries, jnp.bfloat16), jnp.asarray(q8), block=block, group=group,
        tile_q=16, interpret=True, **jkw)
    got = mips_kernel.block_maxima_grouped(torch.from_numpy(queries).bfloat16(),
                                           torch.from_numpy(np.asarray(q8)), block=block,
                                           group=group, **tkw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=INT8_ATOL, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDTHS)
def test_block_maxima_block_major_matches_jax(d, dtype):
    """K8's plain version against the Pallas kernel at width d."""
    queries, corpus = _data(16, 1024, d, seed=d + 2)
    want = pallas_mips.block_maxima(
        jnp.asarray(queries, getattr(jnp, dtype)), jnp.asarray(corpus, getattr(jnp, dtype)),
        block=32, tile_n=256, tile_q=16, interpret=True)
    got = mips_kernel.block_maxima(torch.from_numpy(queries).to(getattr(torch, dtype)),
                                   torch.from_numpy(corpus).to(getattr(torch, dtype)),
                                   block=32, tile_n=256)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_block_maxima_partial_last_group_is_zero_padding():
    """N a multiple of block but not of group * block: the port's last group
    is the zero-padded one the JAX package's caller pads to."""
    queries, corpus = _data(16, 16 * 8 * 2 + 16 * 3, 96, seed=5)
    padded = np.concatenate([corpus, np.zeros((16 * 5, 96), np.float32)])
    want = pallas_mips.block_maxima_grouped(jnp.asarray(queries), jnp.asarray(padded), block=16,
                                            group=8, tile_q=16, interpret=True)
    got = mips_kernel.block_maxima_grouped(torch.from_numpy(queries), torch.from_numpy(corpus),
                                           block=16, group=8)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (g.shape[0], *g.shape[1:]) and g.shape[0] == 3
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("d,dtype", [(96, "float32"), (768, "bfloat16")])
def test_gather_rescore_matches_jax(d, dtype):
    """K6 and K9's plain version against both Pallas kernels at width d."""
    rng = np.random.default_rng(d + 3)
    corpus = rng.standard_normal((16, 16, d)).astype(np.float32) / np.sqrt(d)
    queries = rng.standard_normal((8, d)).astype(np.float32) / np.sqrt(d)
    ids = rng.integers(0, 16, (8, 8)).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jc, ji = jnp.asarray(queries, jdt), jnp.asarray(corpus, jdt), jnp.asarray(ids)
    tq, tc, ti = (torch.from_numpy(queries).to(tdt), torch.from_numpy(corpus).to(tdt),
                  torch.from_numpy(ids))
    got = rescore.gather_rescore(tq, tc, ti, block=16)
    for want in (jax_gather_rescore(jq, jc, ji, block=16, interpret=True),
                 jax_gather_score(jq, jc, ji, block=16, qb=8, jb=8, interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)
    np.testing.assert_array_equal(rescore.gather_score(tq, tc, ti, block=16).numpy(),
                                  got.numpy())
    np.testing.assert_allclose(rescore.gather_rescore_reference(tq, tc, ti.long(), block=16)
                               .numpy(), got.numpy(), atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDTHS)
def test_mips_topk_matches_jax(d, dtype):
    """mips_topk over N > 4,096 rows (the block-max pipeline) with n_valid
    inside a block: ids equal the JAX package's up to ties."""
    queries, corpus = _data(64, 8192, d, seed=d + 4)
    n_valid = 8192 - 1000 + 5
    jq, jc = jnp.asarray(queries, getattr(jnp, dtype)), jnp.asarray(corpus, getattr(jnp, dtype))
    jv, ji = jax_mips.mips_topk(jq, jc, 80, n_valid=n_valid)
    tq = torch.from_numpy(queries).to(getattr(torch, dtype))
    tc = torch.from_numpy(corpus).to(getattr(torch, dtype))
    before = mips_kernel.launches + mips_kernel.f32_launches
    gv, gi = mips.mips_topk(tq, tc, 80, n_valid=n_valid)
    assert mips_kernel.launches + mips_kernel.f32_launches == before  # the CPU: no kernel
    assert topk_disagreements(gv.numpy(), gi.numpy(), np.asarray(jv), np.asarray(ji),
                              atol=ATOL) == 0
    assert (gi.numpy() < n_valid).all()


def test_mips_topk_v2_in_place_equals_a_padded_copy():
    """mips_topk_v2 searches a corpus whose rows end inside the last group
    where they lie: the same values and ids as over the zero-padded copy."""
    queries, corpus = _data(32, 16 * 128 * 2 + 16 * 7, 256, seed=8)
    tq, tc = torch.from_numpy(queries), torch.from_numpy(corpus)
    padded = mips.pad_rows(tc, 16 * 128)
    a = mips_kernel.mips_topk_v2(tq, tc, 80, block=16, n_valid=tc.shape[0] - 5)
    b = mips_kernel.mips_topk_v2(tq, padded, 80, block=16, n_valid=tc.shape[0] - 5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_dense_index_at_768_matches_jax(tmp_path, dtype):
    """DenseIndex at D = 768: search against the JAX index's, and save and
    load with embeddings.npy and idx_id.json byte-equal between the
    packages."""
    queries, corpus = _data(40, 5003, 768, seed=9)
    ids = [f"p{i}" for i in range(len(corpus))]
    jdt = "int8" if dtype == "int8" else getattr(jnp, dtype)
    tdt = "int8" if dtype == "int8" else getattr(torch, dtype)
    jidx = JaxDenseIndex.from_embeddings(corpus, JaxIdMap(ids), dtype=jdt)
    tidx = DenseIndex.from_embeddings(corpus, IdMap(ids), device="cpu", dtype=tdt)
    assert tidx.embeddings.shape == jidx.embeddings.shape and tidx.dim == 768
    jv, ji = jidx.search(queries, 20)
    tv, ti = tidx.search(queries, 20)
    assert topk_disagreements(tv, ti, np.asarray(jv), np.asarray(ji),
                              atol=INT8_ATOL if dtype == "int8" else ATOL) == 0
    tidx.save(str(tmp_path / "t"))
    jidx.save(str(tmp_path / "j"))
    for name in ("embeddings.npy", "idx_id.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    back = DenseIndex.load(str(tmp_path / "j"), device="cpu", dtype=tdt)
    assert back.dim == 768 and back.n == len(corpus)


# --- the CLIs over a 256-wide retriever (tiny BERT towers) ---

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"tok{i}" for i in range(60)] + [
    "what", "is", "about",
]
N_PARAS, N_QUESTIONS, WIDE = 1200, 24, 256


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("wide_world")
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    rng = np.random.default_rng(0)
    paras = []
    for i in range(N_PARAS):
        toks = rng.integers(0, 60, size=rng.integers(2, 30))
        paras.append((f"p{i}", " ".join(f"tok{t}" for t in toks)))
    with open(root / "corpus.jsonl", "w") as f:
        for pid, text in paras:
            f.write(json.dumps({"text": text, "id": pid}) + "\n")
    DocDB.create(str(root / "docs.db"), paras)
    with open(root / "qa.jsonl", "w") as f:
        for i in range(N_QUESTIONS):
            f.write(json.dumps({"question": f"what is about tok{i} tok{(7 * i) % 60}",
                                "answer": [f"tok{(i + 5) % 60}"]}) + "\n")
    # a 256-wide retriever as the JAX package saves it (flax msgpack), and
    # converted to the port's .npz; a QA checkpoint holding the same retriever
    cfg = JaxBertConfig.tiny(initializer_range=0.3)
    params = init_retriever_params(jax.random.PRNGKey(1), cfg, embed_dim=WIDE)
    save_checkpoint(str(root / "ret.msgpack"), params)
    qa = dict(init_qa_params(jax.random.PRNGKey(2), cfg, JaxQAConfig()))
    qa["retriever"] = params
    save_checkpoint(str(root / "qa.msgpack"), qa)
    for name in ("ret", "qa"):
        with open(root / f"{name}.msgpack", "rb") as f:
            save_npz(str(root / f"{name}.npz"),
                     jax.tree.map(np.asarray, serialization.msgpack_restore(f.read())))
    return root


def _run(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _common(world, ckpt):
    return ["--vocab", str(world / "vocab.txt"), "--tiny", "--f32", "--max-seq-length", "64",
            "--max-query-length", "12", "--init-checkpoint", str(world / ckpt)]


def test_a_strict_128_wide_load_refuses_the_checkpoint(world):
    """What the port's loaders did before they read the width: a 128-wide
    Retriever's strict load_state_dict of the 256-wide checkpoint raises."""
    params = load_params(str(world / "ret.npz"))
    assert embed_dim_of(params) == WIDE
    with pytest.raises(RuntimeError, match="size mismatch"):
        Retriever(BertConfig.tiny(dtype=torch.float32)).load_state_dict(params)
    model = Retriever(BertConfig.tiny(dtype=torch.float32), embed_dim_of(params))
    model.load_state_dict(params)
    assert model.proj_c.kernel.shape[-1] == WIDE


def test_cli_retrieval_at_256_matches_jax(world, capsys):
    """build-index, encode-queries, eval-retrieval and retrieve from the
    256-wide checkpoint: the same recall JSON, and top-k ids equal up to
    ties, through both CLIs."""
    w = str(world)
    runs = {}
    for name, main, ckpt, extra in (("jax", jax_main, "ret.msgpack", []),
                                    ("torch", torch_main, "ret.npz", ["--device", "cpu"])):
        r = runs[name] = {}
        r["build"] = _run(main, ["build-index", *_common(world, ckpt), *extra, "--corpus",
                                 f"{w}/corpus.jsonl", "--output-dir", f"{w}/{name}_idx"], capsys)
        r["encode"] = _run(main, ["encode-queries", *_common(world, ckpt), *extra, "--queries",
                                  f"{w}/qa.jsonl", "--output", f"{w}/{name}_q.npy"], capsys)
        r["eval"] = _run(main, ["eval-retrieval", f"{w}/qa.jsonl", f"{w}/{name}_idx",
                                f"{w}/{name}_q.npy", f"{w}/docs.db", "--topk", "80", "--f32",
                                *extra], capsys)
        r["retrieve"] = _run(main, ["retrieve", *_common(world, ckpt), *extra, "--question",
                                    "what is about tok3 tok21", "--index", f"{w}/{name}_idx",
                                    "--db", f"{w}/docs.db", "--topk", "10"], capsys)
    jax_run, torch_run = runs["jax"], runs["torch"]
    assert torch_run["eval"] == jax_run["eval"]
    emb_j, emb_t = np.load(f"{w}/jax_idx/embeddings.npy"), np.load(f"{w}/torch_idx/embeddings.npy")
    assert emb_t.shape == emb_j.shape == (N_PARAS, WIDE)
    np.testing.assert_allclose(emb_t, emb_j, atol=1e-4, rtol=0)
    q_j, q_t = np.load(f"{w}/jax_q.npy"), np.load(f"{w}/torch_q.npy")
    assert q_t.shape == (N_QUESTIONS, WIDE)
    np.testing.assert_allclose(q_t, q_j, atol=1e-4, rtol=0)
    rj, rt = jax_run["retrieve"]["topk"], torch_run["retrieve"]["topk"]
    assert topk_disagreements(
        np.array([[r["score"] for r in rt]]), np.array([[r["row"] for r in rt]]),
        np.array([[r["score"] for r in rj]]), np.array([[r["row"] for r in rj]]),
        atol=2e-4) == 0
    jv, ji = JaxDenseIndex.load(f"{w}/jax_idx", dtype=jnp.float32).search(q_j, 80)
    tv, ti = DenseIndex.load(f"{w}/torch_idx", device="cpu", dtype=torch.float32).search(q_t, 80)
    assert topk_disagreements(tv, ti, np.asarray(jv), np.asarray(ji), atol=2e-4) == 0


def test_cli_eval_qa_at_256_matches_jax(world, capsys):
    """eval-qa over the 256-wide index from a QA checkpoint holding the
    256-wide retriever: the same EM JSON and predictions through both
    CLIs; and --retriever-path alone builds the QA model at the file's
    width."""
    from proqa_tpu_torch.cli.main import _qa_setup, build_parser

    w = str(world)
    if not (world / "torch_idx").exists():
        torch_main(["build-index", *_common(world, "ret.npz"), "--device", "cpu", "--corpus",
                    f"{w}/corpus.jsonl", "--output-dir", f"{w}/torch_idx"])
    qa_args = ["--vocab", f"{w}/vocab.txt", "--tiny", "--f32", "--max-seq-length", "64",
               "--max-query-length", "12", "--db", f"{w}/docs.db", "--index", f"{w}/torch_idx",
               "--questions-per-batch", "8", "--eval-k", "3", "--predict-file",
               f"{w}/qa.jsonl"]
    em = {}
    for name, main, ckpt, extra in (("jax", jax_main, "qa.msgpack", []),
                                    ("torch", torch_main, "qa.npz", ["--device", "cpu"])):
        em[name] = _run(main, ["eval-qa", *qa_args, *extra, "--init-checkpoint",
                               f"{w}/{ckpt}", "--output-dir", f"{w}/{name}_qa",
                               "--save-pred", f"{w}/{name}_pred.jsonl"], capsys)
    assert em["torch"] == em["jax"]
    with open(f"{w}/jax_pred.jsonl") as f, open(f"{w}/torch_pred.jsonl") as g:
        jrows, trows = [json.loads(x) for x in f], [json.loads(x) for x in g]
    assert [r["para"] for r in trows] == [r["para"] for r in jrows]
    assert [r["answer"] for r in trows] == [r["answer"] for r in jrows]
    args = build_parser().parse_args(["eval-qa", *qa_args, "--device", "cpu",
                                      "--retriever-path", f"{w}/ret.npz",
                                      "--output-dir", f"{w}/setup"])
    model = _qa_setup(args)[0].model
    want = load_params(f"{w}/ret.npz")
    assert model.retriever.proj_q.kernel.shape == (BertConfig.tiny().hidden_size, WIDE)
    for key, value in model.retriever.state_dict().items():
        torch.testing.assert_close(value, want[key], atol=0, rtol=0, msg=key)
