"""The port's streaming index build (`build_index(stream_chunk=...)`,
`build-index --stream-chunk`) against its in-memory build and the JAX
package's streamed one, in f32 on the CPU.

The library cases are twins of tests/test_index_build.py's streaming tests:
23 rows in chunks of 7 (several chunks, a ragged last one), a tiny retriever
of 8-wide embeddings from one JAX initialisation. The CLI case streams the
tiny world of tests/test_torch_retrieval.py's shape through both CLIs.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from proqa_tpu.cli.main import main as jax_main  # noqa: E402
from proqa_tpu.index import build_index as jax_build_index  # noqa: E402
from proqa_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from proqa_tpu.models.retriever import init_retriever_params  # noqa: E402
from proqa_tpu.train.checkpoint import save_checkpoint  # noqa: E402
from proqa_tpu_torch.cli.main import main as torch_main  # noqa: E402
from proqa_tpu_torch.index.build import build_index, encode_corpus_streaming  # noqa: E402
from proqa_tpu_torch.index.dense import DenseIndex  # noqa: E402
from proqa_tpu_torch.models.bert import BertConfig  # noqa: E402
from proqa_tpu_torch.models.convert import params_from_jax, save_npz  # noqa: E402
from proqa_tpu_torch.models.retriever import Retriever  # noqa: E402

# f32 embeddings of a tiny BERT: the two packages, and batches padded to
# other bucket lengths, sum in other orders (~1e-7 here); the JAX twin's bound
ATOL = 1e-5


class FakeTok:
    """tests/test_index_build.py's tokenizer: crc32 word ids, [CLS] .. [SEP]."""

    def encode(self, text, max_length=None):
        import zlib

        ids = [2] + [5 + (zlib.crc32(w.encode()) % 100) for w in text.split()] + [3]
        return ids[:max_length] if max_length else ids


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream_build")
    with open(root / "corpus.jsonl", "w") as f:
        for i in range(23):
            words = " ".join(["words"] * (i % 5))  # lengths vary: several buckets
            f.write(json.dumps({"text": f"para {i} {words} here", "id": f"p{i}"}) + "\n")
    params = init_retriever_params(jax.random.PRNGKey(0), JaxBertConfig.tiny(dtype=jnp.float32),
                                   embed_dim=8)
    model = Retriever(BertConfig.tiny(dtype=torch.float32), embed_dim=8)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return root, params, model.eval()


def _build(model, corpus, path, **kw):
    return build_index(model, str(corpus), tokenizer=FakeTok(), max_length=12, batch_size=8,
                       dtype=torch.float32, save_path=str(path), **kw)


def test_streaming_build_matches_inmemory_and_jax(setup, tmp_path):
    root, params, model = setup
    ref = _build(model, root / "corpus.jsonl", tmp_path / "mem")
    streamed = _build(model, root / "corpus.jsonl", tmp_path / "stream", stream_chunk=7)
    jax_build_index(params, JaxBertConfig.tiny(dtype=jnp.float32), str(root / "corpus.jsonl"),
                    tokenizer=FakeTok(), max_length=12, batch_size=8, dtype=jnp.float32,
                    save_path=str(tmp_path / "jax_stream"), stream_chunk=7)
    a = np.load(tmp_path / "mem" / "embeddings.npy")
    b = np.load(tmp_path / "stream" / "embeddings.npy")
    j = np.load(tmp_path / "jax_stream" / "embeddings.npy")
    assert b.shape == (23, 8) and b.dtype == np.float32
    np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)
    np.testing.assert_allclose(b, j, rtol=0, atol=ATOL)
    for other in ("mem", "jax_stream"):
        assert (tmp_path / "stream" / "idx_id.json").read_bytes() == \
            (tmp_path / other / "idx_id.json").read_bytes()
    assert len(streamed) == len(ref) == 23 and streamed.id_map[22] == "p22"
    q = a[:3]
    _, i1 = ref.search(q, 4)
    _, i2 = streamed.search(q, 4)
    np.testing.assert_array_equal(i2, i1)
    loaded = DenseIndex.load(str(tmp_path / "stream"), device="cpu", dtype=torch.float32)
    np.testing.assert_array_equal(loaded.search(q, 4)[1], i1)


def test_streaming_encode_chunks_bound_the_host_rows(setup, tmp_path, monkeypatch):
    """Pass 2 tokenizes one chunk at a time: when a batch reaches the
    encoder, the rows tokenized and not yet encoded are at most a chunk plus
    the batches in flight (one queued with prefetch 1, one waiting to be
    queued, the one being encoded), never the corpus; and the memmap is the
    returned array."""
    root, _, model = setup
    seen, encoded = [], []
    tok = FakeTok()
    real_encode = tok.encode

    def counting(text, max_length=None):
        seen.append(text)
        return real_encode(text, max_length=max_length)

    monkeypatch.setattr(tok, "encode", counting)
    real_forward = model.encode_context

    # real rows of each batch: chunks of 7, 7, 7, 2 in batches of 4
    batch_rows = [4, 3, 4, 3, 4, 3, 2]

    def counting_forward(ids, mask, **kw):
        # rows tokenized and not yet encoded when this batch reaches the encoder
        encoded.append(len(seen) - sum(batch_rows[:len(encoded)]))
        return real_forward(ids, mask, **kw)

    monkeypatch.setattr(model, "encode_context", counting_forward)
    out, ids = encode_corpus_streaming(model, str(root / "corpus.jsonl"), tok,
                                       str(tmp_path / "e.npy"), max_length=12, batch_size=4,
                                       chunk_rows=7, prefetch=1)
    assert isinstance(out, np.memmap) and out.shape == (23, 8)
    assert ids == [f"p{i}" for i in range(23)] and len(seen) == 23
    assert len(encoded) == len(batch_rows) and max(encoded) <= 7 + 3 * 4 < 23


def test_streaming_build_accepts_pair_rows(setup, tmp_path):
    """The progressive phase-2 recipe streams the pair file (its Paragraph
    field): the rows equal the corpus rows of the same texts."""
    root, _, model = setup
    pair_path = tmp_path / "pairs.jsonl"
    with open(root / "corpus.jsonl") as fin, open(pair_path, "w") as fout:
        for line in fin:
            row = json.loads(line)
            fout.write(json.dumps({"Question": "q", "Paragraph": row["text"], "Answer": "a",
                                   "id": row["id"]}) + "\n")
    _build(model, root / "corpus.jsonl", tmp_path / "mem")
    _build(model, pair_path, tmp_path / "pairs", stream_chunk=7)
    np.testing.assert_allclose(np.load(tmp_path / "pairs" / "embeddings.npy"),
                               np.load(tmp_path / "mem" / "embeddings.npy"), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="save_path"):
        build_index(model, str(pair_path), tokenizer=FakeTok(), max_length=12, batch_size=8,
                    dtype=torch.float32, stream_chunk=7)


def test_cli_build_index_stream_chunk_matches_jax(tmp_path, capsys):
    """build-index --stream-chunk through both CLIs on a tiny world, with a
    ragged last chunk: the port's artifact equals its in-memory build's and
    the JAX CLI's streamed one."""
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"tok{i}" for i in range(60)]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    rng = np.random.default_rng(3)
    with open(tmp_path / "corpus.jsonl", "w") as f:
        for i in range(50):
            toks = rng.integers(0, 60, size=rng.integers(4, 60))
            f.write(json.dumps({"text": " ".join(f"tok{t}" for t in toks), "id": f"p{i}"}) + "\n")
    params = init_retriever_params(jax.random.PRNGKey(1), JaxBertConfig.tiny())
    save_checkpoint(str(tmp_path / "ckpt.msgpack"), params)
    with open(tmp_path / "ckpt.msgpack", "rb") as f:
        save_npz(str(tmp_path / "ckpt.npz"),
                 jax.tree.map(np.asarray, serialization.msgpack_restore(f.read())))
    w = str(tmp_path)
    common = ["--vocab", f"{w}/vocab.txt", "--tiny", "--f32", "--max-seq-length", "64",
              "--corpus", f"{w}/corpus.jsonl", "--predict-batch-size", "8"]
    runs = {}
    for name, main, ckpt, extra in (
            ("torch_mem", torch_main, "ckpt.npz", ["--device", "cpu"]),
            ("torch_stream", torch_main, "ckpt.npz", ["--device", "cpu", "--stream-chunk", "16"]),
            ("jax_stream", jax_main, "ckpt.msgpack", ["--stream-chunk", "16"])):
        main(["build-index", *common, "--init-checkpoint", f"{w}/{ckpt}", "--output-dir",
              f"{w}/{name}", *extra])
        runs[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert runs["torch_stream"] == {"rows": 50, "dim": 128, "saved": f"{w}/torch_stream"}
    got = np.load(tmp_path / "torch_stream" / "embeddings.npy")
    for other in ("torch_mem", "jax_stream"):
        np.testing.assert_allclose(got, np.load(tmp_path / other / "embeddings.npy"),
                                   rtol=0, atol=1e-4)
        assert (tmp_path / "torch_stream" / "idx_id.json").read_bytes() == \
            (tmp_path / other / "idx_id.json").read_bytes()
