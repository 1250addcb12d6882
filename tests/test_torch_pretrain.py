"""CLI parity for retriever pretraining: `proqa pretrain-retriever` (JAX) and
`proqa-torch pretrain-retriever --device cpu` on the verify skill's world
from one initial checkpoint (msgpack for JAX, .npz for the port), then
`proqa-torch build-index` from the port's checkpoint_last.pt."""
import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from proqa_tpu.cli.main import main as jax_cli  # noqa: E402
from proqa_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from proqa_tpu.models.retriever import init_retriever_params  # noqa: E402
from proqa_tpu.train.checkpoint import save_checkpoint  # noqa: E402
from proqa_tpu_torch.cli.main import main as torch_cli  # noqa: E402
from proqa_tpu_torch.models import convert  # noqa: E402
from proqa_tpu_torch.train.checkpoint import load_checkpoint  # noqa: E402

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"tok{i}" for i in range(60)] + [
    "what", "is", "about"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("pretrain_world")
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    with open(root / "pairs.jsonl", "w") as f:  # 3 questions per paragraph
        for i in range(30):
            pid = i // 3
            f.write(json.dumps({"Question": f"what is about tok{pid} variant {i % 3}",
                                "Paragraph": " ".join(f"tok{(pid + j) % 60}" for j in range(25)),
                                "Answer": f"tok{pid + 10}"}) + "\n")
    with open(root / "corpus.jsonl", "w") as f:
        for i in range(40):
            f.write(json.dumps({"text": " ".join(f"tok{(i + j) % 60}" for j in range(20)),
                                "id": f"p{i}"}) + "\n")
    params = jax.tree.map(np.asarray,
                          init_retriever_params(jax.random.PRNGKey(0), JaxBertConfig.tiny()))
    save_checkpoint(str(root / "init.msgpack"), params)
    convert.save_npz(str(root / "init.npz"), params)
    return root


def _run(cli, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _pretrain_args(world, out, init, lr):
    return ["pretrain-retriever", "--vocab", str(world / "vocab.txt"), "--tiny", "--f32",
            "--max-seq-length", "64", "--max-query-length", "12",
            "--train-file", str(world / "pairs.jsonl"),
            "--predict-file", str(world / "pairs.jsonl"),
            "--output-dir", str(world / out), "--init-checkpoint", str(world / init),
            "--train-batch-size", "8", "--predict-batch-size", "8", "--num-train-epochs", "1",
            "--eval-period", "2", "--save-checkpoints-steps", "100",
            "--learning-rate", str(lr), "--filter"]


def test_pretrain_at_lr_zero_matches_jax(world):
    """Eval is deterministic and lr 0 keeps the weights, so both CLIs report
    the same in-batch accuracy."""
    want = _run(jax_cli, _pretrain_args(world, "jax_lr0", "init.msgpack", 0.0))
    got = _run(torch_cli, _pretrain_args(world, "torch_lr0", "init.npz", 0.0) + ["--device", "cpu"])
    assert set(got) == {"best_in_batch_acc"}
    assert got == want


def test_pretrain_then_build_index(world):
    want = _run(jax_cli, _pretrain_args(world, "jax_run", "init.msgpack", 1e-3))
    got = _run(torch_cli,
               _pretrain_args(world, "torch_run", "init.npz", 1e-3) + ["--device", "cpu"])
    assert 0.0 <= got["best_in_batch_acc"] <= 1.0 and 0.0 <= want["best_in_batch_acc"] <= 1.0
    run = world / "torch_run"
    for name in ("checkpoint_last.pt", "checkpoint_best.pt", "trainer_meta.json"):
        assert (run / name).exists()
    state = load_checkpoint(str(run / "checkpoint_last.pt"))
    assert state.step == 3  # 30 pairs, 8 a batch, the partial batch dropped
    built = _run(torch_cli, ["build-index", "--vocab", str(world / "vocab.txt"), "--tiny",
                             "--max-seq-length", "64", "--corpus", str(world / "corpus.jsonl"),
                             "--init-checkpoint", str(run / "checkpoint_last.pt"),
                             "--output-dir", str(world / "index"), "--predict-batch-size", "8",
                             "--device", "cpu"])
    assert built == {"rows": 40, "dim": 128, "saved": str(world / "index")}
    emb = np.load(world / "index" / "embeddings.npy")
    assert emb.shape == (40, 128) and np.isfinite(emb).all()


def test_pretrain_on_cluster_shards(world):
    """A directory of per-cluster pair shards trains through
    ClusterPairDataset, every batch drawn from one cluster."""
    shards = world / "shards"
    shards.mkdir()
    lines = (world / "pairs.jsonl").read_text().splitlines()
    (shards / "0.jsonl").write_text("\n".join(lines[:18]) + "\n")
    (shards / "1.jsonl").write_text("\n".join(lines[18:]) + "\n")
    args = _pretrain_args(world, "cluster_run", "init.npz", 1e-3)
    args[args.index("--train-file") + 1] = str(shards)
    args[args.index("--train-batch-size") + 1] = "6"
    got = _run(torch_cli, args + ["--device", "cpu"])
    assert 0.0 <= got["best_in_batch_acc"] <= 1.0
    assert load_checkpoint(str(world / "cluster_run" / "checkpoint_last.pt")).step == 5
