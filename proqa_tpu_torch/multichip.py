"""Multi-card checks of the port, on a machine with several NVIDIA GPUs.

    python -m proqa_tpu_torch.multichip [--out FILE]
    python -m proqa_tpu_torch.multichip --device cpu --tiny   # a CPU rehearsal

Three parts, over every local card (`parallel/mesh.py:make_mesh()`), each
held to the same work on the first card alone:
  search  a DenseIndex row-sharded over the cards, 4,194,304 x 128 (bf16,
          then int8), Q = 2,048, k = 80: ids equal to the unsharded index's
          up to ties; one K1 (K5 over int8) and, over bf16, one K6 launch a
          shard; the search ms of both (host clock around synchronised
          calls, median of 5) and each card's peak memory;
  encode  `--dp-encode`'s encode (index/build.py:encode_corpus with the
          mesh) of 4,096 rows of 512 tokens by a BERT-base context tower,
          bf16, batches of 128 a card: rows/s beside the one-card encode,
          and the largest row difference (bf16 rows depend on their batch);
  ddp     `python -m torch.distributed.run --nproc-per-node <cards>` of
          this module's worker: 3 data-parallel retriever steps (f32, dropout
          0, accumulation 2, 16 rows a rank, contexts of 256) against one
          process on the global batch (losses within 1e-4: f32 sums of 12
          layers in other orders; weights within 2 x lr: Adam moves an
          element whose gradient is ~0 by up to lr on either side), then
          the bf16 step at 80 x (32 + 512) a rank (dropout 0.1, remat, fused
          attention): its median ms over 8 steps beside the one-card step's.
--device cpu --tiny runs the same on the CPU at small sizes, over
[cpu] * 4 and 4 gloo ranks. Prints one JSON object, with the cards' name
and power limit; exits non-zero with fewer than two CUDA devices (unless
--device cpu).
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

TOPK_TOL = 1e-4  # scores within this of the k-th count as ties (ids may swap)
LR = 1e-3


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _host_ms(fn, reps: int = 5) -> float:
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()  # DenseIndex.search ends in a copy to the host: synchronised
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def part_search(mesh, tiny: bool) -> dict:
    import numpy as np
    import torch

    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.ops import mips_kernel, rescore
    from proqa_tpu_torch.testing import topk_disagreements

    n, q, d, k = (65_536, 64, 128, 16) if tiny else (4_194_304, 2048, 128, 80)
    first = mesh[0]
    g = torch.Generator(device=first).manual_seed(4)
    corpus = (torch.randn(n, d, device=first, generator=g) / d ** 0.5).bfloat16()
    queries = torch.randn(q, d, device=first, generator=g) / d ** 0.5
    out = {}
    for kind in (torch.bfloat16, "int8"):
        label = "bf16" if kind is torch.bfloat16 else "int8"
        src = corpus if kind is torch.bfloat16 else corpus.float().cpu().numpy()
        whole = DenseIndex.from_embeddings(src, device=first, dtype=kind)
        sharded = DenseIndex.from_embeddings(src, mesh=mesh, dtype=kind)
        counter = "launches" if kind is torch.bfloat16 else "scaled_launches"
        setattr(mips_kernel, counter, 0)
        rescore.launches = 0
        vals, idx = sharded.search(queries, k)
        launches = {"K1" if kind is torch.bfloat16 else "K5": getattr(mips_kernel, counter),
                    "K6": rescore.launches}
        wv, wi = whole.search(queries, k)
        bad = topk_disagreements(vals, idx, wv, wi, atol=TOPK_TOL)
        if first.type == "cuda":
            for dev in mesh:
                torch.cuda.reset_peak_memory_stats(dev)
        ms = {"sharded_ms": _host_ms(lambda: sharded.search(queries, k)),
              "unsharded_ms": _host_ms(lambda: whole.search(queries, k))}
        peaks = ([torch.cuda.max_memory_allocated(dev) / 2 ** 30 for dev in mesh]
                 if first.type == "cuda" else None)
        out[label] = {**ms, "launches": launches, "disagreements": bad,
                      "peak_gib_per_card": peaks}
        # on the CPU the kernels' plain versions run and count nothing
        want = len(mesh) if first.type == "cuda" else 0
        if bad or list(launches.values())[0] != want:
            raise SystemExit(f"{label} sharded search: {bad} queries differ, launches {launches}")
        del whole, sharded
    return {"rows": n, "queries": q, "k": k, **out}


def part_encode(mesh, tiny: bool) -> dict:
    import numpy as np
    import torch

    from proqa_tpu_torch.index.build import encode_corpus
    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.retriever import Retriever

    n_rows, t, per_card = (64, 64, 4) if tiny else (4096, 512, 128)
    cfg = (BertConfig.tiny(flash_attention=True) if tiny
           else BertConfig(flash_attention=True))
    rng = np.random.default_rng(5)
    rows = [rng.integers(5, cfg.vocab_size, t - 2).tolist() for _ in range(n_rows)]

    class _Rows:
        max_len = t

        def __len__(self):
            return n_rows

        def __getitem__(self, i):
            return [2, *rows[i], 3]

    model = Retriever(cfg).reset_parameters(6).to(mesh[0]).eval()
    res = {}
    embs = {}
    for name, m, bsz in (("one_card", None, per_card), ("mesh", mesh, per_card * len(mesh))):
        encode_corpus(model, _Rows(), batch_size=bsz, buckets=(t,), mesh=m)  # warm-up
        _sync(mesh[0])
        t0 = time.perf_counter()
        embs[name] = encode_corpus(model, _Rows(), batch_size=bsz, buckets=(t,), mesh=m)
        res[f"{name}_rows_per_s"] = n_rows / (time.perf_counter() - t0)
    res["max_abs_diff"] = float(np.abs(embs["mesh"] - embs["one_card"]).max())
    return {"rows": n_rows, "tokens_per_row": t, **res}


def _trainer(device, out_dir: str, *, tiny: bool, f32: bool):
    import torch

    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.train.retriever_trainer import RetrieverTrainer, RetrieverTrainerConfig

    kw = (dict(dtype=torch.float32, hidden_dropout=0.0, attention_dropout=0.0) if f32
          else dict(remat=True, flash_attention=True))
    cfg = BertConfig.tiny(**kw) if tiny else BertConfig(**kw)
    tcfg = RetrieverTrainerConfig(learning_rate=LR, seed=7, output_dir=out_dir,
                                  accumulate_gradients=2 if f32 else 1)
    return RetrieverTrainer(cfg, tcfg, device=device)


def _batch(rows: int, tq: int, tc: int, vocab: int, seed: int) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed)
    ids_c = rng.integers(5, vocab, size=(rows, tc))
    ids_c *= np.arange(tc)[None] < rng.integers(tc // 2, tc + 1, size=(rows, 1))
    return {"input_ids_q": ids_c[:, :tq].copy(), "input_mask_q": np.ones((rows, tq), np.int32),
            "input_ids_c": ids_c, "input_mask_c": (ids_c != 0).astype(np.int32)}


def _shapes(tiny: bool) -> dict:
    return {"parity": (4, 8, 32) if tiny else (16, 32, 256),
            "speed": (8, 8, 64) if tiny else (80, 32, 512),
            "vocab": 128 if tiny else 30522}


def _steps(trainer, batch: dict, n: int) -> tuple[list, list]:
    losses, walls = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(float(trainer.step(dict(batch))["loss"]))  # synchronises
        walls.append(time.perf_counter() - t0)
    return losses, walls


def worker(out_path: str, device: str, tiny: bool) -> int:
    """One rank under torch.distributed.run: the parity steps on the global
    batch (each rank its share), then the speed steps at a rank's rows."""
    import torch

    sh = _shapes(tiny)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = _trainer(device, os.path.join(tmp, "parity"), tiny=tiny, f32=True)
        rows, tq, tc = sh["parity"]
        world = trainer.dp.world
        losses, _ = _steps(trainer, _batch(rows * world, tq, tc, sh["vocab"], 1), 3)
        params = {k: p.detach().cpu() for k, p in trainer.state.params.items()}
        del trainer
        rows, tq, tc = sh["speed"]
        trainer = _trainer(device, os.path.join(tmp, "speed"), tiny=tiny, f32=False)
        _, walls = _steps(trainer, _batch(rows * world, tq, tc, sh["vocab"], 2), 9)
        if trainer.dp.main:
            torch.save({"losses": losses, "params": params, "walls": walls[1:],
                        "backend": trainer.dp.backend, "world": world}, out_path)
    return 0


def part_ddp(devices: list, tiny: bool) -> dict:
    import torch

    sh = _shapes(tiny)
    n = len(devices)
    device = "cpu" if devices[0].type == "cpu" else "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
               "--nproc-per-node", str(n), "--master-addr", "127.0.0.1",
               "--master-port", str(port), "-m", "proqa_tpu_torch.multichip",
               "--worker", out, "--device", device] + (["--tiny"] if tiny else [])
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode:
            raise SystemExit(f"the data-parallel run exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
        got = torch.load(out)
        ref = _trainer(devices[0], os.path.join(tmp, "ref"), tiny=tiny, f32=True)
        rows, tq, tc = sh["parity"]
        want, _ = _steps(ref, _batch(rows * n, tq, tc, sh["vocab"], 1), 3)
        loss_err = max(abs(a - b) for a, b in zip(got["losses"], want))
        param_err = max((got["params"][k] - p.detach().cpu()).abs().max().item()
                        for k, p in ref.state.params.items())
        del ref
        rows, tq, tc = sh["speed"]
        one = _trainer(devices[0], os.path.join(tmp, "one"), tiny=tiny, f32=False)
        _, walls = _steps(one, _batch(rows, tq, tc, sh["vocab"], 2), 9)
    if got["backend"] != ("nccl" if device == "cuda" else "gloo") or got["world"] != n:
        raise SystemExit(f"the run's group: {got['backend']} x {got['world']}")
    if loss_err > 1e-4 or param_err > 2 * LR:
        raise SystemExit(f"data parallel against one process: loss {loss_err}, "
                         f"weights {param_err}")
    step = {"ranks_ms": statistics.median(got["walls"]) * 1e3,
            "one_card_ms": statistics.median(walls[1:]) * 1e3}
    return {"ranks": n, "backend": got["backend"], "loss_max_abs_err": loss_err,
            "param_max_abs_err": param_err, "losses": got["losses"],
            "step_rows_per_rank": sh["speed"], **step,
            "launcher_wall_s": wall}


def _gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="small sizes (a CPU rehearsal)")
    ap.add_argument("--only", default="search,encode,ddp")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker, args.device, args.tiny)

    import torch

    from proqa_tpu_torch.ops.dot import pin_f32_precision
    from proqa_tpu_torch.parallel import make_mesh

    if args.device == "cpu":
        mesh = make_mesh(devices=["cpu"] * 4)
    else:
        if torch.cuda.device_count() < 2:
            print("multichip: needs two or more CUDA devices", file=sys.stderr)
            return 1
        mesh = make_mesh()
    pin_f32_precision()
    result = {"device": {"cards": _gpu_line().splitlines() if mesh[0].type == "cuda" else None,
                         "mesh": [str(d) for d in mesh]}}
    parts = {"search": part_search, "encode": part_encode, "ddp": part_ddp}
    for name in args.only.split(","):
        t0 = time.perf_counter()
        result[name] = parts[name](mesh, args.tiny)
        result[name]["seconds"] = time.perf_counter() - t0
        if mesh[0].type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps({name: result[name]}, default=str), flush=True)
    line = json.dumps(result, default=str)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
