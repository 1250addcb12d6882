#!/usr/bin/env python3
"""Phase 19's dropout-0 check (chip_smoke.py:phase_qa_train) under many
Python hash seeds, on one NVIDIA GPU.

    python3 qa_dropout0_sweep.py FIRST-LAST OUT_DIR [PARALLEL]

Builds the kernels and phase 19's world as chip_smoke.py does (phase_cli,
then phase_qa, under PYTHONHASHSEED=0), then runs phase 19 in a fresh
process for every hash seed FIRST..LAST, PARALLEL processes at a time
(default 4), each on its own view of the world. The QA sampler keeps a
paragraph's first answer spans in the iteration order of a set of strings,
so the hash seed picks the train batch, and with it the trained weights and
the dropout-0 step's inputs; within one seed the phase is the same in every
process. Each worker holds every F1/F2 backward launch of its dropout-0
step's kernels route against f64 (_backward_audit) and saves the step's
inputs where the check fails. A failing input is then replayed twice in a
fresh process. Writes OUT_DIR/sweep.json (each seed's failure, first loss,
largest error ratio with both distances, and F1/F2's errors from f64) and
each worker's log; exits 1 if a worker could not finish.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import chip_smoke
from chip_smoke import SmokeFailure, log


@contextlib.contextmanager
def _backward_audit(calls: list):
    """Runs every F1 and F2 backward launch as usual and holds its outputs,
    and the plain versions' f32 outputs on the same inputs, against the same
    formulas in f64: one entry a launch in `calls`, in launch order (the
    backward visits the layers last to first)."""
    import torch

    from proqa_tpu_torch.ops import fused_bert

    f1, f2 = fused_bert._dense_epilogue_backward_kernel, fused_bert._add_layer_norm_backward_kernel

    def err(got, want):
        return None if got is None else (got.double() - want).abs().max().item()

    def dense(dout, z, gelu, need_dz, need_dbias):
        dz, dbias = f1(dout, z, gelu, need_dz, need_dbias)
        pz, pb = fused_bert.dense_epilogue_backward_reference(dout, z, gelu, need_dbias)
        # f64: the same formulas past the same roundings (dz rounded to
        # dout's dtype, then summed exactly)
        ez = (torch.ops.aten.gelu_backward(dout.double(), z.double(), approximate="none")
              if gelu else dout.double())
        eb = pz.double().reshape(-1, pz.shape[-1]).sum(0)
        calls.append({"kernel": "F1", "shape": list(dout.shape), "gelu": gelu,
                      "dz": [err(dz, ez), err(pz, ez)] if need_dz and gelu else None,
                      "dz_equal": torch.equal(dz, pz) if need_dz and gelu else None,
                      "dbias": [err(dbias, eb), err(pb, eb)] if need_dbias else None})
        return dz, dbias

    def layer_norm(dy, x, residual, mean, rstd, scale, need_dx, need_params):
        dx, ds, db = f2(dy, x, residual, mean, rstd, scale, need_dx, need_params)
        px, ps, pb = fused_bert.add_layer_norm_backward_reference(dy, x, residual, mean, rstd,
                                                                  scale, need_params)
        # f64: the formula over the forward's rounded sum and its f32 statistics
        s = (x if residual is None else x + residual).double()
        xh = (s - mean.double()[..., None]) * rstd.double()[..., None]
        d64 = dy.double()
        g = d64 * scale.double()
        ex = rstd.double()[..., None] * (g - g.mean(dim=-1, keepdim=True)
                                         - xh * (g * xh).mean(dim=-1, keepdim=True))
        h = x.shape[-1]
        es, eb = (d64 * xh).reshape(-1, h).sum(0), d64.reshape(-1, h).sum(0)
        calls.append({"kernel": "F2", "shape": list(dy.shape),
                      "dx": [err(dx, ex), err(px, ex)] if need_dx else None,
                      "dscale": [err(ds, es), err(ps, es)] if need_params else None,
                      "dbias": [err(db, eb), err(pb, eb)] if need_params else None})
        return dx, ds, db

    fused_bert._dense_epilogue_backward_kernel = dense
    fused_bert._add_layer_norm_backward_kernel = layer_norm
    try:
        yield
    finally:
        fused_bert._dense_epilogue_backward_kernel = f1
        fused_bert._add_layer_norm_backward_kernel = f2


def _largest_ratio(res: dict) -> dict:
    """The dropout-0 tensor of the largest |kernels - f32| / |plain chain -
    f32|, with both distances, |f32| and its cosines."""
    name = max(res["ratio_e"], key=res["ratio_e"].get)
    st = res["stats"][name]
    return {"tensor": name, "ratio_e": res["ratio_e"][name], "cos_e": res["cos_e"][name],
            "err_k": st["err_k"], "err_e": st["err_e"], "norm": st["norm"],
            "cos_e32": st["cos_e32"], "cos_k32": st["cos_k32"],
            "ratio_v": res["ratio"][name], "losses": res["losses"]}


def _audit_summary(audit: list) -> dict:
    """Each F1/F2 backward output's largest error from f64 over the step's
    launches, the kernel's beside the plain version's, and the largest
    ratio of the two at any one launch."""
    out = {}
    for call in audit:
        for key in ("dz", "dbias", "dx", "dscale"):
            pair = call.get(key)
            if not pair:
                continue
            name = f"{call['kernel']} {key}"
            o = out.setdefault(name, {"kernel": 0.0, "plain": 0.0, "worst_ratio": 0.0,
                                      "launches": 0})
            o["kernel"], o["plain"] = max(o["kernel"], pair[0]), max(o["plain"], pair[1])
            o["launches"] += 1
            if pair[1] > 0:
                o["worst_ratio"] = max(o["worst_ratio"], pair[0] / pair[1])
            elif pair[0] > 0:
                o["worst_ratio"] = float("inf")
    out["F1 dz bit-equal"] = all(c["dz_equal"] for c in audit if c.get("dz_equal") is not None)
    return out


def worker(root: str, out_path: str, keep: str, mode: str) -> int:
    """`qa_dropout0_sweep.py --worker ROOT OUT_JSON KEEP MODE`. MODE "run":
    phase 19 on the world at ROOT, auditing its dropout-0 step and saving
    that step's inputs to KEEP where the check fails; "replay": the
    dropout-0 step alone, twice, from the inputs saved at KEEP."""
    import traceback

    import torch

    from proqa_tpu_torch import _build
    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.ops.dot import pin_f32_precision

    pin_f32_precision()
    _build.library()
    device = torch.device("cuda", 0)
    notes, failure = {"hash_seed": os.environ.get("PYTHONHASHSEED")}, None
    step = chip_smoke._qa_dropout0

    def audited(device, state, dev, cfg):
        calls = []
        res = step(device, state, dev, cfg, kernels_route=lambda: _backward_audit(calls))
        notes.setdefault("dropout0", []).append(res)
        notes.setdefault("audit", []).append(calls)
        try:
            chip_smoke._check_qa_dropout0(res)
        except SmokeFailure:
            if mode == "run":
                torch.save({"state": state, "dev": dev}, keep)
        return res

    try:
        if mode == "replay":
            saved = torch.load(keep, map_location=device, weights_only=False)
            for _ in range(2):
                audited(device, saved["state"], saved["dev"],
                        BertConfig(remat=True, flash_attention=True))
            chip_smoke._check_qa_dropout0(notes["dropout0"][-1])
        else:
            chip_smoke._qa_dropout0 = audited
            notes["phase"] = {key: v for key, v in chip_smoke.phase_qa_train(device, root).items()
                              if key in ("losses", "min_grad_cos", "min_grad_cos_plain_chain")}
    except SmokeFailure as e:
        failure = str(e)
    except Exception:  # noqa: BLE001 - reported to the sweep, which exits 1
        failure = "error: " + traceback.format_exc()[-2000:]
    with open(out_path, "w") as f:
        json.dump({"mode": mode, "failure": failure, "notes": notes}, f)
    return 0


def _view(world: str, root: str) -> None:
    """A directory of links to the world's files: phase 19 writes its own
    question files and run directory beside them."""
    os.makedirs(root)
    for name in os.listdir(world):
        os.symlink(os.path.join(world, name), os.path.join(root, name))


def sweep(first: int, last: int, out_dir: str, parallel: int) -> int:
    import torch

    from proqa_tpu_torch import _build
    from proqa_tpu_torch.ops.dot import pin_f32_precision

    log(chip_smoke.gpu_line())
    pin_f32_precision()
    device = torch.device("cuda", 0)
    _build.build()
    _build.library()
    os.makedirs(out_dir, exist_ok=True)
    summary = {"seeds": {}}
    with tempfile.TemporaryDirectory(prefix="proqa_sweep_") as tmp:
        world = os.path.join(tmp, "world")
        os.makedirs(world)
        chip_smoke.phase_cli(device, world)
        chip_smoke.phase_qa(device, world)
        torch.cuda.empty_cache()

        def start(seed, mode, keep):
            root = os.path.join(tmp, f"seed_{seed}_{mode}")
            _view(world, root)
            out = os.path.join(root, "worker.json")
            logf = open(os.path.join(out_dir, f"seed_{seed}_{mode}.log"), "w")
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", root, out, keep, mode],
                stdout=logf, stderr=subprocess.STDOUT,
                env={**os.environ, "PYTHONHASHSEED": str(seed)})
            return proc, logf, out, time.perf_counter()

        def finish(job):
            proc, logf, out, t0 = job
            try:
                proc.wait(timeout=900)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            logf.close()
            if not os.path.exists(out):
                return {"failure": f"error: worker exited {proc.returncode} with no result"}
            with open(out) as f:
                res = json.load(f)
            res["seconds"] = round(time.perf_counter() - t0, 1)
            return res

        seeds, failing = list(range(first, last + 1)), None
        for i in range(0, len(seeds), parallel):
            batch = seeds[i:i + parallel]
            jobs = {s: start(s, "run", os.path.join(tmp, f"keep_{s}.pt")) for s in batch}
            for s in batch:
                out = finish(jobs[s])
                notes = out.get("notes", {})
                d0, audit = notes.get("dropout0") or [], notes.get("audit") or []
                row = {"failure": out["failure"], "seconds": out.get("seconds"),
                       "losses": (notes.get("phase") or {}).get("losses"),
                       "largest": _largest_ratio(d0[0]) if d0 else None,
                       "audit": _audit_summary(audit[0]) if audit else None}
                summary["seeds"][s] = row
                log(f"hash seed {s} ({row['seconds']} s): failure {row['failure']}; first loss "
                    f"{row['losses'] and row['losses'][0]}; largest ratio "
                    f"{json.dumps(row['largest'])}; F1/F2 backward from f64 "
                    f"{json.dumps(row['audit'])}")
                keep = os.path.join(tmp, f"keep_{s}.pt")
                if failing is None and os.path.exists(keep):
                    failing = (s, keep)
                elif os.path.exists(keep):
                    os.remove(keep)
        rows = summary["seeds"].values()
        ratios = sorted(r["largest"]["ratio_e"] for r in rows if r["largest"])
        summary["largest_ratios"] = ratios
        summary["failures"] = [s for s, r in summary["seeds"].items() if r["failure"]]
        log(f"sweep over hash seeds {first}-{last}: {len(summary['failures'])} failed "
            f"{summary['failures']}; largest error ratio a seed, sorted: "
            f"{[round(x, 3) for x in ratios]}")
        if failing is not None:
            s, keep = failing
            out = finish(start(s, "replay", keep))
            notes = out.get("notes", {})
            summary["replay"] = {
                "seed": s, "failure": out["failure"],
                "largest": [_largest_ratio(r) for r in notes.get("dropout0") or []],
                "audit": [_audit_summary(a) for a in notes.get("audit") or []]}
            log(f"replay of hash seed {s}'s dropout-0 inputs: {json.dumps(summary['replay'])}")
    with open(os.path.join(out_dir, "sweep.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0 if all(not (r["failure"] or "").startswith("error") for r in rows) else 1


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--worker":
        sys.exit(worker(*sys.argv[2:]))
    chip_smoke.pin_hash_seed()
    if len(sys.argv) not in (3, 4) or "-" not in sys.argv[1]:
        sys.exit(__doc__)
    lo, hi = (int(x) for x in sys.argv[1].split("-"))
    sys.exit(sweep(lo, hi, sys.argv[2], int(sys.argv[3]) if len(sys.argv) == 4 else 4))
