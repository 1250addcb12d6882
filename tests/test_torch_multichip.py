"""The multi-card check (proqa_tpu_torch/multichip.py) rehearsed on the CPU
at small sizes: the search sharded over [cpu] * 4 equal to the unsharded
index's, the mesh encode equal to the one-device encode, and a torchrun
launch of 4 gloo ranks (the environment rendezvous the CLI's
data-parallel runs join) within its bounds of one process."""
import json

import pytest

pytest.importorskip("torch")


def test_multichip_rehearsal_on_the_cpu(tmp_path):
    from proqa_tpu_torch import multichip

    out = tmp_path / "multichip.json"
    assert multichip.main(["--device", "cpu", "--tiny", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["device"]["mesh"] == ["cpu"] * 4
    for kind in ("bf16", "int8"):
        assert res["search"][kind]["disagreements"] == 0
    assert res["encode"]["max_abs_diff"] <= 1e-5
    ddp = res["ddp"]
    assert (ddp["ranks"], ddp["backend"]) == (4, "gloo")
    assert ddp["loss_max_abs_err"] <= 1e-4 and ddp["param_max_abs_err"] <= 2 * multichip.LR
