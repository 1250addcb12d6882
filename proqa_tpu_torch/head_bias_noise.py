"""Where the retriever's f32 context-head bias gradient parts between the CPU
and the card.

`proj_c.bias`'s gradient is zero in exact arithmetic: a constant added to
every context embedding moves each query's in-batch scores alike, so the
softmax's loss does not change. What a train step gives there is rounding
noise, and tests/test_torch_cuda.py::test_train_step_on_gpu_matches_cpu holds
it, on each device and between the two, to ZERO_GRAD_ULPS units of f32
rounding of the CPU's column sums of |dout| (proqa_tpu_torch/testing.py).
This script takes that
test's step (tiny f32 retriever, dropout 0, remat, K2/K3 on and off) on the
CPU, on the card's kernel route and on the card's plain chain
(fused_bert._eager_chain), records the gradient that reaches `proj_c`'s
output (dout, [8, 128] f32) and its bias gradient, and prints for each route
on the card:

- `bias_vs_cpu`: the largest |bias gradient - the CPU's|, what the test reads;
- `exact_vs_cpu`: the same for dout's column sum taken exactly (in f64, one
  rounding to f32): the nearest any order of summing this dout can come;
- `dout_vs_cpu`: the largest |dout - the CPU's dout|;
- `exact_dout_sums_apart`: |exact column sum of dout - that of the CPU's|;
- `ratio_cpu`, `ratio`, `ratio_vs_cpu`: the CPU's bias gradient, this
  route's and their difference, in those units (the test's limit is
  ZERO_GRAD_ULPS).

    python -m proqa_tpu_torch.head_bias_noise

Needs a CUDA device; prints one JSON object.
"""
from __future__ import annotations

import json

import torch

from proqa_tpu_torch.models.bert import BertConfig
from proqa_tpu_torch.models.retriever import Retriever
from proqa_tpu_torch.ops import fused_bert
from proqa_tpu_torch.testing import zero_grad_ratio, zero_grad_unit
from proqa_tpu_torch.train.retriever_trainer import in_batch_loss


def _step(cfg: BertConfig, batch: dict, device: str, eager: bool) -> tuple:
    """(dout at proj_c's output, proj_c.bias's gradient), both on the CPU."""
    model = Retriever(cfg).reset_parameters(0).to(device).train()
    seen = {}

    def keep_dout(module, args, out):
        out.register_hook(lambda grad: seen.__setitem__("dout", grad.detach().cpu()))

    model.proj_c.register_forward_hook(keep_dout)
    on_device = {k: v.to(device) for k, v in batch.items()}
    with fused_bert._eager_chain() if eager else torch.enable_grad():
        loss, _ = in_batch_loss(model(on_device, generator=torch.Generator().manual_seed(0)))
        loss.backward()
    return seen["dout"], model.proj_c.bias.grad.detach().cpu()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("head_bias_noise needs a CUDA device")
    g = torch.Generator().manual_seed(4)
    batch = {"input_ids_q": torch.randint(5, 128, (8, 16), generator=g),
             "input_ids_c": torch.randint(5, 128, (8, 128), generator=g),
             "input_mask_q": torch.ones(8, 16, dtype=torch.int32)}
    batch["input_mask_c"] = (torch.arange(128)[None] < torch.arange(60, 124, 8)[:, None]).int()
    report = {}
    for flash in (True, False):
        cfg = BertConfig.tiny(dtype=torch.float32, max_position_embeddings=128,
                              flash_attention=flash, hidden_dropout=0.0, attention_dropout=0.0,
                              remat=True)
        dout_c, bias_c = _step(cfg, batch, "cpu", eager=False)
        unit = zero_grad_unit(dout_c)
        for route, eager in (("kernels", False), ("eager_chain", True)):
            dout, bias = _step(cfg, batch, "cuda:0", eager)
            exact = dout.double().sum(0)
            report[f"flash={flash} {route}"] = {
                "bias_vs_cpu": (bias - bias_c).abs().max().item(),
                "exact_vs_cpu": (exact.float() - bias_c).abs().max().item(),
                "dout_vs_cpu": (dout - dout_c).abs().max().item(),
                "exact_dout_sums_apart": (exact - dout_c.double().sum(0)).abs().max().item(),
                "cpu_bias_max": bias_c.abs().max().item(),
                "ratio_cpu": zero_grad_ratio(bias_c, unit),
                "ratio": zero_grad_ratio(bias, unit),
                "ratio_vs_cpu": zero_grad_ratio(bias - bias_c, unit)}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
