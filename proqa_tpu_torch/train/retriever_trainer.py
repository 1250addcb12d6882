"""Retriever contrastive pretraining: the train and eval steps and the outer
loop (eval period, early stopping, checkpoints, resume).

Counterpart of proqa_tpu/train/retriever_trainer.py, on one device:
* a train step: both towers in training mode (dropout seeds drawn from the
  trainer's torch.Generator), in-batch-negative cross entropy over f32
  q c^T with target = the diagonal, backward, AdamW (train/optim.py);
* gradient accumulation over microbatches, negatives staying within each
  microbatch: the gradients of the microbatches are summed and divided by
  their number, as the JAX step's scan does;
* an eval step that is deterministic (eval mode, no dropout);
* RetrieverTrainer with the JAX trainer's eval, early-stop (wait >=
  wait_step), checkpoint (best / last / every N steps) and resume
  bookkeeping, including the trainer_meta.json pairing of train/meta.py.
f32 matrix products stay in full f32 (pin_f32_precision): from-scratch
contrastive training collapsed under lowered f32 precision on the TPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from proqa_tpu_torch.models.bert import BertConfig, init_parameters
from proqa_tpu_torch.models.retriever import Retriever
from proqa_tpu_torch.ops.dot import pin_f32_precision
from proqa_tpu_torch.train import checkpoint as ckpt
from proqa_tpu_torch.train.meta import read_trainer_meta, write_trainer_meta
from proqa_tpu_torch.train.optim import AdamW, TrainState, apply_gradients, init_train_state
from proqa_tpu_torch.utils.logging import AverageMeter, MetricLogger, setup_logger
from proqa_tpu_torch.utils.profiling import StepTimer, TraceWindow


def in_batch_loss(out: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Contrastive CE over in-batch negatives; returns (loss, accuracy)."""
    product = out["q"].float() @ out["c"].float().T
    logprobs = torch.log_softmax(product, dim=-1)
    loss = -torch.diagonal(logprobs).mean()
    target = torch.arange(product.shape[0], device=product.device)
    acc = (product.argmax(dim=-1) == target).float().mean()
    return loss, acc


def train_step(model: Retriever, state: TrainState, tx: AdamW, batch: dict,
               generator: torch.Generator, accum_steps: int = 1):
    """One optimizer step on `batch` (tensors on the model's device, leading
    dim accum_steps * micro); returns (state, {"loss", "acc"}) with device
    scalars."""
    model.train()
    for p in state.params.values():
        p.grad = None
    micro = next(iter(batch.values())).shape[0] // accum_steps
    lsum = asum = 0.0
    for i in range(accum_steps):
        mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
        loss, acc = in_batch_loss(model(mb, generator=generator))
        loss.backward()
        lsum, asum = lsum + loss.detach(), asum + acc
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) / accum_steps
             for k, p in state.params.items()}
    state = apply_gradients(state, grads, tx)
    for p in state.params.values():
        p.grad = None
    return state, {"loss": lsum / accum_steps, "acc": asum / accum_steps}


@torch.no_grad()
def eval_step(model: Retriever, batch: dict) -> torch.Tensor:
    """Per-row hit of the in-batch argmax (bool [B])."""
    model.eval()
    out = model(batch)
    product = out["q"] @ out["c"].T
    return product.argmax(dim=-1) == torch.arange(product.shape[0], device=product.device)


@dataclass
class RetrieverTrainerConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    max_grad_norm: float = 5.0
    adam_eps: float = 1e-8
    accumulate_gradients: int = 1
    num_train_epochs: int = 100
    eval_period: int = 2500        # <= 0: eval at epoch end only
    save_checkpoints_steps: int = 20000  # <= 0: no periodic step checkpoints
    wait_step: int = 100
    warmup_steps: int = 0
    total_steps: int | None = None
    seed: int = 3
    output_dir: str = "logs/retriever"
    profile_dir: str = ""   # torch.profiler trace of a few warm steps here
    profile_steps: int = 3


class RetrieverTrainer:
    """Outer training loop with eval-driven early stopping and checkpoints
    (best / last / periodic, full-state resume), on one device."""

    def __init__(self, bert_cfg: BertConfig, tcfg: RetrieverTrainerConfig, *,
                 params: dict | None = None, device: str | torch.device = "cuda"):
        pin_f32_precision()
        self.cfg = bert_cfg
        self.tcfg = tcfg
        self.device = torch.device(device)
        self.logger = setup_logger("proqa_torch.retriever", f"{tcfg.output_dir}/log.txt")
        self.metrics = MetricLogger(f"{tcfg.output_dir}/metrics.jsonl")
        # one generator: initial weights first, then every dropout seed
        self.generator = torch.Generator().manual_seed(tcfg.seed)
        self.model = Retriever(bert_cfg)
        if params is None:
            init_parameters(self.model, bert_cfg.initializer_range, self.generator)
        else:
            self.model.load_state_dict(params)
        self.model.to(self.device)
        self.tx = AdamW(
            learning_rate=tcfg.learning_rate, weight_decay=tcfg.weight_decay,
            max_grad_norm=tcfg.max_grad_norm, adam_eps=tcfg.adam_eps,
            warmup_steps=tcfg.warmup_steps, total_steps=tcfg.total_steps,
        )
        self.state = init_train_state(dict(self.model.named_parameters()))
        self._resume_meta: dict = {}

    # ------------- checkpoint plumbing -------------

    def save(self, name: str) -> None:
        ckpt.save_checkpoint(f"{self.tcfg.output_dir}/{name}{ckpt.SUFFIX}", self.state)

    def _write_meta(self, best_acc: float, wait: int, epoch: int) -> None:
        write_trainer_meta(self.tcfg.output_dir, "best_acc", best_acc, wait, epoch)

    @torch.no_grad()
    def resume(self, path: str) -> None:
        loaded = ckpt.load_checkpoint(path)
        for name, p in self.state.params.items():
            p.copy_(loaded.params[name])
        for moment in ("mu", "nu"):
            for name, m in self.state.opt_state[moment].items():
                m.copy_(loaded.opt_state[moment][name])
        self.state.step = loaded.step
        self._resume_meta = read_trainer_meta(path)
        self.logger.info(
            f"resumed from {path} at step {self.state.step}"
            + (f" with loop progress {self._resume_meta}" if self._resume_meta else "")
        )

    # ------------- steps -------------

    def device_batch(self, batch: dict) -> dict:
        """numpy batch -> tensors on the device (token ids as int64)."""
        out = {}
        for k, v in batch.items():
            if k.startswith("__"):
                continue
            t = torch.from_numpy(np.asarray(v))
            out[k] = t.to(self.device, torch.int64 if k.startswith("input_ids") else torch.int32)
        return out

    def step(self, batch: dict) -> dict:
        """One train step on a numpy batch; returns {"loss", "acc"} as device
        scalars."""
        self.state, m = train_step(self.model, self.state, self.tx, self.device_batch(batch),
                                   self.generator, self.tcfg.accumulate_gradients)
        return m

    def evaluate(self, eval_batches) -> float:
        correct = total = 0
        for batch in eval_batches:
            rows = batch.pop("__rows__", None)
            res = eval_step(self.model, self.device_batch(batch)).cpu().numpy()
            if rows is not None:
                res = res[:rows]
            correct += int(res.sum())
            total += len(res)
        return correct / max(total, 1)

    # ------------- loop -------------

    def train(self, train_batches_fn, eval_batches_fn) -> float:
        """train_batches_fn(epoch) -> iterator of collated numpy batches;
        eval_batches_fn() -> iterator. Returns the best eval accuracy."""
        t = self.tcfg
        meta = self._resume_meta
        best_acc = float(meta.get("best_acc", 0.0))
        wait = int(meta.get("wait", 0))
        start_epoch = int(meta.get("epoch", 0))
        stop = False
        meter = AverageMeter()
        timer = StepTimer(device=self.device)
        tracer = TraceWindow(t.profile_dir, steps=t.profile_steps, logger=self.logger)
        last_saved_step = -1  # state.step at the latest checkpoint_last write

        def run_eval(epoch: int) -> None:
            nonlocal best_acc, wait, stop, last_saved_step
            step = self.state.step
            acc = self.evaluate(eval_batches_fn())
            ts = timer.summary()
            self.logger.info(
                f"Step {step} Train loss {meter.avg:.2f} Acc {acc*100:.2f} "
                f"epoch={epoch} {ts.get('steps_per_s', 0):.2f} steps/s"
            )
            self.metrics.scalar("dev_acc", acc * 100, step)
            if ts:
                self.metrics.scalar("step_p50_ms", ts["p50_s"] * 1e3, step)
                self.metrics.scalar("steps_per_s", ts["steps_per_s"], step)
            self.save("checkpoint_last")
            last_saved_step = step
            if acc > best_acc:
                self.save("checkpoint_best")
                best_acc, wait = acc, 0
            else:
                wait += 1
                # >= not ==: a resume can restore wait already at wait_step
                if wait >= t.wait_step:
                    stop = True

        for epoch in range(start_epoch, t.num_train_epochs):
            for batch in train_batches_fn(epoch):
                tracer.tick()
                rows = batch.pop("__rows__", None)
                # a padded train batch duplicates rows and corrupts in-batch
                # negatives: callers build train batches with drop_last=True
                if rows is not None and rows != len(batch["input_ids_q"]):
                    raise ValueError(f"padded train batch ({rows} real rows): build train "
                                     "batches with drop_last=True")
                with timer:
                    m = self.step(batch)
                    loss = float(m["loss"])
                step = self.state.step
                meter.update(loss)
                self.metrics.scalar("train_loss", loss, step)
                self.metrics.scalar("smoothed_train_loss", meter.avg, step)

                if t.save_checkpoints_steps > 0 and step % t.save_checkpoints_steps == 0:
                    self.save(f"checkpoint_{step}")
                if t.eval_period > 0 and step % t.eval_period == 0:
                    run_eval(epoch)
                    # meta before any early-stop break (train/meta.py)
                    self._write_meta(best_acc, wait, epoch)
                    if stop:
                        break
            if not stop and t.eval_period <= 0:
                run_eval(epoch)
            # epoch end: a fresh checkpoint_last paired with the next epoch
            if self.state.step != last_saved_step:
                self.save("checkpoint_last")
            self._write_meta(best_acc, wait, epoch + 1)
            if stop:
                break
        tracer.close()
        ts = timer.summary()
        if ts:
            self.metrics.scalar("step_p50_ms", ts["p50_s"] * 1e3, self.state.step)
            self.metrics.scalar("steps_per_s", ts["steps_per_s"], self.state.step)
        self.logger.info("Training finished!")
        return best_acc
