"""AdamW and the train state, written to optax's semantics.

Counterpart of proqa_tpu/train/optim.py (:39-99), whose optax chain is, in
order: clip_by_global_norm, scale_by_adam, add_decayed_weights (masked off
biases and LayerNorm), scale_by_learning_rate with an optional linear warmup
then linear decay. The port writes that chain as a plain loop over tensors,
operation for operation:
  - clipping: where(norm < max_norm, g, (g / norm) * max_norm), with no 1e-6
    added to the norm (torch.nn.utils.clip_grad_norm_ adds one;
    docs/MIGRATION.md, "Optimization");
  - Adam: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, bias correction
    by 1 - b^t, then mu_hat / (sqrt(nu_hat) + eps), eps after the correction;
  - decoupled weight decay: + wd * param where the decay mask is true;
  - update * -lr(t) with t the step count before this update, then added to
    the parameters in place (the port updates the model's tensors in place
    to keep one copy of the weights).
"""
from __future__ import annotations

import dataclasses

import torch

_NO_DECAY_KEYS = ("bias", "scale", "ln", "attn_ln", "mlp_ln")


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    max_grad_norm: float = 5.0
    adam_eps: float = 1e-8
    b1: float = 0.9
    b2: float = 0.999
    warmup_steps: int = 0
    total_steps: int | None = None

    def lr(self, count: int) -> float:
        """optax.join_schedules of linear_schedule(0, peak, warmup) and
        linear_schedule(peak, 0, total - warmup) (or a constant peak)."""
        peak = self.learning_rate
        if count < self.warmup_steps:
            return _linear(0.0, peak, self.warmup_steps, count)
        count -= self.warmup_steps
        if self.total_steps:
            return _linear(peak, 0.0, max(self.total_steps - self.warmup_steps, 1), count)
        return peak


def _linear(init: float, end: float, steps: int, count: int) -> float:
    count = min(max(count, 0), steps)
    return (init - end) * (1 - count / steps) + end


@dataclasses.dataclass
class TrainState:
    """step, parameters by name, and Adam's moments ({"mu": {...}, "nu": {...}})."""
    step: int
    params: dict[str, torch.Tensor]
    opt_state: dict[str, dict[str, torch.Tensor]]


def decays(name: str) -> bool:
    """True where weight decay applies: the JAX package's _no_decay_mask on a
    dotted parameter name (bias, LayerNorm scale and bias are excluded)."""
    return not any(key in _NO_DECAY_KEYS for key in name.split("."))


def init_train_state(params: dict[str, torch.Tensor]) -> TrainState:
    zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                     for k, p in params.items()}
    return TrainState(step=0, params=params, opt_state={"mu": zeros(), "nu": zeros()})


@torch.no_grad()
def apply_gradients(state: TrainState, grads: dict[str, torch.Tensor], tx: AdamW) -> TrainState:
    """One optimizer step: updates the parameters and moments in place and
    returns the state with its step advanced."""
    norm = torch.sqrt(torch.stack([g.float().square().sum() for g in grads.values()]).sum())
    clip = norm < tx.max_grad_norm
    count = state.step + 1
    correct1, correct2 = 1 - tx.b1 ** count, 1 - tx.b2 ** count
    lr = tx.lr(state.step)
    for name, p in state.params.items():
        g = grads[name].float()
        g = torch.where(clip, g, (g / norm) * tx.max_grad_norm)
        mu, nu = state.opt_state["mu"][name], state.opt_state["nu"][name]
        mu.copy_((1 - tx.b1) * g + tx.b1 * mu)
        nu.copy_((1 - tx.b2) * g.square() + tx.b2 * nu)
        update = (mu / correct1) / (torch.sqrt(nu / correct2) + tx.adam_eps)
        if tx.weight_decay and decays(name):
            update = update + tx.weight_decay * p
        p.add_(-lr * update)
    state.step = count
    return state
