"""The reference's training recipe with optax's exact formulas, for PyTorch tensors.

Counterpart of ``projectiontrainer_tpu/train/optim.py`` for stage 1:

- ``cosine_schedule_with_warmup``: HF ``get_cosine_schedule_with_warmup`` semantics,
  warmup steps ``ceil(warmup_ratio * total_steps)`` (``floor`` on request);
- AdamW with torch's defaults (0.9 / 0.999 / 1e-8, weight decay 0.01), written as
  optax's ``adamw``: moments, bias correction with the incremented count, decay added
  to the update, learning rate ``schedule(count)`` of the update about to apply;
- global-norm clipping over the trainable leaves with optax's
  ``clip_by_global_norm`` formula: unchanged when ``norm < max_norm``, else
  ``g / norm * max_norm`` (not ``torch.nn.utils.clip_grad_norm_``'s ``+ 1e-6``);
- gradient accumulation as ``optax.MultiSteps``: a running mean of the micro-batch
  gradients, one update every ``accum_steps`` calls, nothing in between;
- frozen leaves (label ``frozen``) get no state and never change.

``MaskedAdamW.update`` updates the params IN PLACE (optax returns new arrays). Its
state is a plain dict of tensors keyed by parameter path, so ``torch.save`` stores
it and ``checkpoint/from_jax.py`` fills it from an optax state.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional

import torch

from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths
from projectiontrainer_tpu_torch.train import masks as M


def cosine_schedule_with_warmup(base_lr: float, *, warmup_ratio: float, total_steps: int,
                                num_cycles: float = 0.5,
                                warmup_rounding: str = "ceil") -> Callable[[int], float]:
    rounding = {"ceil": math.ceil, "floor": math.floor}[warmup_rounding]
    warmup_steps = rounding(warmup_ratio * total_steps)

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return base_lr * step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * 2.0 * num_cycles * progress)))

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class MaskedAdamW:
    """optax ``multi_transform({trainable: chain(clip_by_global_norm, adamw),
    frozen: set_to_zero})``, wrapped in ``MultiSteps`` when ``accum_steps > 1``."""

    def __init__(self, labels: Mapping, schedule: Callable[[int], float], *,
                 weight_decay: float = 0.01, clip_norm: Optional[float] = None,
                 accum_steps: int = 1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.trainable = [p for p, label in leaves_with_paths(labels) if label != M.FROZEN]
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.accum_steps = accum_steps
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> dict:
        leaves = dict(leaves_with_paths(params))
        zeros = lambda: {p: torch.zeros_like(leaves[p], dtype=torch.float32)  # noqa: E731
                         for p in self.trainable}
        state = {"count": 0, "mini_step": 0, "mu": zeros(), "nu": zeros()}
        if self.accum_steps > 1:
            state["acc"] = zeros()
        return state

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: dict, params) -> bool:
        """Apply one micro-step's gradients (keyed by path, trainable leaves only);
        returns whether the params changed (False between accumulation boundaries)."""
        if self.accum_steps > 1:
            n = state["mini_step"]
            for p in self.trainable:
                acc = state["acc"][p]
                acc.add_((grads[p].float() - acc) / (n + 1))
            if n < self.accum_steps - 1:
                state["mini_step"] = n + 1
                return False
            state["mini_step"] = 0
            grads = {p: state["acc"][p].clone() for p in self.trainable}
            for acc in state["acc"].values():
                acc.zero_()
        self._apply({p: grads[p].float() for p in self.trainable}, state, params)
        return True

    def _apply(self, grads: dict, state: dict, params) -> None:
        if self.clip_norm is not None:  # selected on the device: no host sync
            norm = global_norm(grads.values())
            keep = norm < self.clip_norm
            grads = {p: torch.where(keep, g, g / norm * self.clip_norm)
                     for p, g in grads.items()}
        lr = self.schedule(state["count"])
        state["count"] += 1
        t = state["count"]
        leaves = dict(leaves_with_paths(params))
        for p, g in grads.items():
            mu, nu, x = state["mu"][p], state["nu"][p], leaves[p]
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            mu_hat = mu / (1 - self.b1 ** t)
            nu_hat = nu / (1 - self.b2 ** t)
            u = mu_hat / (nu_hat.sqrt() + self.eps) + self.weight_decay * x.float()
            x.copy_((x.float() - lr * u).to(x.dtype))


def single_group_optimizer(labels: Mapping, lr: float, *, total_steps: int,
                           warmup_ratio: float = 0.0, weight_decay: float = 0.01,
                           clip_norm: Optional[float] = None, accum_steps: int = 1,
                           warmup_rounding: str = "ceil"):
    """One trainable group + frozen rest -> (tx, schedule)."""
    schedule = cosine_schedule_with_warmup(lr, warmup_ratio=warmup_ratio,
                                           total_steps=total_steps,
                                           warmup_rounding=warmup_rounding)
    tx = MaskedAdamW(labels, schedule, weight_decay=weight_decay, clip_norm=clip_norm,
                     accum_steps=accum_steps)
    return tx, schedule
