"""The reference's training recipe with optax's exact formulas, for PyTorch tensors.

Counterpart of ``projectiontrainer_tpu/train/optim.py`` for stages 0-2:

- ``cosine_schedule_with_warmup``: HF ``get_cosine_schedule_with_warmup`` semantics,
  warmup steps ``ceil(warmup_ratio * total_steps)`` (``floor`` on request);
- AdamW with torch's defaults (0.9 / 0.999 / 1e-8, weight decay 0.01), written as
  optax's ``adamw``: moments, bias correction with the incremented count, decay added
  to the update, learning rate ``schedule(count)`` of the update about to apply;
- global-norm clipping over the trainable leaves with optax's
  ``clip_by_global_norm`` formula: unchanged when ``norm < max_norm``, else
  ``g / norm * max_norm`` (not ``torch.nn.utils.clip_grad_norm_``'s ``+ 1e-6``);
  or stage 2's per-module clipping (``clip_per_module``), whose factor is
  ``min(1, max_norm / (norm + 1e-6))``;
- gradient accumulation as ``optax.MultiSteps``: a running mean of the micro-batch
  gradients, one update every ``accum_steps`` calls, nothing in between;
- frozen leaves (label ``frozen``) and integer leaves (a quantized base's codes) get
  no state and never change;
- a learning-rate schedule per label where JAX's ``masked_optimizer`` gives each
  label its own ``adamw`` (``discriminative_optimizer``: the cls probe's head and
  backbone at constant rates of their own).

Under tensor parallelism (``parallel/sharding.py``) each model rank holds a shard of
some leaves: the norms of the clip (``global_norm`` ``:55``, ``_clip`` ``:137`` of the
JAX package) sum a sharded leaf's squares over the model axis and count a replicated
leaf's once (``sharded_paths``), so every model rank clips by the same factor. Under
``--fsdp`` a leaf held as a data shard (``fsdp_paths``) has its squares summed over the
data axis, over both axes when the model axis splits it too; its moments and
accumulator are ``zeros_like`` of the shard, so the update stays local to it.

``MaskedAdamW.update`` updates the params IN PLACE (optax returns new arrays). Its
state is a plain dict of tensors keyed by parameter path, so ``torch.save`` stores
it and ``checkpoint/from_jax.py`` fills it from an optax state.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional, Union

import torch

from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths, unique_leaves_with_paths
from projectiontrainer_tpu_torch.parallel import distributed, fsdp
from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp
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


def sharded_global_norms(groups: Mapping[str, Mapping[str, torch.Tensor]],
                         sharded=frozenset(), data_sharded=frozenset()) -> dict:
    """{group: global norm} of groups of gradients keyed by path, the leaves at
    ``sharded`` paths holding one model rank's shard and those at ``data_sharded`` one
    data rank's (``--fsdp``): their squares summed over the axes that split them (one
    all-reduce an axis for every group), the replicated leaves' counted once. Without
    a split leaf, ``global_norm`` of each group."""
    model = sharded if tp.size() > 1 else frozenset()
    data = data_sharded if distributed.data_size() > 1 else frozenset()
    if not model and not data:
        return {k: global_norm(g.values()) for k, g in groups.items()}
    # per group: replicated, model-only, data-only, both
    parts = []
    for g in groups.values():
        zero = torch.zeros((), dtype=torch.float32, device=next(iter(g.values())).device)
        sums = [zero] * 4
        for p, x in g.items():
            i = (p in model) + 2 * (p in data)
            sums[i] = sums[i] + x.float().square().sum()
        parts.append(torch.stack(sums))
    parts = torch.stack(parts)  # [groups, 4]
    if model:
        parts[:, 1::2] = tp.all_reduce(parts[:, 1::2], "grads")
    if data:
        fsdp.COUNTS["grads"] += 1
        parts[:, 2:] = distributed.all_reduce_(parts[:, 2:].contiguous(),
                                               distributed.DATA_AXIS)
    return {k: torch.sqrt(s.sum()) for k, s in zip(groups, parts)}


class MaskedAdamW:
    """optax ``multi_transform({trainable: chain(clip, adamw), frozen: set_to_zero})``,
    wrapped in ``MultiSteps`` when ``accum_steps > 1``. ``schedule`` is one schedule
    for every trainable leaf, or a mapping label -> schedule (``multi_transform`` over
    one ``adamw`` a label, each at its own rate; every label trains at every update,
    so one Adam count serves them all). The clip is optax's
    ``clip_by_global_norm`` or, with ``clip_per_module``, the JAX package's
    ``clip_by_module_norm`` (each group of leaves under one first path segment,
    ``vision``, ``projector``, ``llm``, scaled by ``min(1, max_norm / (norm + 1e-6))``).

    Moments and the accumulator take each leaf's type, as optax's ``zeros_like`` does
    (fp32 masters: fp32 state; bf16 leaves: bf16 state), and each of optax's
    operations rounds to that type, as in JAX. A leaf held under two paths (the tied LM
    head) has one state, under its first path (``core/pytree.py``). ``sharded_paths``:
    the leaves that hold a model rank's shard (tensor parallelism), for the clip's
    norms; ``fsdp_paths``: those that hold a data rank's shard (``--fsdp``)."""

    def __init__(self, labels: Mapping,
                 schedule: Union[Callable[[int], float], Mapping[str, Callable[[int], float]]],
                 *, weight_decay: float = 0.01, clip_norm: Optional[float] = None,
                 clip_per_module: bool = False, accum_steps: int = 1, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, sharded_paths=frozenset(),
                 fsdp_paths=frozenset()):
        self.label_of = {p: label for p, label in leaves_with_paths(labels)
                         if label != M.FROZEN}
        self.trainable = list(self.label_of)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.clip_per_module = clip_per_module
        self.accum_steps = accum_steps
        self.b1, self.b2, self.eps = b1, b2, eps
        self.sharded_paths = frozenset(sharded_paths)
        self.fsdp_paths = frozenset(fsdp_paths)

    def init(self, params, carry: Optional[dict] = None) -> dict:
        """Zero state for the trainable leaves. ``carry`` (another ``MaskedAdamW``'s
        state) hands over its count and mini-step and each tensor whose path, shape and
        type are unchanged (``steps.swap_optimizer``)."""
        unique = {p for p, _ in unique_leaves_with_paths(params)}
        leaves = dict(leaves_with_paths(params))
        # integer leaves (quantized codes) never train: no moments, no accumulator (the
        # JAX package's float-safe MultiSteps keeps fp32 zeros for them instead)
        trainable = [p for p in self.trainable if p in unique and leaves[p].is_floating_point()]
        carry = carry or {}

        def slots(key):
            old = carry.get(key, {})
            out = {}
            for p in trainable:
                x, o = leaves[p], old.get(p)
                keep = o is not None and o.shape == x.shape and o.dtype == x.dtype
                out[p] = o if keep else torch.zeros_like(x)
            return out

        state = {"count": carry.get("count", 0), "mini_step": carry.get("mini_step", 0),
                 "mu": slots("mu"), "nu": slots("nu")}
        if self.accum_steps > 1:
            state["acc"] = slots("acc")
        return state

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: dict, params) -> bool:
        """Apply one micro-step's gradients (keyed by path; those of the leaves the
        state holds are read); returns whether the params changed (False between
        accumulation boundaries)."""
        trainable = list(state["mu"])
        if self.accum_steps > 1:
            n = state["mini_step"]
            for p in trainable:
                acc = state["acc"][p]
                acc.add_((grads[p].to(acc.dtype) - acc).div_(n + 1))
            if n < self.accum_steps - 1:
                state["mini_step"] = n + 1
                return False
            state["mini_step"] = 0
            grads = {p: state["acc"][p].clone() for p in trainable}
            for acc in state["acc"].values():
                acc.zero_()
        self._apply({p: grads[p] for p in trainable}, state, params)
        return True

    def _clip(self, grads: dict) -> dict:
        """Selected on the device: no host sync."""
        if not self.clip_per_module:
            norm = sharded_global_norms({"all": grads}, self.sharded_paths,
                                        self.fsdp_paths)["all"]
            keep = norm < self.clip_norm
            return {p: torch.where(keep, g.float(), g.float() / norm * self.clip_norm)
                    for p, g in grads.items()}
        groups: dict = {}
        for p, g in grads.items():
            groups.setdefault(p.split("/", 1)[0], {})[p] = g
        factor = {k: torch.clamp(self.clip_norm / (norm + 1e-6), max=1.0)
                  for k, norm in sharded_global_norms(groups, self.sharded_paths,
                                                     self.fsdp_paths).items()}
        return {p: (g.float() * factor[p.split("/", 1)[0]]).to(g.dtype)
                for p, g in grads.items()}

    def _apply(self, grads: dict, state: dict, params) -> None:
        if self.clip_norm is not None:
            grads = self._clip(grads)
        per_label = isinstance(self.schedule, Mapping)
        lrs = ({label: s(state["count"]) for label, s in self.schedule.items()} if per_label
               else {None: self.schedule(state["count"])})
        state["count"] += 1
        t = state["count"]
        leaves = dict(leaves_with_paths(params))
        consts = {}
        for p, g in grads.items():
            mu, nu, x = state["mu"][p], state["nu"][p], leaves[p]
            key = (mu.dtype, self.label_of[p] if per_label else None)
            if key not in consts:
                consts[key] = _constants(
                    mu.dtype, b1=self.b1, omb1=1 - self.b1, b2=self.b2, omb2=1 - self.b2,
                    c1=1 - self.b1 ** t, c2=1 - self.b2 ** t, eps=self.eps,
                    wd=self.weight_decay, neg_lr=-lrs[key[1]])
            k = consts[key]
            g = g.to(mu.dtype)
            if mu.dtype == torch.float32:  # fused forms: fewer passes, fp32 all the same
                mu.mul_(k["b1"]).add_(g, alpha=k["omb1"])
                nu.mul_(k["b2"]).addcmul_(g, g, value=k["omb2"])
            else:  # optax rounds each product and the sum to the leaf's type
                mu.mul_(k["b1"]).add_(k["omb1"] * g)
                nu.mul_(k["b2"]).add_(k["omb2"] * (g * g))
            u = (mu / k["c1"]).div_((nu / k["c2"]).sqrt_().add_(k["eps"]))
            u.add_(k["wd"] * x)
            x.add_(u.mul_(k["neg_lr"]))


def _constants(dtype, **values) -> dict:
    """optax's scalars as they meet a leaf of ``dtype``: JAX rounds a Python float to
    the array's type before the operation (0.1 becomes 0.10009765625 in bf16), so for
    a reduced-precision leaf they are 0-dim tensors of that type; in fp32 the floats
    themselves, which torch also applies in fp32."""
    if dtype == torch.float32:
        return values
    return {k: torch.tensor(v, dtype=torch.float32).to(dtype) for k, v in values.items()}


def single_group_optimizer(labels: Mapping, lr: float, *, total_steps: int,
                           warmup_ratio: float = 0.0, weight_decay: float = 0.01,
                           clip_norm: Optional[float] = None, clip_per_module: bool = False,
                           accum_steps: int = 1, warmup_rounding: str = "ceil",
                           sharded_paths=frozenset(), fsdp_paths=frozenset()):
    """One trainable group + frozen rest -> (tx, schedule)."""
    schedule = cosine_schedule_with_warmup(lr, warmup_ratio=warmup_ratio,
                                           total_steps=total_steps,
                                           warmup_rounding=warmup_rounding)
    tx = MaskedAdamW(labels, schedule, weight_decay=weight_decay, clip_norm=clip_norm,
                     clip_per_module=clip_per_module, accum_steps=accum_steps,
                     sharded_paths=sharded_paths, fsdp_paths=fsdp_paths)
    return tx, schedule


def discriminative_optimizer(labels: Mapping, *, head_lr: float, backbone_lr: float,
                             weight_decay: float = 0.01, accum_steps: int = 1,
                             fsdp_paths=frozenset()):
    """cls_evaluate's discriminative-LR AdamW: the ``head`` label at ``head_lr``, the
    ``backbone`` label at ``backbone_lr`` (reference: cls_evaluate/train_utils.py:219-259).
    Both rates are CONSTANT: the reference builds AdamW with no scheduler and never
    steps one (:257-261), so there is no horizon (JAX's ``total_steps``) to give.
    Returns (tx, the head's schedule)."""
    schedules = {M.HEAD: lambda step: head_lr, M.BACKBONE: lambda step: backbone_lr}
    tx = MaskedAdamW(labels, schedules, weight_decay=weight_decay, accum_steps=accum_steps,
                     fsdp_paths=fsdp_paths)
    return tx, schedules[M.HEAD]
