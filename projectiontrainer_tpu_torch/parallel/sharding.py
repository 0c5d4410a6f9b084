"""Parameter sharding over the model axis of the data x model mesh.

Counterpart of ``projectiontrainer_tpu/parallel/sharding.py``: the same rules (a regex
over '/'-joined leaf paths -> a spec naming the dim that the model axis splits; first
match wins; no match is replicated), with each 2-D spec of a linear leaf transposed to
the port's ``[out, in]`` layout (the quantized leaves' too, ``ops/quant.py``; the
embedding tables are ``[V, D]`` in both packages and keep their spec):

- q/k/v, gate/up, the towers' q/k/v and fc1, the projector's fc1: output rows;
- o/down, the towers' out_proj and fc2, the projector's fc2: input columns;
- the embedding table and the LM head: the vocab; LoRA's ``b`` of a column target and
  ``a`` of a row target, with the base.

Where GSPMD lets the JAX package shard anything and gather as it goes, the port's
explicit Megatron collectives (``parallel/tensor_parallel.py``) need the shards to
compose, so two deliberate divergences:

- a leaf whose sharded dim the model axis does not divide raises (the JAX package
  quietly replicates it, ``_divisible`` / ``param_shardings``): a replicated ``q_proj``
  beside a sharded ``o_proj`` cannot compose; so do head counts, KV head counts
  (unless one), intermediate sizes and a vocab that the model axis does not divide
  (:func:`check_config`);
- a single KV head stays replicated (``rules_for``): the k/v projections, their LoRA
  adapters and quantized leaves; the flash kernels then run every rank's query heads
  against the one head (``ops/flash_attention.sharded_flash_plan``).

A :class:`ShardPlan` says, for a params tree, which leaves are sharded on which dim and
which replicated leaves get a PARTIAL gradient on each model rank because they act on
sharded activations (the q/k RMSNorm scales, a column-parallel bias, the k/v projections
of a single KV head, LoRA's ``a`` of a column target and ``b`` of a row target): the
train step sums those over the model axis (``train/steps.py``), and the norms count a
sharded leaf's squares over the model axis and a replicated leaf's once
(``train/optim.py``). :func:`shard_params` slices a full tree to a rank's shards,
:func:`gather_params` is its inverse (a collective; the checkpoints' writes).

``_with_fsdp_axis`` and ``FSDP_MIN_SIZE`` (ZeRO-3 over the data axis) come with the
``--fsdp`` slice.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Mapping, Optional, Sequence

import torch

from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths, map_with_path
from projectiontrainer_tpu_torch.parallel import distributed
from projectiontrainer_tpu_torch.utils.timing import span

MODEL_AXIS = distributed.MODEL_AXIS
_Q = "weight|qvalues|qvalues_block|packed_nf4|block_scales"

# (pattern, spec): the JAX package's DEFAULT_RULES in order, 'kernel' read as 'weight'
# and a linear leaf's 2-D spec transposed
DEFAULT_RULES: Sequence[tuple[str, tuple]] = (
    (rf"attn/(q_proj|k_proj|v_proj)/({_Q})$", (MODEL_AXIS, None)),
    (r"attn/(q_proj|k_proj|v_proj)/scales$", (MODEL_AXIS,)),
    (rf"attn/o_proj/({_Q})$", (None, MODEL_AXIS)),
    (rf"mlp/(gate_proj|up_proj)/({_Q})$", (MODEL_AXIS, None)),
    (r"mlp/(gate_proj|up_proj)/scales$", (MODEL_AXIS,)),
    (rf"mlp/down_proj/({_Q})$", (None, MODEL_AXIS)),
    (r"embed_tokens/embedding$", (MODEL_AXIS, None)),
    (r"lm_head/weight$", (MODEL_AXIS, None)),
    (r"lora/.*(q_proj|k_proj|v_proj|gate_proj|up_proj)/b$", (MODEL_AXIS, None)),
    (r"lora/.*(o_proj|down_proj)/a$", (None, MODEL_AXIS)),
    (r"attn/(q_proj|k_proj|v_proj)/weight$", (MODEL_AXIS, None)),
    (r"attn/out_proj/weight$", (None, MODEL_AXIS)),
    (r"(mlp|head)/fc1/weight$", (MODEL_AXIS, None)),
    (r"(mlp|head)/fc2/weight$", (None, MODEL_AXIS)),
    (r"projector/fc1/weight$", (MODEL_AXIS, None)),
    (r"projector/fc2/weight$", (None, MODEL_AXIS)),
    (r"token_embedding/embedding$", (MODEL_AXIS, None)),
)

# a single KV head is replicated (ahead of DEFAULT_RULES)
SINGLE_KV_HEAD_RULES: Sequence[tuple[str, tuple]] = (
    (r"^llm/layers/\d+/attn/(k_proj|v_proj)/", ()),
    (r"^lora/layers/\d+/(k_proj|v_proj)/", ()),
)

# replicated leaves whose gradient is partial on each model rank
PARTIAL_GRADS: Sequence[str] = (
    r"attn/(q_norm|k_norm)/scale$",
    r"attn/(q_proj|k_proj|v_proj)/bias$",
    r"mlp/(gate_proj|up_proj)/bias$",
    r"(mlp|head)/fc1/bias$",
    r"projector/fc1/bias$",
    r"^lora/.*(q_proj|k_proj|v_proj|gate_proj|up_proj)/a$",
    r"^lora/.*(o_proj|down_proj)/b$",
)
SINGLE_KV_HEAD_PARTIAL: Sequence[str] = (
    r"^llm/layers/\d+/attn/(k_proj|v_proj)/(weight|bias)$",
    r"^lora/layers/\d+/(k_proj|v_proj)/b$",
)


def spec_for_path(path: str, rules: Sequence[tuple[str, tuple]] = DEFAULT_RULES) -> tuple:
    """The spec of the first rule whose pattern ``re.search``-es ``path``; () replicated."""
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return ()


def sharded_dim(path: str, rules: Sequence[tuple[str, tuple]] = DEFAULT_RULES) -> Optional[int]:
    """The dim the model axis splits at ``path``, or None (replicated)."""
    spec = spec_for_path(path, rules)
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def rules_for(vlm_cfg=None) -> tuple[tuple, tuple]:
    """(sharding rules, partial-gradient patterns) for a VLM (or decoder) config: the
    defaults, with a single KV head replicated."""
    llm = getattr(vlm_cfg, "llm", vlm_cfg)
    if llm is not None and llm.num_kv_heads == 1:
        return (tuple(SINGLE_KV_HEAD_RULES) + tuple(DEFAULT_RULES),
                tuple(PARTIAL_GRADS) + tuple(SINGLE_KV_HEAD_PARTIAL))
    return tuple(DEFAULT_RULES), tuple(PARTIAL_GRADS)


def _divide(what: str, n: int, model: int) -> None:
    if n % model:
        raise ValueError(f"tensor parallel: {what} ({n}) does not divide over {model} model "
                         "ranks")


def check_config(vlm_cfg, model: int) -> None:
    """Raise for a model whose heads, KV heads (unless one), intermediate sizes or vocab
    the model axis does not divide (the JAX package would replicate what does not
    divide; explicit TP cannot)."""
    if model == 1:
        return
    from projectiontrainer_tpu_torch.ops.flash_attention import sharded_flash_plan

    llm = getattr(vlm_cfg, "llm", vlm_cfg)
    sharded_flash_plan(llm.num_heads, llm.num_kv_heads, model)
    _divide("the decoder's intermediate size", llm.intermediate_size, model)
    _divide("the vocab", llm.vocab_size, model)
    vision = getattr(vlm_cfg, "vision", None)
    if vision is not None:
        _divide("the vision tower's heads", vision.num_heads, model)
        _divide("the vision tower's intermediate size", vision.intermediate_size, model)
    projector = getattr(vlm_cfg, "projector", None)
    if projector is not None:
        _divide("the projector's intermediate size", projector.intermediate_dim, model)


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Which leaves of a params tree the model axis splits (path -> dim) and which
    replicated leaves get partial gradients, for model rank ``rank`` of ``model``."""

    model: int
    rank: int
    dims: Mapping[str, int]
    partial: frozenset

    @property
    def sharded(self) -> frozenset:
        return frozenset(self.dims)

    def shard(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """The rank's block of the full leaf at ``path`` (``x`` itself if replicated);
        raises when the model axis does not divide the dim."""
        dim = self.dims.get(path)
        if dim is None or self.model == 1:
            return x
        n = x.shape[dim]
        if n % self.model:
            raise ValueError(f"tensor parallel: {path} {tuple(x.shape)}: dim {dim} does not "
                             f"divide over {self.model} model ranks")
        n //= self.model
        return x.narrow(dim, self.rank * n, n).clone()

    def gather(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """The full leaf at ``path`` from every model rank's block (a collective every
        model rank enters; ``x`` itself if replicated)."""
        dim = self.dims.get(path)
        if dim is None or self.model == 1:
            return x
        with span("tp_allgather"):
            return distributed.all_gather_dim(x, dim, MODEL_AXIS)


def plan_for(params, vlm_cfg=None, *, model: Optional[int] = None,
             rank: Optional[int] = None, prefix: str = "") -> ShardPlan:
    """The plan of ``params`` (full or sharded: only the paths count) under the rules of
    ``vlm_cfg``; ``model``/``rank`` default to this process's model axis. ``prefix``
    names the subtree's place in a VLM tree (``'llm'``, ``'lora'``)."""
    model = distributed.model_size() if model is None else model
    rank = distributed.model_rank() if rank is None else rank
    rules, partial_patterns = rules_for(vlm_cfg)
    dims, partial = {}, set()
    for path, x in leaves_with_paths(params, prefix):
        if not isinstance(x, torch.Tensor):
            continue
        dim = sharded_dim(path, rules)
        if dim is not None:
            dims[path] = dim
        elif any(re.search(p, path) for p in partial_patterns):
            partial.add(path)
    return ShardPlan(model=model, rank=rank, dims=dims, partial=frozenset(partial))


def shard_params(params, plan: ShardPlan, prefix: str = ""):
    """A tree of the same structure holding the rank's block of every sharded leaf of the
    full tree ``params`` (replicated leaves shared). A tensor held under two paths (the
    tied LM head) is sliced once and held under both."""
    done = {}

    def one(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        if id(x) not in done:
            done[id(x)] = (x, plan.shard(path, x))
        return done[id(x)][1]

    return map_with_path(one, params, prefix)


def gather_params(params, plan: ShardPlan, prefix: str = ""):
    """The inverse of :func:`shard_params`: the full tree from every model rank's shards
    (a collective every model rank enters, leaf by leaf in path order; ties kept)."""
    done = {}

    def one(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        if id(x) not in done:
            done[id(x)] = (x, plan.gather(path, x))
        return done[id(x)][1]

    return map_with_path(one, params, prefix)


def check_local(params, vlm_cfg, plan: ShardPlan) -> None:
    """Raise unless ``params`` hold the rank's shards: a trainer in a world with a model
    axis must not train full leaves as if they were its shards."""
    if plan.model == 1:
        return
    llm = getattr(vlm_cfg, "llm", vlm_cfg)
    q = params["llm"]["layers"][0]["attn"]["q_proj"]
    rows = next(q[k] for k in ("weight", "qvalues", "qvalues_block", "packed_nf4") if k in q)
    want = llm.num_heads * llm.head_dim // plan.model
    if rows.shape[0] != want:
        raise ValueError(f"tensor parallel: q_proj holds {rows.shape[0]} rows where model "
                         f"rank {plan.rank} of {plan.model} holds {want}: shard the params "
                         "(parallel/sharding.shard_params) before training")
