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

Where GSPMD lets the JAX package shard any leaf and regather around a lone replicated
one, the port's explicit Megatron collectives (``parallel/tensor_parallel.py``) can
compose only whole units, so the port replicates by unit where the JAX package
replicates by leaf (``_divisible`` / ``param_shardings`` there). :func:`units` says which
units of a model the model axis splits: one only when every dim of it divides. A unit
it does not split runs whole on every model rank (no collective on its way in or out, a
complete gradient): a decoder's attention block (its query heads), its MLP, its vocab
(the table and the LM head), the projector, and a tower's attention, MLP (the MAP head's
too) and text vocab. A decoder's KV heads where the query heads divide and the KV heads
do not (one KV head included) are replicated: the k/v projections, their LoRA adapters
and quantized leaves; each rank slices the KV heads its query heads read after the
projection (``ops/flash_attention.rank_kv_heads``), and their gradient is partial.
A decoder quantized by NF4 (``nf4``, ``nf4-mirror``: ``models/decoder.py:
QuantizedDecoderConfig``) keeps its blocks of 64 values along a projection's input
whole on a rank, so its attention block and its MLP split only where the blocks of the
row-parallel o_proj and down_proj (``block_scales [out, in / 64]``) divide too: Gemma3-1B's
MLP of 6912 (108 blocks) splits at a model axis of 2, 3 or 4 and runs whole at 8. The JAX
package replicates those leaves alone (by leaf, as everywhere).

A :class:`ShardPlan` says, for a params tree, which leaves are sharded on which dim and
which replicated leaves get a PARTIAL gradient on each model rank because they act on
sharded activations (the q/k RMSNorm scales, a column-parallel bias, the replicated k/v
projections, LoRA's ``a`` of a column target and ``b`` of a row target, each of a split
unit): the train step sums those over the model axis (``train/steps.py``), and the
norms count a sharded leaf's squares over the model axis and a replicated leaf's once
(``train/optim.py``). :func:`shard_params` slices a full tree to a rank's shards,
:func:`gather_params` is its inverse (a collective; the checkpoints' writes).

ZeRO-3 over the data axis (``--fsdp``; the JAX package's ``_with_fsdp_axis``,
``FSDP_MIN_SIZE`` and ``param_shardings(..., fsdp=True)``): a plan built with ``fsdp``
also names, for each leaf of at least ``FSDP_MIN_SIZE`` elements and two or more dims,
the dim that the data axis splits: the largest one that the model rules leave free and
that the data axis divides, read on the JAX package's layout of the leaf (its ``[in,
out]`` kernels, its ``[p, p, C, D]`` patch kernel; :func:`fsdp_dim`), so that a square
leaf lands on the same logical dim in both packages. Every leaf qualifies, frozen and
quantized ones too; a leaf the rule leaves alone stays replicated over the data axis.
:func:`shard_params`, :func:`gather_params` and the plan's ``shard``/``gather`` work
over both axes; ``parallel/fsdp.py`` gathers the data shards on use.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Mapping, Optional, Sequence

import torch

from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths, map_with_path
from projectiontrainer_tpu_torch.ops import quant
from projectiontrainer_tpu_torch.parallel import distributed
from projectiontrainer_tpu_torch.utils.timing import span

MODEL_AXIS = distributed.MODEL_AXIS
DATA_AXIS = distributed.DATA_AXIS
# leaves below this many elements stay replicated under --fsdp (the JAX package's
# parallel/sharding.py:76): a gather's latency outweighs the bytes a small leaf saves
FSDP_MIN_SIZE = 65_536
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

# KV heads the model axis does not split are replicated (ahead of DEFAULT_RULES)
REPLICATED_KV_RULES: Sequence[tuple[str, tuple]] = (
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
REPLICATED_KV_PARTIAL: Sequence[str] = (
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


@dataclasses.dataclass(frozen=True)
class Units:
    """Which units of one part of a model the model axis splits (True) or leaves whole
    on every model rank (False): ``attn`` the attention block's query heads (a
    decoder's or a tower's), ``kv`` a decoder's KV heads (split only with its query
    heads; else replicated and sliced by rank), ``mlp`` the MLP's (or the projector's)
    intermediate size, ``vocab`` the token table (and a decoder's LM head)."""

    attn: bool = False
    kv: bool = False
    mlp: bool = False
    vocab: bool = False


@functools.lru_cache(maxsize=None)
def units(cfg, model: int) -> Units:
    """The units of ``cfg`` (a decoder, a tower or the projector config) that a model
    axis of ``model`` ranks splits: each whose dims all divide, and for a decoder
    quantized by NF4 whose row-parallel projection's blocks of 64 along its input divide
    too (:func:`nf4_blocks`). KV heads are split only where the query heads are, where
    they divide, and where there is more than one (the rule at a model axis of one too,
    where nothing is cut)."""
    def div(n):
        return n % model == 0

    if hasattr(cfg, "num_kv_heads"):
        attn = div(cfg.num_heads) and div(nf4_blocks(cfg, cfg.num_heads * cfg.head_dim))
        return Units(attn=attn, kv=attn and cfg.num_kv_heads != 1 and div(cfg.num_kv_heads),
                     mlp=div(cfg.intermediate_size) and div(nf4_blocks(cfg, cfg.intermediate_size)),
                     vocab=div(cfg.vocab_size))
    if hasattr(cfg, "intermediate_dim"):
        return Units(mlp=div(cfg.intermediate_dim))
    return Units(attn=div(cfg.num_heads), mlp=div(cfg.intermediate_size),
                 vocab=hasattr(cfg, "vocab_size") and div(cfg.vocab_size))


def nf4_blocks(cfg, width: int) -> int:
    """The NF4 blocks along an input of ``width`` values of a decoder quantized by NF4
    (``ops/quant.py:quantize_nf4``: blocks of ``min(64, width)``); 0, which every model
    axis divides, for any other decoder."""
    if getattr(cfg, "quant_method", None) not in ("nf4", "nf4-mirror"):
        return 0
    return width // min(quant.NF4_BLOCK, width)


def splits(cfg, unit: str) -> bool:
    """Whether this process's model axis splits ``unit`` (a field of :class:`Units`) of
    ``cfg``; without a model axis nothing is split."""
    model = distributed.model_size()
    return model > 1 and getattr(units(cfg, model), unit)


def _decoder_cfg(model_cfg):
    return getattr(model_cfg, "llm", model_cfg if hasattr(model_cfg, "num_kv_heads") else None)


def _parts(model_cfg):
    """(tree prefix, config) of each part of ``model_cfg`` (a VLM or decoder config, a
    SigLIP dual tower or a classifier) that has units."""
    out = []
    if _decoder_cfg(model_cfg) is not None:
        out.append(("llm", _decoder_cfg(model_cfg)))
    for name in ("projector", "vision", "text"):
        if getattr(model_cfg, name, None) is not None:
            out.append((name, getattr(model_cfg, name)))
    return out


_LORA_ATTN, _LORA_MLP = "q_proj|k_proj|v_proj|o_proj", "gate_proj|up_proj|down_proj"


def whole_patterns(model_cfg, model: int) -> tuple[str, ...]:
    """Path patterns of the leaves of the units that a model axis of ``model`` ranks
    leaves whole (:func:`units`): replicated, with complete gradients."""
    if model_cfg is None or model == 1:
        return ()
    out = []
    for name, cfg in _parts(model_cfg):
        u = units(cfg, model)
        if name == "llm":
            if not u.attn:
                out += [r"^llm/layers/\d+/attn/", rf"^lora/layers/\d+/({_LORA_ATTN})/"]
            if not u.mlp:
                out += [r"^llm/layers/\d+/mlp/", rf"^lora/layers/\d+/({_LORA_MLP})/"]
            if not u.vocab:
                out.append(r"^llm/(embed_tokens|lm_head)/")
        elif name == "projector":
            if not u.mlp:
                out.append(r"^projector/")
        else:
            if not u.attn:
                out.append(rf"^{name}/layers/\d+/attn/")
            if not u.mlp:
                out += [rf"^{name}/layers/\d+/mlp/", rf"^{name}/head/mlp/"]
            if name == "text" and not u.vocab:
                out.append(r"^text/token_embedding/")
    return tuple(out)


def rules_for(vlm_cfg=None, model: Optional[int] = None) -> tuple[tuple, tuple]:
    """(sharding rules, partial-gradient patterns) for a model config at a model axis of
    ``model`` ranks (default: this process's): the defaults, behind the leaves of whole
    units (:func:`whole_patterns`, replicated) and replicated KV heads."""
    model = distributed.model_size() if model is None else model
    whole = tuple((p, ()) for p in whole_patterns(vlm_cfg, model))
    llm = _decoder_cfg(vlm_cfg)
    if llm is not None and units(llm, model).attn and not units(llm, model).kv:
        return (whole + tuple(REPLICATED_KV_RULES) + tuple(DEFAULT_RULES),
                tuple(PARTIAL_GRADS) + tuple(REPLICATED_KV_PARTIAL))
    return whole + tuple(DEFAULT_RULES), tuple(PARTIAL_GRADS)


_TRANSPOSED = frozenset({"weight", "qvalues", "qvalues_block", "packed_nf4", "block_scales"})


def _jax_view(path: str, shape: Sequence[int], vision=None):
    """(the leaf's shape in the JAX package's layout, the port dim of each of its dims or
    None): a linear's ``[out, in]`` (quantized leaves and LoRA's ``a``/``b`` too) is
    ``[in, out]`` there; the patch matrix ``[D, p*p*C]`` is the HWIO kernel ``[p, p, C, D]``,
    whose patch rows are contiguous blocks of the port's columns (``checkpoint/from_jax.py``);
    everything else keeps its layout."""
    key = path.rsplit("/", 1)[-1]
    if path.endswith("patch_embedding/weight") and len(shape) == 2:
        if vision is None:
            raise ValueError(f"{path}: the vision config is needed to read the patch kernel")
        p, c = vision.patch_size, vision.num_channels
        return (p, p, c, shape[0]), (1, None, None, 0)
    lora = key in ("a", "b") and re.search(r"(^|/)lora/", path)
    if len(shape) == 2 and (key in _TRANSPOSED or lora):
        return (shape[1], shape[0]), (1, 0)
    return tuple(shape), tuple(range(len(shape)))


def fsdp_dim(path: str, shape: Sequence[int], data: int, *, model: int = 1,
             vision=None) -> Optional[int]:
    """The port dim of the leaf at ``path`` (whole ``shape``) that the data axis of
    ``data`` ranks splits under ``--fsdp``, or None: the JAX package's
    ``_with_fsdp_axis`` on the JAX layout of the leaf (:func:`_jax_view`) and its
    ``DEFAULT_RULES`` spec (which names a dim whenever the model axis divides it, a
    model axis of one included): the largest other dim that the data axis divides,
    the first of equals, for a leaf of two or more dims and at least
    ``FSDP_MIN_SIZE`` elements."""
    if data <= 1 or len(shape) < 2 or math.prod(shape) < FSDP_MIN_SIZE:
        return None
    jshape, to_port = _jax_view(path, shape, vision)
    m = sharded_dim(path)
    if m is not None and shape[m] % model:
        m = None  # the JAX package replicates what the model axis does not divide
    candidates = [d for d in range(len(jshape))
                  if (m is None or to_port[d] != m) and jshape[d] % data == 0]
    if not candidates:
        return None
    best = max(candidates, key=lambda d: jshape[d])
    if to_port[best] is None:
        raise ValueError(f"{path}: the data axis would split dim {best} of the JAX layout "
                         f"{tuple(jshape)}, which is not a block of the port's {tuple(shape)}")
    return to_port[best]


_UNIT_NAMES = {"attn": "attention", "kv": "KV heads", "mlp": "MLP", "vocab": "vocab"}


def check_config(model_cfg, model: int) -> list[str]:
    """The units of ``model_cfg`` (a VLM or decoder config, a SigLIP dual tower or a
    classifier, whose head is always whole) that a model axis of ``model`` ranks leaves
    whole, by name (replicated KV heads as ``'llm KV heads'``); raises for a model axis
    below one."""
    if model < 1:
        raise ValueError(f"tensor parallel: a model axis of {model} ranks")
    if model == 1:
        return []
    out = []
    for name, cfg in _parts(model_cfg):
        u = units(cfg, model)
        fields = {"llm": ("attn", "kv", "mlp", "vocab"), "projector": ("mlp",),
                  "vision": ("attn", "mlp"), "text": ("attn", "mlp", "vocab")}[name]
        out += [f"{name} {_UNIT_NAMES[f]}" for f in fields
                if not getattr(u, f) and not (f == "kv" and not u.attn)]
    return out


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Which leaves of a params tree the model axis splits (path -> dim) and which
    replicated leaves get partial gradients, for model rank ``rank`` of ``model``;
    under ``--fsdp`` also which leaves the data axis splits (path -> dim, for data rank
    ``data_rank`` of ``data``) and the shape of the rank's block of each
    (``local_shapes``, both axes applied)."""

    model: int
    rank: int
    dims: Mapping[str, int]
    partial: frozenset
    data: int = 1
    data_rank: int = 0
    data_dims: Mapping[str, int] = dataclasses.field(default_factory=dict)
    local_shapes: Mapping[str, tuple] = dataclasses.field(default_factory=dict)

    @property
    def sharded(self) -> frozenset:
        """The leaves the model axis splits."""
        return frozenset(self.dims)

    @property
    def data_sharded(self) -> frozenset:
        """The leaves the data axis splits (``--fsdp``)."""
        return frozenset(self.data_dims) if self.data > 1 else frozenset()

    def shard(self, path: str, x: torch.Tensor, axes=(MODEL_AXIS, DATA_AXIS)) -> torch.Tensor:
        """The rank's block of the leaf at ``path``, whole along ``axes`` (``x`` itself
        when no axis of ``axes`` splits it); raises when an axis does not divide its
        dim."""
        out = x
        for axis, dims, n, r in ((MODEL_AXIS, self.dims, self.model, self.rank),
                                 (DATA_AXIS, self.data_dims, self.data, self.data_rank)):
            dim = dims.get(path)
            if axis not in axes or dim is None or n == 1:
                continue
            size = out.shape[dim]
            if size % n:
                raise ValueError(f"{axis} axis: {path} {tuple(out.shape)}: dim {dim} does not "
                                 f"divide over {n} ranks")
            out = out.narrow(dim, r * (size // n), size // n)
        return x if out is x else out.clone()

    def gather(self, path: str, x: torch.Tensor, axes=(MODEL_AXIS, DATA_AXIS)) -> torch.Tensor:
        """The leaf at ``path`` whole along ``axes`` from every rank's block: over the
        data axis, then the model axis (a collective every rank of those axes enters;
        ``x`` itself when neither splits it)."""
        dim = self.data_dims.get(path)
        if DATA_AXIS in axes and dim is not None and self.data > 1:
            with span("fsdp_gather"):
                x = distributed.all_gather_dim(x, dim, DATA_AXIS)
        dim = self.dims.get(path)
        if MODEL_AXIS not in axes or dim is None or self.model == 1:
            return x
        with span("tp_allgather"):
            return distributed.all_gather_dim(x, dim, MODEL_AXIS)


def plan_for(params, vlm_cfg=None, *, model: Optional[int] = None,
             rank: Optional[int] = None, data: Optional[int] = None,
             data_rank: Optional[int] = None, fsdp: bool = False,
             prefix: str = "") -> ShardPlan:
    """The plan of ``params`` under the rules of ``vlm_cfg``; ``model``/``rank`` and
    ``data``/``data_rank`` default to this process's axes. ``prefix`` names the
    subtree's place in a VLM tree (``'llm'``, ``'lora'``). Without ``fsdp`` only the
    paths count (full or sharded params alike); with it the data dims are read from the
    shapes, so ``params`` must hold whole leaves along the data axis: the full tree, or a
    model rank's shards (the trainers' input; a model-sharded dim counts whole)."""
    model = distributed.model_size() if model is None else model
    rank = distributed.model_rank() if rank is None else rank
    data = distributed.data_size() if data is None else data
    data_rank = distributed.data_rank() if data_rank is None else data_rank
    rules, partial_patterns = rules_for(vlm_cfg, model)
    whole_units = whole_patterns(vlm_cfg, model)
    vision = getattr(vlm_cfg, "vision", None)
    dims, partial, data_dims, local = {}, set(), {}, {}
    for path, x in leaves_with_paths(params, prefix):
        if not isinstance(x, torch.Tensor):
            continue
        dim = sharded_dim(path, rules)
        if dim is not None:
            dims[path] = dim
        elif (any(re.search(p, path) for p in partial_patterns)
              and not any(re.search(p, path) for p in whole_units)):
            partial.add(path)
        if fsdp:
            whole = list(x.shape)
            if dim is not None and model > 1:
                whole[dim] *= model
            d = fsdp_dim(path, whole, data, model=model, vision=vision)
            if d is not None:
                data_dims[path] = d
                shape = list(x.shape)
                shape[d] //= data
                local[path] = tuple(shape)
    return ShardPlan(model=model, rank=rank, dims=dims, partial=frozenset(partial),
                     data=data, data_rank=data_rank, data_dims=data_dims, local_shapes=local)


def shard_params(params, plan: ShardPlan, prefix: str = "", axes=(MODEL_AXIS, DATA_AXIS)):
    """A tree of the same structure holding the rank's block of every leaf that an axis
    of ``axes`` splits (``params`` whole along them; other leaves shared). A tensor held
    under two paths (the tied LM head) is sliced once and held under both."""
    done = {}

    def one(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        if id(x) not in done:
            done[id(x)] = (x, plan.shard(path, x, axes))
        return done[id(x)][1]

    return map_with_path(one, params, prefix)


def gather_params(params, plan: ShardPlan, prefix: str = "", host: bool = False,
                  axes=(MODEL_AXIS, DATA_AXIS)):
    """The inverse of :func:`shard_params`: the tree whole along ``axes`` from every
    rank's shards (a collective every rank enters, leaf by leaf in path order; ties
    kept). ``host``
    moves each whole leaf to the CPU as it comes, so the card never holds more than one
    whole leaf beside the shards (the exports of a model sharded over the data axis)."""
    done = {}

    def one(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        if id(x) not in done:
            whole = plan.gather(path, x, axes)
            done[id(x)] = (x, whole.cpu() if host else whole)
        return done[id(x)][1]

    return map_with_path(one, params, prefix)


def _probes(params, model_cfg) -> list[tuple[str, int]]:
    """(path, whole rows) of a leaf of each unit of ``params``: a decoder's first q_proj
    and gate_proj, its table, the projector's fc1, each tower's first q_proj and fc1
    and the text table (those the tree holds)."""
    out = []
    llm = _decoder_cfg(model_cfg)
    if "llm" in params and llm is not None and params["llm"]["layers"]:
        out += [("llm/layers/0/attn/q_proj", llm.num_heads * llm.head_dim),
                ("llm/layers/0/mlp/gate_proj", llm.intermediate_size)]
    if "llm" in params and llm is not None:
        out.append(("llm/embed_tokens", llm.vocab_size))
    if "projector" in params:
        out.append(("projector/fc1", model_cfg.projector.intermediate_dim))
    for name in ("vision", "text"):
        tower = getattr(model_cfg, name, None)
        if name in params and tower is not None and params[name]["layers"]:
            out += [(f"{name}/layers/0/attn/q_proj", tower.hidden_size),
                    (f"{name}/layers/0/mlp/fc1", tower.intermediate_size)]
        if name == "text" and name in params and tower is not None:
            out.append(("text/token_embedding", tower.vocab_size))
    return out


def check_local(params, model_cfg, plan: ShardPlan) -> None:
    """Raise unless ``params`` hold the rank's shards: a trainer in a world with a model
    axis must not train full leaves as if they were its shards. Read on a leaf of each
    unit (:func:`_probes`): a model rank's share of its rows where the plan splits it,
    all of them where the unit is whole."""
    if plan.model == 1:
        return
    for path, width in _probes(params, model_cfg):
        node = params
        for key in path.split("/"):
            node = node[int(key)] if isinstance(node, list) else node[key]
        key = next(k for k in ("weight", "qvalues", "qvalues_block", "packed_nf4",
                               "embedding") if k in node)
        split = f"{path}/{key}" in plan.dims
        want = width // plan.model if split else width
        rows = node[key].shape[0]
        if rows != want:
            raise ValueError(f"tensor parallel: {path} holds {rows} rows where model rank "
                             f"{plan.rank} of {plan.model} holds {want}"
                             f"{'' if split else ' (a whole unit)'}: shard the params "
                             "(parallel/sharding.model_shards) before training")


def model_shards(params: dict, model_cfg) -> dict:
    """A whole loaded tree (a SigLIP dual tower, a classifier) sliced to this model
    rank's shards, each sharded leaf a copy of its block (the whole leaves are freed
    with ``params``; a whole unit's leaves are shared); ``params`` itself without a model
    axis. The VLM's counterpart, which
    slices the decoder a layer at a time, is ``train/setup.py:shard_model``."""
    model = distributed.model_size()
    if model == 1:
        return params
    check_config(model_cfg, model)
    return shard_params(params, plan_for(params, model_cfg), axes=(MODEL_AXIS,))
