"""Megatron-style tensor parallelism over the model axis: the collectives a sharded
layer needs, as autograd operators, and the layers built on them.

What GSPMD inserts for the JAX package's ``parallel/sharding.py`` rules, the port
writes out (``models/decoder.py``, ``models/siglip.py``, ``models/projector.py``):

- :func:`copy_to_model` at the entry of a column-parallel block: identity forward,
  all-reduce backward (each rank's columns give a partial gradient of the block's
  replicated input);
- :func:`reduce_from_model` at the exit of a row-parallel product: all-reduce forward,
  identity backward; the row-parallel bias is added once, after it;
- :func:`gather_from_model`: an all-gather over the model axis (the LM head's logits
  for generation), whose backward keeps the rank's own slice;
- :func:`vocab_embedding`: a vocab-sharded table looked up where the ids fall in the
  rank's slice (zero rows elsewhere), the rows summed over the model axis;
- :func:`local_block`: the rank's block of a replicated tensor (a column-parallel
  bias, which the JAX rules keep replicated).

The models call these only for the units that the model axis splits
(``parallel/sharding.py:units``); a unit it leaves whole calls none, so a model axis
that divides less of the model counts fewer collectives.

Every collective on the model axis runs in a profiler span ``tp_allreduce`` or
``tp_allgather`` and is counted in :data:`COUNTS` by phase: ``forward``, ``backward``
(the all-reduces of :func:`copy_to_model`'s backward), ``recompute`` (a forward
all-reduce run again by a remat recompute) and ``grads`` (the train step's sum of the
partial gradients and the clip's norms, ``train/steps.py``, ``train/optim.py``). The forward all-reduce is a custom
operator (``ptt::tp_all_reduce``), so the ``remat='dots'`` policy of ``core/remat.py``
can save its output and the recompute launches no collective; under full remat the
recompute repeats it, as the JAX package's remat repeats the psum.

In a process without a model axis (``distributed.model_size() == 1``) every function
here is the identity, so the single-device paths are unchanged.
"""

from __future__ import annotations

import torch

from projectiontrainer_tpu_torch.parallel import distributed
from projectiontrainer_tpu_torch.utils.timing import span

COUNTS = {"forward": 0, "backward": 0, "recompute": 0, "grads": 0}


def size() -> int:
    return distributed.model_size()


def rank() -> int:
    return distributed.model_rank()


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _in_backward() -> bool:
    """Whether autograd's engine is running a backward on this thread (a forward
    operator called there is a remat recompute)."""
    return torch._C._current_graph_task_id() != -1


def all_reduce(x: torch.Tensor, phase: str, op=None) -> torch.Tensor:
    """A new tensor: ``x`` reduced (summed, or ``op``) over the model axis, counted under
    ``phase``, in span ``tp_allreduce``; not differentiable."""
    COUNTS[phase] += 1
    with span("tp_allreduce"):
        return distributed.all_reduce_(x.contiguous().clone(), distributed.MODEL_AXIS,
                                       **({} if op is None else {"op": op}), phase=phase)


@torch.library.custom_op("ptt::tp_all_reduce", mutates_args=())
def _all_reduce_op(x: torch.Tensor) -> torch.Tensor:
    return all_reduce(x, "recompute" if _in_backward() else "forward")


@_all_reduce_op.register_fake
def _(x):
    """The all-reduce of a trace (``parallel/budget.py``): its output, counted as the
    real one is."""
    phase = "recompute" if _in_backward() else "forward"
    COUNTS[phase] += 1
    distributed.note("all-reduce", x.numel() * x.element_size(), phase)
    return torch.empty_like(x)


_all_reduce_op.register_autograd(lambda ctx, grad: grad)
ALL_REDUCE_OP = torch.ops.ptt.tp_all_reduce.default


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, "backward")


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, all-reduce over the model axis backward."""
    return _CopyToModel.apply(x) if size() > 1 else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """All-reduce over the model axis forward, identity backward."""
    return _all_reduce_op(x) if size() > 1 else x


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        phase = "recompute" if _in_backward() else "forward"
        COUNTS[phase] += 1
        with span("tp_allgather"):
            return distributed.all_gather_dim(x, dim, distributed.MODEL_AXIS, phase)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, rank() * ctx.n, ctx.n), None


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim``; the backward keeps the
    rank's slice of the (replicated) incoming gradient."""
    if size() == 1:
        return x
    return _GatherFromModel.apply(x, dim % x.dim())


def local_block(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """The rank's block of ``n`` along ``dim`` of a replicated ``x`` (``x`` itself when
    that dim already has ``n``)."""
    if x.shape[dim] == n:
        return x
    if x.shape[dim] != n * size():
        raise ValueError(f"tensor parallel: dim {dim} of {tuple(x.shape)} is neither {n} "
                         f"nor {n} x {size()} model ranks")
    return x.narrow(dim, rank() * n, n)


def vocab_embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of a vocab-sharded table ``[V / m, D]`` (the rank's slice, rank r holding ids
    r V/m ... (r + 1) V/m - 1): ids outside the slice give zero rows, and the rows are
    summed over the model axis, so every rank holds the full lookup. The gradient reaches
    the rank's rows only."""
    if size() == 1:
        return table[ids]
    n = table.shape[0]
    local = ids - rank() * n
    inside = (local >= 0) & (local < n)
    rows = table[torch.where(inside, local, 0)]
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))
    return reduce_from_model(rows)


def vocab_logits(hidden: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Full logits ``hidden @ table^T`` from a vocab-sharded table: each rank's slice of
    the columns, gathered over the model axis (in the hidden states' type)."""
    local = torch.nn.functional.linear(copy_to_model(hidden), table.to(hidden.dtype))
    return gather_from_model(local, -1)


def column_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """A column-parallel linear on an input already in the model region: the rank's
    output columns (weight ``[out / m, in]``), the rank's block of a replicated bias;
    computed in the promoted type of x and the weight, as ``ops/layers.py:linear``."""
    w, b = p["weight"], p.get("bias")
    dt = torch.promote_types(x.dtype, w.dtype)
    if b is not None:
        b = local_block(b, 0, w.shape[0]).to(dt)
    return torch.nn.functional.linear(x.to(dt), w.to(dt), b).to(x.dtype)


def row_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel linear on the rank's input columns (weight ``[out, in / m]``): the
    partial products all-reduced over the model axis, then the bias added once."""
    w, b = p["weight"], p.get("bias")
    dt = torch.promote_types(x.dtype, w.dtype)
    y = reduce_from_model(torch.nn.functional.linear(x.to(dt), w.to(dt)))
    if b is not None:
        y = y + b.to(dt)
    return y.to(x.dtype)
