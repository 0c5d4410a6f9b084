"""ZeRO-3 over the data axis (``--fsdp``): every large leaf lives sharded at rest, is
gathered where it is used and its gradient is reduce-scattered back to the shard.

What GSPMD does for the JAX package's ``param_shardings(..., fsdp=True)`` and the
train step's sharding constraint on the gradients (``train/steps.py:95-113`` there),
the port writes out:

- :func:`gather` turns a subtree of data shards into whole leaves through
  :class:`_Gather`, an autograd Function whose forward all-gathers the shard along its
  data dim over the data group and whose backward reduce-scatters the incoming
  gradient back to the shard: the rank's block of the gradient summed over the data
  ranks, which is what the data all-reduce of the other leaves gives them. Under NCCL
  (and the fake backend of the budget's trace, ``distributed.on_device_collectives``)
  these are ``all_gather_into_tensor`` and ``reduce_scatter_tensor``; gloo has no
  reduce-scatter, so there the whole gradient is all-reduced on the host, in its own
  type as NCCL sums it, and the rank keeps its block: the same gradient, a different
  transport for a named backend (``parallel/distributed.py``);
- the models gather a layer's leaves inside the function that ``core/remat.py``
  checkpoints (``models/decoder.py``, ``models/siglip.py``): under remat ``True`` the
  recompute gathers again and no layer's whole weights outlive its use. Under
  ``False`` autograd keeps every gathered weight for the backward, and under
  ``'dots'`` the gather's output is saved like a product's (``DOTS_SAVED``), so the
  recompute launches no collective and the gathered weights live until their layer's
  backward too;
- the losses gather the top-level leaves once a micro-step (``train/steps.py``): the
  tied table serves the embedding and the chunked CE head from one gather, so its two
  gradients sum before one reduce-scatter.

The shards are gathered AFTER their cast to the compute type (``core/dtypes.py``):
the cast is elementwise, so it commutes with the gather bit for bit, and a bf16 gather
moves half the bytes of the fp32 masters'. The gradient is reduce-scattered in that
type too (over two ranks, one rounding of the sum).

Nothing is gathered unless a plan is active (:func:`active`, which
``steps.make_train_step`` enters around the loss and its backward): evaluation and
generation run on a copy gathered once (``train/common.py:compute_copy``).

Every gather and reduce-scatter is counted in :data:`COUNTS` by phase (``forward``
and ``recompute`` gathers, ``backward`` reduce-scatters, ``grads``: the clip's norms
over the data axis) with the bytes of the whole tensor in :data:`BYTES`, and runs in a
profiler span ``fsdp_gather`` or ``fsdp_reduce_scatter``. Under :func:`track`,
:data:`LIVE` follows the bytes of the gathered weights still alive and their peak, and
``LIVE['events']`` lists every collective as (phase, leaf path, bytes). Each is noted in
``distributed.COLLECTIVES`` too (the gathers by their result's bytes, the reduce-scatters
by their whole input's: what ``BYTES`` counts).
"""

from __future__ import annotations

import contextlib
import weakref

import torch
import torch.distributed as dist

from projectiontrainer_tpu_torch.core.pytree import map_with_path
from projectiontrainer_tpu_torch.parallel import distributed
from projectiontrainer_tpu_torch.utils.timing import span

COUNTS = {"forward": 0, "recompute": 0, "backward": 0, "grads": 0}
BYTES = {"forward": 0, "recompute": 0, "backward": 0}
LIVE = {"track": False, "bytes": 0, "peak": 0, "events": []}
_ACTIVE = {"plan": None}


def reset_counts() -> None:
    for d in (COUNTS, BYTES):
        for k in d:
            d[k] = 0
    LIVE.update(bytes=0, peak=0, events=[])


def track(on: bool = True) -> None:
    """Follow the bytes of the gathered weights that are alive (a finalizer on each one's
    storage, which views and aliases keep) and
    log every collective (``LIVE['events']``); off, neither costs anything."""
    LIVE.update(track=on, bytes=0, peak=0, events=[])


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


def _release(n: int) -> None:
    LIVE["bytes"] -= n


def _all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every data rank's block of ``x`` concatenated along ``dim``, in rank order."""
    n = distributed.data_size()
    group = distributed._group(distributed.DATA_AXIS)
    x = x.detach().contiguous()
    if distributed.on_device_collectives():
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
    else:
        parts = [torch.empty_like(x, device="cpu") for _ in range(n)]
        dist.all_gather(parts, x.cpu(), group=group)
        out = torch.stack(parts).to(x.device)
    return out.movedim(0, dim).reshape(
        x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:])


def _reduce_scatter(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The rank's block along ``dim`` of ``g`` summed over the data ranks."""
    n, r = distributed.data_size(), distributed.data_rank()
    size = g.shape[dim] // n
    if distributed.on_device_collectives():
        chunks = g.contiguous() if dim == 0 else torch.stack(g.chunk(n, dim))
        out = torch.empty(g.shape[:dim] + (size,) + g.shape[dim + 1:], dtype=g.dtype,
                          device=g.device)
        dist.reduce_scatter_tensor(out, chunks, group=distributed._group(
            distributed.DATA_AXIS))
        return out
    full = g.detach().to("cpu", copy=True).contiguous()
    dist.all_reduce(full, group=distributed._group(distributed.DATA_AXIS))
    return full.narrow(dim, r * size, size).contiguous().to(g.device)


def _counted(out: torch.Tensor, path: str) -> torch.Tensor:
    """Count the gather that made ``out`` (and follow its bytes under :func:`track`)."""
    phase = "recompute" if _in_backward() else "forward"
    n = out.numel() * out.element_size()
    distributed.note("all-gather", n, phase)
    COUNTS[phase] += 1
    BYTES[phase] += n
    if LIVE["track"]:
        LIVE["events"].append((phase, path, n))
        LIVE["bytes"] += n
        LIVE["peak"] = max(LIVE["peak"], LIVE["bytes"])
        weakref.finalize(out.untyped_storage(), _release, n)  # views and aliases too
    return out


@torch.library.custom_op("ptt::fsdp_all_gather", mutates_args=())
def _all_gather_op(x: torch.Tensor, dim: int, path: str) -> torch.Tensor:
    with span("fsdp_gather"):
        return _counted(_all_gather(x, dim), path)


@_all_gather_op.register_fake
def _(x, dim, path):
    """The gather of a trace (``parallel/budget.py``): its output, counted as the real
    one is."""
    shape = list(x.shape)
    shape[dim] *= distributed.data_size()
    return _counted(x.new_empty(shape), path)


ALL_GATHER_OP = torch.ops.ptt.fsdp_all_gather.default


class _Gather(torch.autograd.Function):
    """Forward: the shard all-gathered along ``dim`` over the data ranks. Backward: the
    incoming gradient reduce-scattered to the shard."""

    @staticmethod
    def forward(ctx, x, dim, path):
        ctx.dim, ctx.path = dim, path
        return _all_gather_op(x, dim, path)

    @staticmethod
    def backward(ctx, grad):
        with span("fsdp_reduce_scatter"):
            out = _reduce_scatter(grad, ctx.dim)
        n = grad.numel() * grad.element_size()
        distributed.note("reduce-scatter", n, "backward")
        COUNTS["backward"] += 1
        BYTES["backward"] += n
        if LIVE["track"]:
            LIVE["events"].append(("backward", ctx.path, n))
        return out, None, None


@contextlib.contextmanager
def active(plan):
    """Gather the data shards of ``plan`` (a ``sharding.ShardPlan``) where the models use
    them, inside the block; nothing when the plan splits no leaf over the data axis."""
    prev = _ACTIVE["plan"]
    _ACTIVE["plan"] = plan if plan is not None and plan.data_sharded else None
    try:
        yield
    finally:
        _ACTIVE["plan"] = prev


def gather(tree, prefix: str):
    """``tree`` (the subtree at ``prefix`` of the params) with every data shard of the
    active plan whole; leaves already whole, and every leaf outside :func:`active`, as
    they are. A tensor held under two paths (the tied LM head) is gathered once."""
    plan = _ACTIVE["plan"]
    if plan is None:
        return tree
    done = {}

    def one(path, x):
        dim = plan.data_dims.get(path)
        if dim is None or tuple(x.shape) != plan.local_shapes[path]:
            return x
        if id(x) not in done:
            done[id(x)] = (x, _Gather.apply(x, dim, path))
        return done[id(x)][1]

    return map_with_path(one, tree, prefix)


def gather_top(tree: dict, prefix: str) -> dict:
    """:func:`gather` of every leaf of ``tree`` but its ``layers``, which the models
    gather one layer at a time."""
    top = gather({k: v for k, v in tree.items() if k != "layers"}, prefix)
    return {k: (tree[k] if k == "layers" else top[k]) for k in tree}
