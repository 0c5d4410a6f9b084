"""Multi-process runtime: the process group, the data x model mesh's groups, host-side
gathers and the collectives of a train step.

Counterpart of ``projectiontrainer_tpu/parallel/distributed.py``. The JAX package runs
one process per host and lets XLA insert the gradient psum; the port runs one process
per GPU (``cli/launch.py`` or ``torchrun`` starts them) and issues its collectives
itself:

- :func:`initialize` joins the process group from the launcher's ``RANK`` /
  ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``, with an explicit
  timeout (a rank that never arrives fails the run in minutes) and, on the card, the
  rank's GPU pinned;
- :func:`gather_objects` and :func:`gather_ragged` keep the JAX package's semantics:
  exchange the sizes, pad to the largest, gather, trim;
- :func:`all_reduce_grads` sums gradients over the ranks in a few flat buckets (one
  collective per leaf would be hundreds of collectives a step in stage 2);
- :func:`all_gather_with_grad` concatenates a tensor over the ranks; its backward sums
  the incoming gradient over the ranks and keeps the rank's own slice (gloo has no
  reduce-scatter);
- :func:`setup_mesh` lays the world out as the JAX package's ``data`` x ``model`` mesh
  (rank r at ``(r // model, r % model)``, ``np.reshape(devices, (data, model))``) and
  creates one process group per row and per column, in the same order on every rank. A
  mesh smaller than the world takes its first ``data x model`` ranks (the JAX package's
  prefix of its devices): every rank of the world creates the groups, those beyond the
  mesh are then :func:`idle`, and for the mesh's ranks :func:`world_size` is the mesh's
  and every collective, the world's ones too, runs over the mesh's group.

Every helper above works over the **data** axis: the ranks that hold different rows. A
model axis of size m makes m ranks hold one replica's rows together (tensor
parallelism, ``parallel/tensor_parallel.py``), so the losses' global counts, the
gradient all-reduce, the evaluation gathers and the dropout seeds go over the data group
only; :func:`all_reduce_` and :func:`all_gather_dim` take the axis explicitly.

Backends: ``nccl`` for ranks on their own GPUs, ``gloo`` for the CPU, or for ranks that
share a GPU (NCCL refuses two ranks on one device). Gloo runs its collectives on the
host: a CUDA tensor is copied to the CPU for them (fp16/bf16 as fp32) and back. Every
branch between the two asks :func:`on_device_collectives`, which the ``fake`` backend
answers like ``nccl``: :func:`fake_world` is a world of ``n`` ranks seen from rank 0,
whose collectives move nothing (``torch.testing``'s ``FakeStore``), for the memory and
collective budget's trace (``parallel/budget.py``), so the trace allocates what an NCCL
rank allocates and no host staging.

Every collective that the port issues is noted in :data:`COLLECTIVES` by kind
(``all-gather``, ``reduce-scatter``, ``all-reduce``, ``broadcast``) and phase
(``forward``, ``recompute``, ``backward``, ``grads``, ``optimizer``; :func:`note`), with
the bytes of its result (of its whole input for a reduce-scatter): the inventory that
the budget predicts and the smoke counts.

Every function here is a no-op, or the identity, in a world of one process.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
from collections import defaultdict
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
# the gradient all-reduce's flat buckets: large enough for few collectives, small
# enough that the flat copy is a small part of the card's memory
BUCKET_BYTES = 256 << 20
DATA_AXIS = "data"
MODEL_AXIS = "model"
# the resolved mesh of this process (setup_mesh): axis sizes, this rank's groups (and
# "world": the mesh's ranks where it is smaller than the world), the mesh's size where it
# is smaller than the world, and whether this rank lies beyond it
_MESH = {"data": 1, "model": 1, "groups": {}, "size": None, "idle": False}
# (kind, phase) -> [count, bytes] of the collectives issued (note); the phase a caller
# sets with collective_phase
COLLECTIVES: dict = defaultdict(lambda: [0, 0])
_PHASE = [None]


@contextlib.contextmanager
def collective_phase(name: str):
    """Note the collectives issued inside the block under phase ``name`` (the train
    step's ``grads`` and ``optimizer``), whatever their callers say."""
    prev, _PHASE[0] = _PHASE[0], name
    try:
        yield
    finally:
        _PHASE[0] = prev


def note(kind: str, nbytes: int, phase: Optional[str] = None) -> None:
    """Count one collective of ``kind`` moving ``nbytes`` in :data:`COLLECTIVES`, under
    the phase of :func:`collective_phase`, else ``phase``, else ``backward`` inside
    autograd's backward and ``forward`` outside it."""
    if phase is None:
        phase = "backward" if torch._C._current_graph_task_id() != -1 else "forward"
    entry = COLLECTIVES[(kind, _PHASE[0] or phase)]
    entry[0] += 1
    entry[1] += int(nbytes)


def collective_inventory() -> dict:
    """:data:`COLLECTIVES` as {kind: {phase: {'count', 'bytes'}}}."""
    out: dict = {}
    for (kind, phase), (count, nbytes) in sorted(COLLECTIVES.items()):
        out.setdefault(kind, {})[phase] = {"count": count, "bytes": nbytes}
    return out


def reset_collectives() -> None:
    COLLECTIVES.clear()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The processes that run the step: the world's, or the mesh's where
    :func:`setup_mesh` took a prefix of the world."""
    if _MESH["size"] is not None:
        return _MESH["size"]
    return dist.get_world_size() if is_initialized() else 1


def idle() -> bool:
    """Whether this rank lies beyond a mesh smaller than the world (:func:`setup_mesh`):
    it has no place in the step."""
    return _MESH["idle"]


def local_rank() -> int:
    """This process's index among the ranks of its host (``LOCAL_RANK``; 0 alone)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def local_world_size() -> int:
    """The number of ranks on this host (``LOCAL_WORLD_SIZE``; 1 alone)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", "1"))


def launched() -> bool:
    """Whether a launcher started this process as one rank of a world."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def is_main() -> bool:
    return rank() == 0


def rank_seed(seed: int) -> int:
    """``seed`` on data rank 0, and a seed of its own for every other data rank
    (splitmix64's finaliser of the seed and the data rank): dropout masks that differ
    across the rows of the global batch, as in the JAX package, and the same masks on
    the model ranks that hold the same rows."""
    r = data_rank()
    if r == 0:
        return int(seed)
    z = (int(seed) * 0x9E3779B97F4A7C15 + r) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def default_backend(device_type: str) -> str:
    """The backend a launcher named (``PTT_DIST_BACKEND``), else ``nccl`` on the card
    and ``gloo`` on the CPU."""
    return os.environ.get("PTT_DIST_BACKEND") or ("nccl" if device_type == "cuda" else "gloo")


def check_backend(backend: str, device_type: str, ranks_per_host: int) -> None:
    """Raise for a backend that cannot carry this world: NCCL needs CUDA tensors and a
    GPU of its own for each rank of the host."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    if backend != "nccl":
        return
    if device_type != "cuda":
        raise ValueError("the nccl backend carries CUDA tensors only: use gloo on the CPU")
    n_gpus = torch.cuda.device_count()
    if ranks_per_host > n_gpus:
        raise ValueError(
            f"{ranks_per_host} ranks on a host with {n_gpus} visible GPU(s): NCCL refuses two "
            "ranks on one GPU; pass --backend gloo for ranks that share a card")


def initialize(device_type: str = "cuda", backend: Optional[str] = None,
               timeout_s: Optional[float] = None) -> tuple[int, int]:
    """Join the process group when a launcher started this process in a world of more
    than one; returns (rank, world size). On the card the rank's GPU is
    ``LOCAL_RANK`` modulo the visible GPUs (ranks share cards only under gloo). The
    timeout is ``timeout_s``, else ``PTT_DIST_TIMEOUT_S``, else 600 s. Safe to call
    again, and in a single process (no-op)."""
    if is_initialized():
        return rank(), world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1
    backend = backend or default_backend(device_type)
    check_backend(backend, device_type, local_world_size())
    if device_type == "cuda":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    timeout = float(timeout_s or os.environ.get("PTT_DIST_TIMEOUT_S", DEFAULT_TIMEOUT_S))
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=world, timeout=datetime.timedelta(seconds=timeout))
    return rank(), world_size()


def on_device_collectives() -> bool:
    """Whether the process group runs its collectives on the tensors' device: NCCL, and
    the fake backend of :func:`fake_world`, which stands for it. Gloo stages through the
    host."""
    return dist.get_backend() in ("nccl", "fake")


@contextlib.contextmanager
def fake_world(n: int, data: Optional[int] = None, model: int = 1):
    """A process group of ``n`` ranks on the ``fake`` backend, this process rank 0, laid
    out as a ``data`` (default n / model) x ``model`` mesh: every collective returns at
    once and moves nothing. Raises if a process group exists already; the world and the
    mesh are torn down on exit, whatever happens inside."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if is_initialized():
        raise RuntimeError("fake_world: a process group is initialized already")
    data = n // model if data is None else data
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        setup_mesh(data, model)
        yield
    finally:
        shutdown()


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()
    _MESH.update({"data": 1, "model": 1, "groups": {}, "size": None, "idle": False})


def setup_mesh(data: int, model: int) -> None:
    """Lay the world out as a ``data`` x ``model`` mesh: rank r at (r // model, r % model).
    Every rank creates every group, the mesh's own first where the mesh is smaller than
    the world (the mesh's data group where there is no model axis), then columns (the
    data groups: the ranks of one model index) and rows (the model groups: the ranks of
    one replica), in the same order; the ranks beyond the mesh belong to none of them
    and are :func:`idle`."""
    world = dist.get_world_size() if is_initialized() else 1
    size, r = data * model, rank()
    if size > world:
        raise ValueError(f"mesh {data}x{model} over a world of {world}")
    prefix = size < world
    _MESH.update({"data": data, "model": model, "groups": {}, "size": size if prefix else None,
                  "idle": r >= size})
    mine = r < size
    if prefix:
        g = dist.new_group(list(range(size)))
        if mine:
            _MESH["groups"]["world"] = g
            if model == 1:
                _MESH["groups"][DATA_AXIS] = g
    if model == 1 or world == 1:
        return  # the data group is the mesh; no model group
    for j in range(model):
        g = dist.new_group([d * model + j for d in range(data)])
        if mine and r % model == j:
            _MESH["groups"][DATA_AXIS] = g
    for d in range(data):
        g = dist.new_group([d * model + j for j in range(model)])
        if mine and r // model == d:
            _MESH["groups"][MODEL_AXIS] = g


def data_size() -> int:
    """Ranks that hold different rows (the data axis); the world without a model axis."""
    return world_size() // _MESH["model"]


def data_rank() -> int:
    return rank() // _MESH["model"]


def model_size() -> int:
    """Ranks that share one replica's rows (the model axis; 1 without tensor parallelism)."""
    return _MESH["model"]


def model_rank() -> int:
    return rank() % _MESH["model"]


def axis_size(axis: str) -> int:
    return data_size() if axis == DATA_AXIS else model_size()


def _group(axis: str):
    """The process group of this rank's ``axis``, or ``'world'``: the mesh's ranks (None:
    the world)."""
    return _MESH["groups"].get(axis)


def barrier() -> None:
    """Cross-rank sync point (the reference fences validation and saving with
    ``dist.barrier``, Stage0:321,357,428,795-798)."""
    if world_size() == 1:
        return
    group = _group("world")
    if dist.get_backend() == "nccl":  # the fake backend's barrier needs no device
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


# ------------------------------------------------------------------------ tensors


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the process group carries it: itself under nccl; under gloo a CPU
    tensor, fp16/bf16 widened to fp32 (gloo sums on the host)."""
    if on_device_collectives():
        return t
    if t.dtype in (torch.float16, torch.bfloat16):
        return t.to("cpu", torch.float32)
    return t.cpu()


def all_reduce_(t: torch.Tensor, axis: str = DATA_AXIS, op=dist.ReduceOp.SUM,
                phase: Optional[str] = None) -> torch.Tensor:
    """Reduce ``t`` (sum, or ``op``) over the ranks of ``axis``, in place; returns ``t``.
    ``phase``: what :func:`note` counts it under, when no block sets one."""
    if axis_size(axis) == 1:
        return t
    note("all-reduce", t.numel() * t.element_size(), phase)
    c = _staged(t)
    dist.all_reduce(c, op=op, group=_group(axis))
    if c is not t:
        t.copy_(c)
    return t


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the data ranks, in place; returns ``t``."""
    return all_reduce_(t, DATA_AXIS)


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """A new tensor: ``x`` (detached) summed over the data ranks; ``x`` itself alone."""
    if data_size() == 1:
        return x
    return all_reduce_sum_(x.detach().clone())


def all_gather_dim(x: torch.Tensor, dim: int, axis: str = DATA_AXIS,
                   phase: Optional[str] = None) -> torch.Tensor:
    """Every rank's ``x`` of ``axis`` (the same shape on each) concatenated along
    ``dim``, in rank order; not differentiable. ``phase`` as :func:`all_reduce_`'s."""
    if axis_size(axis) == 1:
        return x
    c = x.detach().contiguous()
    if not on_device_collectives():  # gloo: on the host, in its own type (it sums nothing)
        c = c.cpu()
    out = [torch.empty_like(c) for _ in range(axis_size(axis))]
    note("all-gather", axis_size(axis) * c.numel() * c.element_size(), phase)
    dist.all_gather(out, c, group=_group(axis))
    return torch.cat(out, dim=dim).to(x.device, x.dtype)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's ``x`` (the same shape on each) concatenated along dim 0, in
    rank order."""
    return all_gather_dim(x, 0, DATA_AXIS)


class _AllGatherWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return all_gather(x)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce_sum_(grad.contiguous().clone())
        r = data_rank()
        return grad[r * ctx.rows:(r + 1) * ctx.rows]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """:func:`all_gather` that autograd differentiates: the gradient of the rank's rows
    is the sum over the data ranks of the gradients of those rows of the concatenation
    (each rank's loss reads every rank's rows)."""
    if data_size() == 1:
        return x
    return _AllGatherWithGrad.apply(x)


def _buckets(tensors: Sequence[torch.Tensor]):
    """``tensors`` grouped by device and type, in order, into lists of at most about
    ``BUCKET_BYTES``: the same grouping on every rank that passes the same leaves."""
    groups = defaultdict(list)
    for t in tensors:
        groups[(t.device, t.dtype)].append(t)
    for ts in groups.values():
        bucket, size = [], 0
        for t in ts:
            bucket.append(t)
            size += t.numel() * t.element_size()
            if size >= BUCKET_BYTES:
                yield bucket
                bucket, size = [], 0
        if bucket:
            yield bucket


@torch.no_grad()
def _coalesced(tensors: Sequence[torch.Tensor], collective) -> None:
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective(flat)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_grads(grads: Sequence[torch.Tensor], axis: str = DATA_AXIS) -> None:
    """Sum every gradient over the ranks of ``axis`` (the data ranks by default), in
    place: one collective for each flat bucket of one device and type (:func:`_buckets`)."""
    if axis_size(axis) > 1:
        _coalesced(grads, lambda flat: all_reduce_(flat, axis))


def broadcast_(tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite every tensor with data rank 0's of this rank's data group (the rank of
    the same model index in the first replica), in place, bucketed as the gradients:
    the replicas start equal."""
    if data_size() == 1:
        return
    src = model_rank()  # global rank of (0, model index)

    def bcast(flat):
        note("broadcast", flat.numel() * flat.element_size())
        c = _staged(flat)
        dist.broadcast(c, src, group=_group(DATA_AXIS))
        if c is not flat:
            flat.copy_(c)

    _coalesced(tensors, bcast)


# --------------------------------------------------------------------------- host


def _host_device() -> torch.device:
    """Where a host value travels: the rank's GPU under nccl, the CPU under gloo (and
    under the fake backend, which moves nothing)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_value(value: float, src: int = 0) -> float:
    """Rank ``src``'s ``value`` on every rank (a decision that gates a collective must
    be the same everywhere)."""
    if world_size() == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=_host_device())
    dist.broadcast(t, src, group=_group("world"))
    return float(t.item())


def _gather_padded(rows: np.ndarray) -> list[np.ndarray]:
    """Each data rank's ``rows`` ([n_r, row_bytes] uint8, n_r free per rank): the sizes
    exchanged, every block padded to the largest, gathered and trimmed, in rank order."""
    device = _host_device()
    sizes = all_gather(torch.tensor([rows.shape[0]], dtype=torch.int64, device=device))
    sizes = sizes.cpu().tolist()
    padded = np.zeros((max(sizes), rows.shape[1]), np.uint8)
    padded[:rows.shape[0]] = rows
    gathered = all_gather(torch.from_numpy(padded).to(device)).cpu().numpy()
    blocks = gathered.reshape(len(sizes), max(sizes), rows.shape[1])
    return [block[:n] for block, n in zip(blocks, sizes)]


def gather_ragged(local) -> np.ndarray:
    """Every data rank's array (leading dims free per rank; the same type and trailing
    dims on each) concatenated in rank order: the Stage-0 padded all-gather
    (reference :362-411)."""
    local = np.asarray(local)
    if data_size() == 1:
        return local
    row_bytes = int(np.prod(local.shape[1:], dtype=np.int64)) * local.dtype.itemsize
    rows = np.frombuffer(np.ascontiguousarray(local).tobytes(), np.uint8)
    blocks = _gather_padded(rows.reshape(local.shape[0], row_bytes))
    flat = np.concatenate(blocks).tobytes()
    return np.frombuffer(flat, local.dtype).reshape((-1,) + local.shape[1:]).copy()


def gather_objects(local: Sequence[Any]) -> list[Any]:
    """Every data rank's picklable objects (validation example strings) in one list, in
    rank order; only this program's own ranks' bytes are unpickled."""
    if data_size() == 1:
        return list(local)
    payload = np.frombuffer(pickle.dumps(list(local)), np.uint8)
    out = []
    for block in _gather_padded(payload.reshape(-1, 1)):
        out.extend(pickle.loads(block.tobytes()))
    return out
