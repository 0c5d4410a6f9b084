"""Flash attention, forward and backward: the CUDA kernels ``csrc/flash_attn_fwd.cu``
(forward) and ``csrc/flash_attn_bwd.cu`` (dK/dV and dQ) for CUDA tensors, their plain
versions for CPU ones.

Counterpart of ``projectiontrainer_tpu/ops/flash_attention.py`` (``_flash`` with its
custom VJP: ``_fwd``/``_fwd_kernel`` and ``_bwd``/``_bwd_dkv_kernel``/``_bwd_dq_kernel``).
``flash_attention`` returns ``(out, lse)`` like ``_fwd`` does: ``out`` [B, T, Hq, D] in
q's dtype and ``lse`` [B, Hq, T] fp32 in natural-log units. The lse of a row with no
valid key is not defined beyond being very negative; such rows output 0 and get zero
gradients. ``out`` is differentiable with respect to q, k and v (a
``torch.autograd.Function``: the forward saves ``out`` and ``lse``, the backward
computes ``delta = rowsum(dO * O)`` in plain torch, as JAX does outside its kernels,
then runs the two backward kernels, or on the CPU the FlashAttention-2 formulas of
``flash_attention_bwd_reference``). ``lse`` is not differentiable. When a backward
will follow, the forward kernel also writes O in fp32 and the backward takes delta
from that copy, not from the bf16 output (see ``csrc/flash_attn_fwd.cu``).

Self-attention shapes only (``Tq == Tk``): the towers (non-causal) and the decoder
(causal, sliding window, padding mask, GQA). The kernels take head dims 64, 72 (so400m;
the kernels fill its rows up with zeros on the chip, nothing is padded here), 128, 256
and 512, and every multiple of 64 above 512; any other head dim is zero-padded on the
card to the next of them, as the JAX package pads inside its kernel
(``flash_attention_padded``): the kernels run at that width with the caller's scale
``D ** -0.5`` and O, dQ, dK and dV are sliced back (q.k and P.V gain only zero terms).
At 512 each kernel splits its accumulator's columns over its two warpgroups (and K4 over
two CTAs a key tile), which both compute the scores. Above 512 two routes
(``forward_plan``, ``dkv_plan``, ``dq_plan`` name them): K1, K4 and K5 up to D = 8192
run ``csrc/flash_attn_cluster.cu``, which cuts D over a thread-block cluster of up to 16
CTAs (above 8 the H100's non-portable cluster sizes), each warpgroup computing its
column slice's part of the scores (and of dP) on wgmma and the cluster summing the parts
(``cluster_plan``; K4 and K5 past 4096 in two passes over the output columns, route
"cluster passes", each pass forming the scores once); past that reach the column blocks
of ``csrc/flash_attn_wide.cu`` (a CTA owns 128 output columns of a 64-row tile and
computes the scores over the whole D again for its block: ``wide_plan``).

Each launch is a ``ptt`` operator (``kernels/_build.py:kernel_op``): the wrappers check
the shapes and allocate every buffer the kernel writes (``fwd_buffers``,
``dkv_buffers``, ``dq_buffers``) before it, and the operator's CUDA implementation
checks the pointers and launches; under ``FakeTensorMode`` it does nothing.

What a launch decides on the host is in plain functions here, which the CPU tests
reach: the tiles of each kernel by head dim (``forward_plan``, ``dkv_plan``,
``dq_plan``), the K/V tiles a query tile visits (K1, K5) and the query tiles a key
tile visits (K4) under the causal mask and the window (``kv_tile_range``,
``q_tile_range``; the kernels compute the same bounds), and the 4-D tensor map of a
strided ``[B, T, H, D]`` tensor (``tensor_map_plan``), through which the TMA unit reads
q, k, v and dO as they lie.

``sharded_flash_plan`` and ``sharded_flash_attention`` are the counterparts of the JAX
package's heads-over-model ``shard_map`` (``ops/flash_attention.py:864-933`` there):
under tensor parallelism each model rank runs the same kernels on its ``hq / m`` query
heads and ``hkv / m`` KV heads; attention is independent per (batch, head), so no
collective is needed. Where the KV heads do not divide (one KV head included) each rank
runs its query heads against the KV heads they read (``rank_kv_heads``: sliced from the
whole, replicated k/v). Where the query heads do not divide, the JAX plan returns None
and JAX falls back to XLA attention on all heads; here the attention block runs whole on
every rank, through the same kernels on all heads (``parallel/sharding.py:units``).

``flash_attention_merged`` is the counterpart of the TPU's merged-lane kernels
(``_fwd_lanes_kernel``, ``_bwd_dkv_lanes_kernel``, ``_bwd_dq_lanes_kernel`` via
``_flash_lanes``): the same math on head-merged ``[B, T, H*D]`` tensors. The TPU needs
a second set of kernels for that layout; these kernels read any ``[B, T, H, D]`` strides,
so the merged tensor is passed as a view and the same three kernels serve it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from projectiontrainer_tpu_torch.kernels import _build
from projectiontrainer_tpu_torch.ops.attention import attention_probs, dot_product_attention, repeat_kv

launches = _build.LaunchCounter("flash_attn_fwd")
bwd_dkv_launches = _build.LaunchCounter("flash_attn_bwd_dkv")
bwd_dq_launches = _build.LaunchCounter("flash_attn_bwd_dq")
HEAD_DIMS = (64, 72, 128, 256, 512)
TMA_COLUMNS = 64  # bf16 columns of a 128-byte-swizzled TMA box
WIDE_STEP = 64      # above 512 the kernels take every multiple of this (csrc/flash_attn_wide.cu:CH)
WIDE_COLUMNS = 128  # output columns a CTA of the wide kernels owns (:DC)
WIDE_ROWS = 64      # rows a CTA of the wide kernels owns, and rows a tile of the other operand
# the cluster kernels (csrc/flash_attn_cluster.cu): 64 rows a cluster, ring stages of 32 rows
# of the other operand (16 in K4's and K5's two passes, where 32 would spill registers),
# CTAs of two consumer warpgroups, a warpgroup's slice of at most 256 columns of O (K1) or
# 128 of dK and dV (K4) or of dQ (K5: at 256 its CTA's Q and dO beside one ring stage would
# not fit an SM's shared memory) a pass; each kernel in up to 16 CTAs (the H100's
# non-portable cluster size, which the launch allows above the portable 8), K1 in one pass,
# K4 and K5 in up to two over the output columns, so all three reach 8192; `kind` names
# the kernel
CLUSTER_ROWS, CLUSTER_TILE = 64, 32
MAX_CLUSTER = 16
SLICE = {"fwd": 256, "dkv": 128, "dq": 128}
MAX_PASSES = {"fwd": 1, "dkv": 2, "dq": 2}
PASS_COLUMNS = {kind: 2 * MAX_CLUSTER * width for kind, width in SLICE.items()}
REACH = {kind: MAX_PASSES[kind] * cols for kind, cols in PASS_COLUMNS.items()}
SMEM_LIMIT = 232448  # bytes of shared memory a CTA can have on the H100
MAX_STAGES = 4


def takes_head_dim(d: int) -> bool:
    """Whether the kernels run at head dim d as it is: ``HEAD_DIMS``, or a multiple of
    ``WIDE_STEP`` above 512 (the wide kernels)."""
    return d in HEAD_DIMS or (d > max(HEAD_DIMS) and d % WIDE_STEP == 0)


def wide_plan(d: int, rows: str, tile: str) -> dict:
    """The wide kernels' plan at head dim d > 512: ``rows`` (the operand a CTA owns) and
    ``tile`` (the other, a tile of the loop) of ``WIDE_ROWS`` each; ``col_block`` output
    columns a CTA and ``col_blocks`` of them (the grid's x is row tiles x column blocks;
    the last block of a d that 128 does not divide holds 64 columns); each block computes
    the scores over the whole d in ``d / chunk`` chunks."""
    if not (d > max(HEAD_DIMS) and d % WIDE_STEP == 0):
        raise ValueError(f"flash_attention: head_dim {d} is not a wide kernel's (a multiple "
                         f"of {WIDE_STEP} above {max(HEAD_DIMS)})")
    return {rows: WIDE_ROWS, tile: WIDE_ROWS, "col_block": WIDE_COLUMNS,
            "col_blocks": -(-d // WIDE_COLUMNS), "chunk": WIDE_STEP}


def pass_slices(d: int, cluster: int, passes: int) -> list:
    """The columns of each warpgroup's slice of head dim d in each pass over the output
    columns, [pass][warpgroup]: the d / 64 column blocks dealt over the 2 x ``cluster`` x
    ``passes`` slots (CTA r, warpgroup w, pass p), d / 64 % slots of them one block wider,
    the lowest ranks (2 p + w) cluster + r first, so that the CTAs' shares differ by at most
    one block and CTA 0 holds the most (640 over 2 CTAs: 192, 128 | 192, 128). A CTA's
    slots lie in D warpgroup by warpgroup, pass by pass within each
    (``csrc/flash_attn_cluster.cu:Slices``)."""
    slots = 2 * cluster * passes
    base, extra = divmod(d // WIDE_STEP, slots)
    return [[WIDE_STEP * (base + ((2 * p + g % 2) * cluster + g // 2 < extra))
             for g in range(2 * cluster)] for p in range(passes)]


def cluster_smem(d: int, cluster: int, stages: int, kind: str, tile: int = CLUSTER_TILE,
                 passes: int = 1) -> int:
    """The dynamic shared memory of a cluster kernel's CTA (``csrc/flash_attn_cluster.cu:
    Layout``; ``kind`` "fwd", "dkv" or "dq": K1, K4 or K5): the resident operands of the
    widest CTA, its slices of every pass (K1: Q; K4: K and V; K5: Q and dO) of 64 rows,
    ``stages`` ring stages of two ``tile``-row operands (K and V; Q and dO in K4), both
    warpgroups' fp32 partial tiles, 16-byte chunks of one tensor in K1 (S^T and dP^T in K4,
    S and dP in K5): the pieces a CTA sums, one from each of the 2 x ``cluster``
    warpgroups, and the whole sum; K4's per-stage query statistics, 13 barriers, and 1024
    bytes to align the base."""
    widest = sum(s[0] + s[1] for s in pass_slices(d, cluster, passes)) // WIDE_STEP  # CTA 0's
    operands = 1 if kind == "fwd" else 2
    chunks = operands * CLUSTER_ROWS * tile // 4
    own = operands * widest * CLUSTER_ROWS * 128
    stage = 2 * widest * tile * 128
    exchange = 16 * (2 * cluster * -(-chunks // cluster) + chunks)
    stats = stages * 2 * tile * 4 if kind == "dkv" else 0
    return own + stages * stage + exchange + stats + 8 * (2 * MAX_STAGES + 5) + 1024


def cluster_plan(d: int, kind: str) -> dict:
    """A cluster kernel's plan at head dim d (a multiple of 64 above 512 and at most
    ``REACH[kind]``): ``cluster`` CTAs of two warpgroups, each warpgroup's slice of the
    columns in each of its ``passes`` passes over the output columns (``slices``: at most
    ``SLICE[kind]``, multiples of 64, 2 x ``cluster`` a pass, pass 0's first), the ring's
    rows (32) and ``stages`` (as many as fit, at most 4) and the CTA's shared memory
    (``smem``). Up to ``PASS_COLUMNS`` (8192 for K1, 4096 for K4 and K5) one pass in
    ceil(d / (2 ``SLICE``)) CTAs; K4 and K5 past 4096 run ceil(d / 4096) passes in 16 CTAs
    (route "cluster passes"), each warpgroup contracting the scores over its slices of
    every pass in each, so each score is formed ``passes`` times, on ring stages of 16
    rows. The kernel computes the same and refuses another plan."""
    passes = -(-d // PASS_COLUMNS[kind])
    cluster = MAX_CLUSTER if passes > 1 else -(-d // (2 * SLICE[kind]))
    tile = CLUSTER_TILE if passes == 1 else CLUSTER_TILE // 2
    stages = next(s for s in range(MAX_STAGES, 1, -1)
                  if cluster_smem(d, cluster, s, kind, tile, passes) <= SMEM_LIMIT)
    rows, ring = ("bk", "bq") if kind == "dkv" else ("bq", "bk")
    return {"route": "cluster" if passes == 1 else "cluster passes", rows: CLUSTER_ROWS,
            ring: tile, "cluster": cluster, "passes": passes,
            "slices": [w for ws in pass_slices(d, cluster, passes) for w in ws],
            "stages": stages, "smem": cluster_smem(d, cluster, stages, kind, tile, passes)}


def cluster_fit(d: int, kind: str) -> int:
    """How many clusters of ``kind``'s cluster kernel at head dim d (its plan's size, ring
    and shared memory) the card holds at once (``cudaOccupancyMaxActiveClusters``); 0
    where it cannot place one. Needs the card."""
    plan = cluster_plan(d, kind)
    tile = plan["bq" if kind == "dkv" else "bk"]
    return _build.library().flash_attn_cluster_fit(("fwd", "dkv", "dq").index(kind), d,
                                                   plan["cluster"], plan["stages"], tile)


def _wide_route(d: int, kind: str, rows: str, tile: str) -> dict:
    """Above 512: the cluster kernel within its reach (K4 and K5 in passes past 4096),
    the column blocks past it."""
    plan = wide_plan(d, rows, tile)  # raises at a width no wide kernel takes
    if d <= REACH[kind]:
        return cluster_plan(d, kind)
    return {"route": "column blocks", **plan}


def forward_plan(d: int) -> dict:
    """K1's tiles at head dim d: ``bq`` query rows a CTA (two warpgroups of 64) and
    ``bk`` keys a ring stage (64 at d = 256, where O alone is 128 registers a thread). At
    d = 512 the two warpgroups share 64 rows, each with half of O, and stages of 32 keys
    (two of them and Q fill 192 KB). Above 512 and up to ``REACH["fwd"]`` (8192) the
    cluster kernel (``cluster_plan``: ceil(d / 512) CTAs, 64 query rows a cluster, 32 keys
    a stage), past it the wide kernel's column blocks (``wide_plan``, with ``route``)."""
    if d > max(HEAD_DIMS):
        return _wide_route(d, "fwd", "bq", "bk")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not supported (takes {HEAD_DIMS} "
                         f"and multiples of {WIDE_STEP} above)")
    if d > 256:
        return {"bq": 64, "bk": 32}
    return {"bq": 128, "bk": 64 if d > 128 else 128}


def dkv_plan(d: int) -> dict:
    """K4's tiles at head dim d: ``bk`` keys a CTA and ``bq`` queries a ring stage. 128
    keys (two warpgroups of 64) and 64 queries at 64 and 72; 32 queries at 128, where dK
    and dV are 128 registers a thread; at 256 the two warpgroups share 64 keys and split
    the columns of dK and dV, again 128 registers a thread and 32 queries; at 512 two
    CTAs share the 64 keys, each with half of the columns (one stage of 32 queries).
    Above 512 and up to ``REACH["dkv"]`` (8192) the cluster kernel (``cluster_plan``: 64
    keys a cluster, 32 queries a stage; past 4096 two passes over the columns of dK and dV,
    16 queries a stage); past it the wide kernel's column blocks
    (``wide_plan``, with ``route``): a CTA's 64 keys and 128 columns of dK and dV, over
    tiles of 64 queries."""
    if d > max(HEAD_DIMS):
        return _wide_route(d, "dkv", "bk", "bq")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not supported (takes {HEAD_DIMS} "
                         f"and multiples of {WIDE_STEP} above)")
    return {"bk": 64 if d > 128 else 128, "bq": 64 if d <= 72 else 32}


def dq_plan(d: int) -> dict:
    """K5's tiles at head dim d: ``bq`` queries a CTA (two warpgroups of 64) and ``bk``
    keys a ring stage: 64, and 32 at d = 256, where dQ alone is 128 registers a thread
    and S and dP of 64 keys would not fit beside it. At d = 512 the two warpgroups share
    64 queries, each with half of dQ (one stage of 32 keys). Above 512 and up to
    ``REACH["dq"]`` (8192) the cluster kernel (``cluster_plan``: 64 queries a cluster, 32
    keys a stage, as K1; past 4096 two passes over the columns of dQ, 16 keys a stage);
    past it the wide kernel's column blocks (``wide_plan``, with ``route``)."""
    if d > max(HEAD_DIMS):
        return _wide_route(d, "dq", "bq", "bk")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not supported (takes {HEAD_DIMS} "
                         f"and multiples of {WIDE_STEP} above)")
    return {"bq": 64 if d > 256 else 128, "bk": 32 if d > 128 else 64}


def kv_tile_range(q0: int, bq: int, bk: int, t: int, causal: bool, window: Optional[int]):
    """[begin, end) of the K/V tiles of ``bk`` keys that the query rows q0 .. q0 + bq - 1
    of a length-t sequence visit: tiles wholly above the diagonal (causal) or wholly
    below the window are left out."""
    end = -(-t // bk)
    if causal:
        end = min(end, (q0 + bq - 1) // bk + 1)
    begin = max(0, q0 - window + 1) // bk if window else 0
    return begin, end


def q_tile_range(k0: int, bk: int, bq: int, t: int, causal: bool, window: Optional[int]):
    """[begin, end) of the query tiles of ``bq`` rows that can see a key of k0 ..
    k0 + bk - 1: K4's loop for one key tile."""
    lo = k0 if causal else 0
    hi = min(t, k0 + bk - 1 + window) if window else t
    return lo // bq, -(-hi // bq)


def tensor_map_plan(x, box_rows: int) -> list:
    """The 4-D tensor map of a [B, T, H, D] bf16 tensor with unit stride on D, as 11
    numbers: dims (D, T, H, B), byte strides of (T, H, B), box (columns, rows, 1, 1).
    D is a dimension of its own, so a 64-column box that runs past D (head dim 72) is
    zero-filled instead of reading the next head, and so is a box that runs past T. A
    merged or sliced view differs only in its strides; an axis of size 1 gets a dense
    stride, whatever the tensor says of it."""
    b, t, h, d = x.shape
    sb, st, sh, _ = x.stride()
    sh = sh if h > 1 else d
    st = st if t > 1 else h * sh
    sb = sb if b > 1 else t * st
    return [d, t, h, b, 2 * st, 2 * sh, 2 * sb, min(TMA_COLUMNS, d), box_rows, 1, 1]


def flash_attention_reference(q, k, v, *, scale: Optional[float] = None,
                              causal: bool = False, window: Optional[int] = None,
                              kv_mask=None):
    """The plain forward: ``attention.dot_product_attention`` plus the fp32 lse."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out = dot_product_attention(q, k, v, scale=scale, causal=causal, window=window,
                                kv_mask=kv_mask)
    logits, _ = attention_probs(q, k, scale=scale, causal=causal, window=window,
                                kv_mask=kv_mask)
    return out, torch.logsumexp(logits, dim=-1)


def flash_attention_bwd_reference(q, k, v, kv_mask, out, lse, do, *,
                                  scale: Optional[float] = None, causal: bool = False,
                                  window: Optional[int] = None):
    """The plain backward, FlashAttention-2's formulas written out in fp32:

        P = exp(S - lse) on valid (query, key) pairs, 0 elsewhere;
        dV = P^T dO;  dP = dO V^T;  dS = P * (dP - delta),  delta = rowsum(dO * O);
        dQ = scale * dS K;  dK = scale * dS^T Q;

    under GQA, dK and dV are summed over the query heads that share a KV head.
    Returns (dq, dk, dv) in the dtypes of q, k and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    n_rep = hq // hkv
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * out.float()).sum(-1).transpose(1, 2)  # [B, Hq, T]
    logits, valid = attention_probs(qf, kf, scale=scale, causal=causal, window=window,
                                    kv_mask=kv_mask)
    p = torch.where(valid, torch.exp(logits - lse.float()[..., None]), 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, repeat_kv(vf, n_rep))
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, repeat_kv(kf, n_rep)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dk = dk.reshape(b, t, hkv, n_rep, d).sum(3)
    dv = dv.reshape(b, t, hkv, n_rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(name, x, ndim):
    if not _build.on_card(x):
        raise ValueError(f"flash_attention: {name} is not on the card")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: {name} must be bf16 on the card, got {x.dtype}")
    if x.dim() != ndim or x.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} must be {ndim}-D with unit stride on D")
    if any(s % 8 for s in x.stride()[:-1]):
        raise ValueError(f"flash_attention: {name} rows must be 16-byte aligned")


def _check_pointers(**tensors):
    """The operators' own check: the TMA unit reads from 16-byte aligned addresses (a
    fake tensor has none, so the wrappers leave this to the launch)."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} rows must be 16-byte aligned")


def _check_shapes(q, k, v):
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, 4)
    if k.shape != (b, t, hkv, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: self-attention shapes only, got q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if not takes_head_dim(d) or hq % hkv:
        raise ValueError(f"flash_attention: head_dim {d} (takes {HEAD_DIMS} and multiples "
                         f"of {WIDE_STEP} above) or GQA {hq}/{hkv} not supported")


def _mask_arg(kv_mask, q):
    if kv_mask is None:
        return None
    mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
    if mask.shape != q.shape[:2]:
        raise ValueError(f"flash_attention: kv_mask must be [B, T], got {tuple(mask.shape)}")
    return mask


def _ptr(x):
    return None if x is None else x.data_ptr()


def fwd_buffers(q, out_f32: bool = False) -> dict:
    """What one K1 launch on q writes, name -> (shape, dtype): O in q's type, the fp32
    lse [B, Hq, T] and, when a backward follows, O in fp32."""
    b, t, hq, d = q.shape
    bufs = {"out": ((b, t, hq, d), q.dtype), "lse": ((b, hq, t), torch.float32)}
    if out_f32:
        bufs["out32"] = ((b, t, hq, d), torch.float32)
    return bufs


def dkv_buffers(q, k) -> dict:
    """What one K4 launch writes: dK and dV in k's type and shape."""
    return {"dk": (tuple(k.shape), k.dtype), "dv": (tuple(k.shape), k.dtype)}


def dq_buffers(q) -> dict:
    """What one K5 launch writes: dQ in q's type and shape."""
    return {"dq": (tuple(q.shape), q.dtype)}


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _strides(*tensors):
    """The (b, t, h) element strides of each tensor, as one ``long long`` array."""
    flat = [s for x in tensors for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _fwd_launch(q, k, v, mask, out, lse, out32, scale, causal, window):
    """K1's operator on the card: ``out``, ``lse`` and ``out32`` (or None) written (above
    512 by the cluster kernel, or past its reach by the column blocks, which read the
    strides alone)."""
    _check_pointers(q=q, k=k, v=v)
    b, t, hq, d = q.shape
    plan = forward_plan(d)
    if plan.get("route") == "column blocks":
        name, layout = "flash_attn_wide_fwd_bf16", (_strides(q, k, v, out),)
    else:
        maps = (ctypes.c_longlong * 33)(*tensor_map_plan(q, plan["bq"]),
                                        *tensor_map_plan(k, plan["bk"]),
                                        *tensor_map_plan(v, plan["bk"]))
        name, tiles = (("flash_attn_cluster_fwd_bf16", (plan["cluster"], plan["stages"]))
                       if plan.get("route") == "cluster" else
                       ("flash_attn_fwd_bf16", (plan["bq"], plan["bk"])))
        layout = (maps, *tiles, *out.stride()[:3])
    err = getattr(_build.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), out.data_ptr(), lse.data_ptr(),
        _ptr(out32), b, t, hq, k.shape[2], d, *layout, scale, int(causal), window, _stream(q))
    _build.check(name, err)
    launches.add()


def _bwd_maps(q, k, v, do, plan):
    """The tensor maps of q, k, v and dO for a backward kernel's tiles (long long[44])."""
    return (ctypes.c_longlong * 44)(*tensor_map_plan(q, plan["bq"]), *tensor_map_plan(k, plan["bk"]),
                                    *tensor_map_plan(v, plan["bk"]), *tensor_map_plan(do, plan["bq"]))


def _bwd_route(q, k, v, do, plan, kernel: str, tiles: tuple) -> tuple:
    """A backward kernel's entry point (``kernel``: "dkv" or "dq") and its plan's
    arguments: the column blocks read the strides alone; the cluster kernel (in one pass or
    more) and the kernel at 512 and below the tensor maps and the cluster, ring and ring
    tile (``tiles[1]``), or the tiles ``tiles``."""
    route = plan.get("route")
    if route == "column blocks":
        return f"flash_attn_wide_bwd_{kernel}_bf16", ()
    maps = _bwd_maps(q, k, v, do, plan)
    if route in ("cluster", "cluster passes"):
        return (f"flash_attn_cluster_bwd_{kernel}_bf16",
                (maps, plan["cluster"], plan["stages"], plan[tiles[1]]))
    return f"flash_attn_bwd_{kernel}_bf16", (maps, *(plan[n] for n in tiles))


def _dkv_launch(q, k, v, mask, do, lse, delta, dk, dv, scale, causal, window):
    """K4's operator on the card: ``dk`` and ``dv`` written (above 512 by the cluster
    kernel, in passes past 4096, or past its reach by the column blocks)."""
    _check_pointers(q=q, k=k, v=v, dout=do)
    b, t, hq, d = q.shape
    name, tiles = _bwd_route(q, k, v, do, dkv_plan(d), "dkv", ("bk", "bq"))
    err = getattr(_build.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, hq, k.shape[2], d,
        _strides(q, k, v, do, dk, dv), *tiles, scale, int(causal), window, _stream(q))
    _build.check(name, err)
    bwd_dkv_launches.add()


def _dq_launch(q, k, v, mask, do, lse, delta, dq, scale, causal, window):
    """K5's operator on the card: ``dq`` written (above 512 by the cluster kernel, in
    passes past 4096, or past its reach by the column blocks)."""
    _check_pointers(q=q, k=k, v=v, dout=do)
    b, t, hq, d = q.shape
    name, tiles = _bwd_route(q, k, v, do, dq_plan(d), "dq", ("bq", "bk"))
    err = getattr(_build.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, t, hq, k.shape[2], d, _strides(q, k, v, do, dq),
        *tiles, scale, int(causal), window, _stream(q))
    _build.check(name, err)
    bwd_dq_launches.add()


_ARGS = "Tensor q, Tensor k, Tensor v, Tensor? mask"
_OPTS = "float scale, bool causal, int window"
FWD_OP = _build.kernel_op(
    "flash_attn_fwd", f"({_ARGS}, Tensor(a!) out, Tensor(b!) lse, Tensor(c!)? out32, "
    f"{_OPTS}) -> ()", _fwd_launch)
DKV_OP = _build.kernel_op(
    "flash_attn_bwd_dkv", f"({_ARGS}, Tensor dout, Tensor lse, Tensor delta, Tensor(a!) dk, "
    f"Tensor(b!) dv, {_OPTS}) -> ()", _dkv_launch)
DQ_OP = _build.kernel_op(
    "flash_attn_bwd_dq", f"({_ARGS}, Tensor dout, Tensor lse, Tensor delta, Tensor(a!) dq, "
    f"{_OPTS}) -> ()", _dq_launch)


def _launch(q, k, v, *, scale, causal, window, kv_mask, out_f32: bool = False):
    """K1 -> (out, lse, fp32 copy of out or None)."""
    _check_shapes(q, k, v)
    if not scale > 0:
        raise ValueError(f"flash_attention: scale must be positive, got {scale}")
    mask = _mask_arg(kv_mask, q)
    bufs = _build.allocate(fwd_buffers(q, out_f32), q.device)
    FWD_OP(q, k, v, mask, bufs["out"], bufs["lse"], bufs.get("out32"), float(scale),
           bool(causal), int(window or 0))
    return bufs["out"], bufs["lse"], bufs.get("out32")


def prepare_bwd(q, k, v, kv_mask, out, lse, do):
    """Check the backward's CUDA inputs -> (int32 mask or None, contiguous dO, delta):
    ``delta = rowsum(dO * O)`` [B, Hq, T] fp32, computed in plain torch as the JAX
    package does outside its kernels. ``out`` may be the forward's fp32 copy of O."""
    b, t, hq, _ = q.shape
    do = do.contiguous()
    _check_shapes(q, k, v)
    _check("dout", do, 4)
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"flash_attention: out/dout must be {tuple(q.shape)}")
    if lse.shape != (b, hq, t) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention: lse must be contiguous fp32 [B, Hq, T]")
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return _mask_arg(kv_mask, q), do, delta


def launch_bwd_dkv(q, k, v, mask, do, lse, delta, *, scale, causal, window):
    """K4 on prepared inputs (``prepare_bwd``) -> (dk, dv)."""
    bufs = _build.allocate(dkv_buffers(q, k), q.device)
    DKV_OP(q, k, v, mask, do, lse, delta, bufs["dk"], bufs["dv"], float(scale), bool(causal),
           int(window or 0))
    return bufs["dk"], bufs["dv"]


def launch_bwd_dq(q, k, v, mask, do, lse, delta, *, scale, causal, window):
    """K5 on prepared inputs (``prepare_bwd``) -> dq."""
    dq = _build.allocate(dq_buffers(q), q.device)["dq"]
    DQ_OP(q, k, v, mask, do, lse, delta, dq, float(scale), bool(causal), int(window or 0))
    return dq


def flash_attention_bwd(q, k, v, kv_mask, out, lse, do, *, scale: Optional[float] = None,
                        causal: bool = False, window: Optional[int] = None):
    """(dq, dk, dv): the two backward kernels on CUDA tensors (dK/dV, then dQ), the
    plain version on CPU tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kw = dict(scale=scale, causal=causal, window=window)
    if not _build.on_card(q):
        if q.device.type != "cpu":
            raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
        return flash_attention_bwd_reference(q, k, v, kv_mask, out, lse, do, **kw)
    mask, do, delta = prepare_bwd(q, k, v, kv_mask, out, lse, do)
    dk, dv = launch_bwd_dkv(q, k, v, mask, do, lse, delta, **kw)
    return launch_bwd_dq(q, k, v, mask, do, lse, delta, **kw), dk, dv


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale, causal, window):
        if _build.on_card(q):
            out, lse, out32 = _launch(q, k, v, scale=scale, causal=causal, window=window,
                                      kv_mask=kv_mask, out_f32=any(ctx.needs_input_grad[:3]))
        elif q.device.type == "cpu":
            out, lse = flash_attention_reference(q, k, v, scale=scale, causal=causal,
                                                 window=window, kv_mask=kv_mask)
            out32 = None
        else:
            raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
        # delta = rowsum(dO * O) is taken from the fp32 copy where there is one
        ctx.save_for_backward(q, k, v, kv_mask, out if out32 is None else out32, lse)
        ctx.mark_non_differentiable(lse)
        ctx.opts = dict(scale=scale, causal=causal, window=window)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, out, lse, dout, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, scale: Optional[float] = None, causal: bool = False,
                    window: Optional[int] = None, kv_mask=None):
    """q [B, T, Hq, D], k/v [B, T, Hkv, D] -> (out [B, T, Hq, D], lse [B, Hq, T]).

    The kernels on CUDA tensors (a head dim they do not take zero-padded to the next
    one, ``flash_attention_padded``), the plain versions on CPU tensors; differentiable
    in ``out`` with respect to q, k and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _build.on_card(q) and not takes_head_dim(q.shape[-1]):
        return flash_attention_padded(q, k, v, scale=scale, causal=causal, window=window,
                                      kv_mask=kv_mask)
    return _FlashAttention.apply(q, k, v, kv_mask, float(scale), bool(causal), window)


def padded_head_dim(d: int, widths=HEAD_DIMS, step: int = WIDE_STEP) -> int:
    """The smallest of ``widths`` at or above head dim d; above the largest, d rounded
    up to a multiple of ``step`` (the wide kernels' widths)."""
    for w in sorted(widths):
        if w >= d:
            return w
    return -(-d // step) * step


def pad_head_dim(x, width: int):
    """``x`` zero-padded on its last axis to ``width`` (``x`` itself at that width)."""
    d = x.shape[-1]
    return x if d == width else F.pad(x, (0, width - d))


def flash_attention_padded(q, k, v, *, scale: Optional[float] = None, causal: bool = False,
                           window: Optional[int] = None, kv_mask=None):
    """``flash_attention`` at a head dim D the kernels do not take: q, k and v
    zero-padded on D to :func:`padded_head_dim`, the attention run
    there with the caller's scale (default D ** -0.5, not the padded width's), O sliced
    back to D and lse as it comes. The zero columns add nothing to q.k and give zero
    columns of O, dQ, dK and dV, which the pad's backward drops. The JAX package pads
    the same way inside its kernel (``ops/flash_attention.py:flash_attention`` there).
    On CPU tensors the plain versions run at the padded width."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    width = padded_head_dim(d)
    out, lse = _FlashAttention.apply(pad_head_dim(q, width), pad_head_dim(k, width),
                                     pad_head_dim(v, width), kv_mask, float(scale),
                                     bool(causal), window)
    return out[..., :d], lse


def rank_kv_heads(hq: int, hkv: int, model: int, rank: int) -> Optional[list]:
    """The KV heads that the query heads of model rank ``rank`` of ``model`` read, where
    the query heads divide over the ranks and the KV heads do not (one KV head
    included): rank r holds query heads r hq/m ... (r + 1) hq/m - 1, and query head j
    reads KV head j // (hq / hkv). A run of KV heads where the rank's query heads are a
    uniform GQA grouping of it; else one KV head a query head (the list repeats heads).
    None where the KV heads split with the query heads, or the query heads do not
    divide (the attention is whole)."""
    if model == 1 or hq % model or (hkv != 1 and hkv % model == 0):
        return None
    hq_l, group = hq // model, hq // hkv
    read = [j // group for j in range(rank * hq_l, (rank + 1) * hq_l)]
    n = read[-1] - read[0] + 1
    if hq_l % n == 0 and read == [read[0] + i // (hq_l // n) for i in range(hq_l)]:
        return list(range(read[0], read[0] + n))
    return read


def sharded_flash_plan(hq: int, hkv: int, model: int, rank: int) -> tuple[int, int]:
    """(query heads, KV heads) of model rank ``rank`` of ``model``: the query heads and
    the KV heads split over the ranks; the KV heads the rank's query heads read where
    the KV heads do not divide (:func:`rank_kv_heads`); all heads where the query heads
    do not divide (the JAX plan's None: the attention runs whole on every rank)."""
    if model == 1 or hq % model:
        return hq, hkv
    kv = rank_kv_heads(hq, hkv, model, rank)
    return hq // model, hkv // model if kv is None else len(kv)


def sharded_flash_attention(q, k, v, *, heads: tuple[int, int], model: int, rank: int, **kw):
    """``flash_attention`` on one model rank's heads: q, k/v [B, T, heads, D] of a model
    with ``heads`` = (hq, hkv) over ``model`` ranks, held to :func:`sharded_flash_plan`
    for rank ``rank``."""
    hq_l, hkv_l = sharded_flash_plan(*heads, model, rank)
    if q.shape[2] != hq_l or k.shape[2] != hkv_l or v.shape[2] != hkv_l:
        raise ValueError(f"sharded flash attention: heads {q.shape[2]}/{k.shape[2]} on a "
                         f"rank, the plan of {heads} over {model} says {hq_l}/{hkv_l}")
    return flash_attention(q, k, v, **kw)


def _split_heads(x, heads: int):
    """[B, T, H*D] -> a [B, T, H, D] view of the same storage (no copy)."""
    b, t, hd = x.shape
    if hd % heads:
        raise ValueError(f"flash_attention_merged: last axis {hd} is not {heads} heads")
    view = x.view(b, t, heads, hd // heads)
    assert view.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    return view


def flash_attention_merged(qm, km, vm, *, heads: int, kv_heads: int,
                           scale: Optional[float] = None):
    """Non-causal, unmasked attention on head-merged tensors: qm [B, T, Hq*D], km/vm
    [B, T, Hkv*D] -> [B, T, Hq*D], differentiable in qm, km and vm.

    The counterpart of the JAX package's ``_flash_lanes``: the inputs are viewed as
    [B, T, H, D] without a copy and run through ``flash_attention`` (the K1 forward and
    K4/K5 backward kernels on CUDA tensors), so there is no gate; a head dim the kernels
    do not take is padded there like any other."""
    q, k, v = _split_heads(qm, heads), _split_heads(km, kv_heads), _split_heads(vm, kv_heads)
    out, _ = flash_attention(q, k, v, scale=scale)
    return out.reshape(qm.shape)
