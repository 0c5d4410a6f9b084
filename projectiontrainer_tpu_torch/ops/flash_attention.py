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
(causal, sliding window, padding mask, GQA). Head dims 64, 72 (so400m; the kernels fill
its rows up with zeros on the chip, nothing is padded here), 128 and 256.

What a launch decides on the host is in plain functions here, which the CPU tests
reach: the tiles of each kernel by head dim (``forward_plan``, ``dkv_plan``), the K/V
tiles a query tile visits and the query tiles a key tile visits under the causal mask
and the window (``kv_tile_range``, ``q_tile_range``; the kernels compute the same
bounds), and the 4-D tensor map of a strided ``[B, T, H, D]`` tensor
(``tensor_map_plan``), through which the TMA unit reads q, k and v as they lie.

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

from projectiontrainer_tpu_torch.kernels import _build
from projectiontrainer_tpu_torch.ops.attention import attention_probs, dot_product_attention, repeat_kv

launches = _build.LaunchCounter("flash_attn_fwd")
bwd_dkv_launches = _build.LaunchCounter("flash_attn_bwd_dkv")
bwd_dq_launches = _build.LaunchCounter("flash_attn_bwd_dq")
HEAD_DIMS = (64, 72, 128, 256)
TMA_COLUMNS = 64  # bf16 columns of a 128-byte-swizzled TMA box


def forward_plan(d: int) -> dict:
    """K1's tiles at head dim d: ``bq`` query rows a CTA (two warpgroups of 64) and
    ``bk`` keys a ring stage (64 at d = 256, where O alone is 128 registers a thread)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not supported (takes {HEAD_DIMS})")
    return {"bq": 128, "bk": 64 if d > 128 else 128}


def dkv_plan(d: int) -> dict:
    """K4's tiles at head dim d: ``bk`` keys a CTA and ``bq`` queries a ring stage. 128
    keys (two warpgroups of 64) and 64 queries at 64 and 72; 32 queries at 128, where dK
    and dV are 128 registers a thread; at 256 the two warpgroups share 64 keys and split
    the columns of dK and dV, again 128 registers a thread and 32 queries."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not supported (takes {HEAD_DIMS})")
    return {"bk": 64 if d > 128 else 128, "bq": 64 if d <= 72 else 32}


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
    if not x.is_cuda:
        raise ValueError(f"flash_attention: {name} is not on the card")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: {name} must be bf16 on the card, got {x.dtype}")
    if x.dim() != ndim or x.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} must be {ndim}-D with unit stride on D")
    if x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:-1]):
        raise ValueError(f"flash_attention: {name} rows must be 16-byte aligned")


def _check_shapes(q, k, v):
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, 4)
    if k.shape != (b, t, hkv, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: self-attention shapes only, got q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in HEAD_DIMS or hq % hkv:
        raise ValueError(f"flash_attention: head_dim {d} (takes {HEAD_DIMS}) or GQA "
                         f"{hq}/{hkv} not supported")


def _mask_arg(kv_mask, q):
    if kv_mask is None:
        return None
    mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
    if mask.shape != q.shape[:2]:
        raise ValueError(f"flash_attention: kv_mask must be [B, T], got {tuple(mask.shape)}")
    return mask


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(q, k, v, *, scale, causal, window, kv_mask, out_f32: bool = False):
    """K1 -> (out, lse, fp32 copy of out or None)."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    _check_shapes(q, k, v)
    if not scale > 0:
        raise ValueError(f"flash_attention: scale must be positive, got {scale}")
    mask = _mask_arg(kv_mask, q)
    plan = forward_plan(d)
    maps = (ctypes.c_longlong * 33)(*tensor_map_plan(q, plan["bq"]),
                                    *tensor_map_plan(k, plan["bk"]),
                                    *tensor_map_plan(v, plan["bk"]))
    lib = _build.library()
    out = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    out32 = torch.empty((b, t, hq, d), dtype=torch.float32, device=q.device) if out_f32 else None
    err = lib.flash_attn_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), out.data_ptr(), lse.data_ptr(),
        _ptr(out32), b, t, hq, hkv, d, maps, plan["bq"], plan["bk"], *out.stride()[:3],
        float(scale), int(causal), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_attn_fwd_bf16", err)
    launches.add()
    return out, lse, out32


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
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    plan = dkv_plan(d)
    dk = torch.empty((b, t, hkv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, t, hkv, d), dtype=v.dtype, device=q.device)
    strides = (ctypes.c_longlong * 18)(*(s for x in (q, k, v, do, dk, dv) for s in x.stride()[:3]))
    maps = (ctypes.c_longlong * 44)(*tensor_map_plan(q, plan["bq"]), *tensor_map_plan(k, plan["bk"]),
                                    *tensor_map_plan(v, plan["bk"]), *tensor_map_plan(do, plan["bq"]))
    err = _build.library().flash_attn_bwd_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, hq, hkv, d, strides, maps,
        plan["bk"], plan["bq"], float(scale), int(causal), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attn_bwd_dkv_bf16", err)
    bwd_dkv_launches.add()
    return dk, dv


def launch_bwd_dq(q, k, v, mask, do, lse, delta, *, scale, causal, window):
    """K5 on prepared inputs (``prepare_bwd``) -> dq."""
    b, t, hq, d = q.shape
    dq = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 15)(*(s for x in (q, k, v, do, dq) for s in x.stride()[:3]))
    err = _build.library().flash_attn_bwd_dq_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, t, hq, k.shape[2], d, strides,
        float(scale), int(causal), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attn_bwd_dq_bf16", err)
    bwd_dq_launches.add()
    return dq


def flash_attention_bwd(q, k, v, kv_mask, out, lse, do, *, scale: Optional[float] = None,
                        causal: bool = False, window: Optional[int] = None):
    """(dq, dk, dv): the two backward kernels on CUDA tensors (dK/dV, then dQ), the
    plain version on CPU tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kw = dict(scale=scale, causal=causal, window=window)
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
        return flash_attention_bwd_reference(q, k, v, kv_mask, out, lse, do, **kw)
    mask, do, delta = prepare_bwd(q, k, v, kv_mask, out, lse, do)
    dk, dv = launch_bwd_dkv(q, k, v, mask, do, lse, delta, **kw)
    return launch_bwd_dq(q, k, v, mask, do, lse, delta, **kw), dk, dv


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale, causal, window):
        if q.is_cuda:
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

    The kernels on CUDA tensors, the plain versions on CPU tensors; differentiable
    in ``out`` with respect to q, k and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, kv_mask, float(scale), bool(causal), window)


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
    K4/K5 backward kernels on CUDA tensors), so there is no gate and no pad."""
    q, k, v = _split_heads(qm, heads), _split_heads(km, kv_heads), _split_heads(vm, kv_heads)
    out, _ = flash_attention(q, k, v, scale=scale)
    return out.reshape(qm.shape)
