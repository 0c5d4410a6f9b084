"""Flash-attention forward: the CUDA kernel ``csrc/flash_attn_fwd.cu`` for CUDA
tensors, its plain version for CPU ones.

Counterpart of ``projectiontrainer_tpu/ops/flash_attention.py`` (``_fwd`` /
``_fwd_kernel``). It returns ``(out, lse)`` like ``_fwd`` does, so the backward can
reuse the forward's per-row log-sum-exp: ``out`` [B, T, Hq, D] in q's dtype and ``lse``
[B, Hq, T] fp32 in natural-log units. The lse of a row with no valid key is not
defined beyond being very negative; such rows output 0.

Self-attention shapes only (``Tq == Tk``): the tower (non-causal) and the decoder's
prefill (causal, sliding window, left-padding mask, GQA). Head dims 64, 128 and 256.
"""

from __future__ import annotations

from typing import Optional

import torch

from projectiontrainer_tpu_torch.kernels import _build
from projectiontrainer_tpu_torch.ops.attention import attention_probs, dot_product_attention

launches = _build.LaunchCounter("flash_attn_fwd")
HEAD_DIMS = (64, 128, 256)


def flash_attention_reference(q, k, v, *, scale: Optional[float] = None,
                              causal: bool = False, window: Optional[int] = None,
                              kv_mask=None):
    """The plain version: ``attention.dot_product_attention`` plus the fp32 lse."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out = dot_product_attention(q, k, v, scale=scale, causal=causal, window=window,
                                kv_mask=kv_mask)
    logits, _ = attention_probs(q, k, scale=scale, causal=causal, window=window,
                                kv_mask=kv_mask)
    return out, torch.logsumexp(logits, dim=-1)


def _check(name, x, ndim):
    if not x.is_cuda:
        raise ValueError(f"flash_attention: {name} is not on the card")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: {name} must be bf16 on the card, got {x.dtype}")
    if x.dim() != ndim or x.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} must be {ndim}-D with unit stride on D")
    if x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:-1]):
        raise ValueError(f"flash_attention: {name} rows must be 16-byte aligned")


def _launch(q, k, v, *, scale, causal, window, kv_mask):
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
    mask = None
    if kv_mask is not None:
        mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
        if mask.shape != (b, t):
            raise ValueError(f"flash_attention: kv_mask must be [B, T], got {tuple(mask.shape)}")
    lib = _build.library()
    out = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    err = lib.flash_attn_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, t, hq, hkv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), int(causal), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_attn_fwd_bf16", err)
    launches.add()
    return out, lse


def flash_attention(q, k, v, *, scale: Optional[float] = None, causal: bool = False,
                    window: Optional[int] = None, kv_mask=None):
    """q [B, T, Hq, D], k/v [B, T, Hkv, D] -> (out [B, T, Hq, D], lse [B, Hq, T]).

    The kernel on CUDA tensors, the plain version on CPU tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _launch(q, k, v, scale=scale, causal=causal, window=window, kv_mask=kv_mask)
    if q.device.type != "cpu":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    return flash_attention_reference(q, k, v, scale=scale, causal=causal, window=window,
                                     kv_mask=kv_mask)
