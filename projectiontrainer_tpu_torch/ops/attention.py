"""Plain multi-head attention with GQA, causal / sliding-window masks and key padding.

Counterpart of ``projectiontrainer_tpu/ops/attention.py`` and the oracle of the
attention kernels (``ops/flash_attention.py``, ``ops/decode_attention.py``): scores and
softmax in fp32, probabilities cast to the query's type before the PV product, and
rows with no valid key give ZERO output (not the uniform average a softmax over all
``NEG_INF`` would give).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.3819763e38  # finite mask fill, as in the JAX package


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, T, Hkv, D] -> [B, T, Hkv * n_rep, D]: query head h reads kv head h // n_rep."""
    return x if n_rep == 1 else x.repeat_interleave(n_rep, dim=2)


def make_attention_mask(q_len: int, kv_len: int, *, causal: bool,
                        window: Optional[int] = None, q_offset: int = 0,
                        device=None) -> torch.Tensor:
    """Bool [q_len, kv_len] of allowed positions; a window admits keys with
    ``q_pos - window < k_pos`` (the previous ``window`` tokens, self included)."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    return mask


def attention_probs(q, k, *, scale, causal=False, window=None, kv_mask=None, q_offset=0):
    """Masked fp32 scores [B, H, Tq, Tk] and the validity mask broadcast to them."""
    _, tq, hq, _ = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    k = repeat_kv(k, hq // hkv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = make_attention_mask(tq, tk, causal=causal, window=window, q_offset=q_offset,
                               device=q.device)[None, None]
    if kv_mask is not None:
        mask = mask & kv_mask.bool()[:, None, None, :]
    return logits.masked_fill(~mask, NEG_INF), mask


def dot_product_attention(
    q: torch.Tensor,  # [B, Tq, Hq, D]
    k: torch.Tensor,  # [B, Tk, Hkv, D]
    v: torch.Tensor,  # [B, Tk, Hkv, D]
    *,
    scale: Optional[float] = None,
    causal: bool = False,
    window: Optional[int] = None,
    kv_mask: Optional[torch.Tensor] = None,  # [B, Tk] bool/int key padding mask
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention -> [B, Tq, Hq, D] in q's dtype. GQA when Hq > Hkv (must divide)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits, mask = attention_probs(q, k, scale=scale, causal=causal, window=window,
                                   kv_mask=kv_mask, q_offset=q_offset)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0).to(q.dtype)
    v = repeat_kv(v, q.shape[2] // k.shape[2])
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)
