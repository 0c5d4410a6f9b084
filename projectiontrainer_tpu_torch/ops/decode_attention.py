"""Single-token decode attention over a split prefix / generated KV cache: the CUDA
kernel ``csrc/decode_attention.cu`` for CUDA tensors, its plain version for CPU ones.

Counterpart of ``projectiontrainer_tpu/ops/decode_attention.py``. The caches are
head-major like the JAX package's: a prefix cache ``[B, Hkv, P, D]`` shared by every
beam of a sample and never reordered, and a generated cache ``[R, Hkv, G, D]`` with
one row per beam (R = B * beams). Keys are masked by the prefix padding mask, the
generated ones by ``j <= t``, and a sliding window counts cache slots with the query
at ``prefix_len + t``.

Unlike the TPU kernel, the CUDA kernel masks its own edges, so P and G need no
padding to a multiple of 128 (``generate/decode.py:_cache_pad`` is 1).
"""

from __future__ import annotations

from typing import Optional

import torch

from projectiontrainer_tpu_torch.kernels import _build
from projectiontrainer_tpu_torch.ops.attention import NEG_INF

launches = _build.LaunchCounter("decode_attn")
HEAD_DIMS = (64, 128, 256)
MAX_ROWS = 64  # nb * n_rep query rows one CTA holds in shared memory


def _shapes(q, kp, kg):
    r, hq, d = q.shape
    b, hkv, p, _ = kp.shape
    g = kg.shape[2]
    if r % b:
        raise ValueError(f"rows {r} not a multiple of batch {b}")
    return r, hq, d, b, p, hkv, g, r // b, hq // hkv


def decode_attention_reference(q, kp, vp, kg, vg, *, prefix_mask, t: int, prefix_len: int,
                               scale: float, window: Optional[int] = None):
    """The plain version (JAX ``_xla_decode_attention``): fp32 scores and softmax over
    [prefix; generated], probabilities cast to q's dtype before the PV products."""
    r, hq, d, b, p, hkv, g, nb, n_rep = _shapes(q, kp, kg)
    q5 = q.float().reshape(b, nb, hkv, n_rep, d)
    kg5 = kg.float().reshape(b, nb, hkv, g, d)
    vg5 = vg.float().reshape(b, nb, hkv, g, d)
    sp = torch.einsum("bnkrd,bkpd->bnkrp", q5, kp.float()) * scale
    sg = torch.einsum("bnkrd,bnkgd->bnkrg", q5, kg5) * scale

    pidx = torch.arange(p, device=q.device)
    gidx = torch.arange(g, device=q.device)
    validp = prefix_mask.bool()[:, None, None, None, :]
    validg = gidx <= t
    if window is not None:
        q_slot = prefix_len + t
        validp = validp & (pidx > q_slot - window)
        validg = validg & (gidx > t - window)
    sp = sp.masked_fill(~validp, NEG_INF)
    sg = sg.masked_fill(~validg, NEG_INF)

    probs = torch.softmax(torch.cat([sp, sg], dim=-1), dim=-1).to(q.dtype).float()
    out = torch.einsum("bnkrp,bkpd->bnkrd", probs[..., :p], vp.float())
    out = out + torch.einsum("bnkrg,bnkgd->bnkrd", probs[..., p:], vg5)
    return out.to(q.dtype).reshape(r, hq, d)


def _launch(q, kp, vp, kg, vg, *, prefix_mask, t, prefix_len, scale, window):
    r, hq, d, b, p, hkv, g, nb, n_rep = _shapes(q, kp, kg)
    q = q.contiguous()
    for name, x in (("q", q), ("kp", kp), ("vp", vp), ("kg", kg), ("vg", vg)):
        if not x.is_cuda or x.dtype != torch.bfloat16:
            raise TypeError(f"decode_attention: {name} must be bf16 on the card")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous and 16-byte aligned")
    if vp.shape != kp.shape or vg.shape != kg.shape or kg.shape != (r, hkv, g, d):
        raise ValueError("decode_attention: cache shapes disagree")
    if d not in HEAD_DIMS or hq % hkv or nb * n_rep > MAX_ROWS:
        raise ValueError(f"decode_attention: head_dim {d} (takes {HEAD_DIMS}), GQA "
                         f"{hq}/{hkv} or {nb * n_rep} rows per kv head not supported")
    if not 0 <= t < g:
        raise ValueError(f"decode_attention: step {t} outside the generated cache [0, {g})")
    mask = prefix_mask.to(device=q.device, dtype=torch.int32).contiguous()
    if mask.shape != (b, p):
        raise ValueError(f"decode_attention: prefix_mask must be [B, P], got {tuple(mask.shape)}")
    lib = _build.library()
    out = torch.empty_like(q)
    err = lib.decode_attn_bf16(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kg.data_ptr(), vg.data_ptr(),
        mask.data_ptr(), out.data_ptr(), b, nb, hkv, n_rep, p, g, d,
        int(t), int(prefix_len), int(window or 0), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("decode_attn_bf16", err)
    launches.add()
    return out


def decode_attention(q, kp, vp, kg, vg, *, prefix_mask, t: int, prefix_len: int,
                     scale: float, window: Optional[int] = None):
    """q [R, Hq, D] (this step's queries), kp/vp [B, Hkv, P, D], kg/vg [R, Hkv, G, D]
    with slot t already written -> [R, Hq, D] in q's dtype.

    The kernel on CUDA tensors, the plain version on CPU tensors."""
    kw = dict(prefix_mask=prefix_mask, t=t, prefix_len=prefix_len, scale=scale,
              window=window)
    if q.is_cuda:
        return _launch(q, kp, vp, kg, vg, **kw)
    if q.device.type != "cpu":
        raise RuntimeError(f"decode_attention: no kernel for device {q.device}")
    return decode_attention_reference(q, kp, vp, kg, vg, **kw)
