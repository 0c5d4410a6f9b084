"""Neural-net building blocks as plain functions over dictionaries of tensors.

Counterpart of ``projectiontrainer_tpu/ops/layers.py``. Conventions of the port:

- a linear layer is ``{"weight": [out, in], "bias": [out]}`` (the torch layout; the
  JAX package stores ``kernel`` as ``[in, out]`` and ``checkpoint/from_jax.py``
  transposes it);
- a linear whose parameters are wider than its input (fp32 projector over a bf16
  tower) computes in the wider type and casts the result back to the input's type,
  as JAX's dtype promotion does;
- norms and RoPE compute in fp32 and return the input's type.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------- init


def init_linear(gen: torch.Generator, in_dim: int, out_dim: int, *, bias: bool = True,
                dtype=torch.float32, device=None, stddev: float | None = None) -> dict:
    if stddev is None:
        stddev = in_dim ** -0.5
    w = torch.randn((out_dim, in_dim), generator=gen, device=device) * stddev
    p = {"weight": w.to(dtype)}
    if bias:
        p["bias"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def init_embedding(gen: torch.Generator, vocab: int, dim: int, *, dtype=torch.float32,
                   device=None, stddev: float = 0.02) -> dict:
    w = torch.randn((vocab, dim), generator=gen, device=device) * stddev
    return {"embedding": w.to(dtype)}


def init_layernorm(dim: int, *, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def init_rmsnorm(dim: int, *, dtype=torch.float32, device=None,
                 zero_centered: bool = False) -> dict:
    fill = torch.zeros if zero_centered else torch.ones
    return {"scale": fill((dim,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------- apply fns


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    w = p["weight"]
    dt = torch.promote_types(x.dtype, w.dtype)
    b = p.get("bias")
    y = F.linear(x.to(dt), w.to(dt), None if b is None else b.to(dt))
    return y.to(x.dtype)


def embedding_lookup(p: dict, ids: torch.Tensor) -> torch.Tensor:
    return p["embedding"][ids]


def layernorm(p: dict, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rmsnorm(p: dict, x: torch.Tensor, *, eps: float = 1e-6,
            zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm; ``zero_centered=True`` is Gemma's ``y * (1 + w)`` in fp32."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    w = p["scale"].float()
    y = y * (1.0 + w) if zero_centered else y * w
    return y.to(x.dtype)


def gelu(x: torch.Tensor, *, approximate: bool = True) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


ACTIVATIONS = {
    "gelu_tanh": lambda x: gelu(x, approximate=True),
    "gelu": lambda x: gelu(x, approximate=False),
    "silu": silu,
}


# ---------------------------------------------------------------------------- RoPE


def rope_frequencies(head_dim: int, positions: torch.Tensor, *, theta: float = 10000.0,
                     scaling_factor: float = 1.0, llama3_scaling=None):
    """(sin, cos) of shape [*positions.shape, head_dim // 2], fp32.

    ``llama3_scaling`` = (factor, low_freq_factor, high_freq_factor,
    original_max_position_embeddings), HF's frequency-dependent Llama-3 scaling."""
    device = positions.device
    fraction = 2.0 * torch.arange(0, head_dim // 2, dtype=torch.float32,
                                  device=device) / head_dim
    inv_freq = 1.0 / (theta ** fraction)
    if llama3_scaling is not None:
        factor, low_ff, high_ff, orig_max = llama3_scaling
        low_wavelen = orig_max / low_ff
        high_wavelen = orig_max / high_ff
        wavelen = 2.0 * math.pi / inv_freq
        scaled = inv_freq / factor
        smooth = (orig_max / wavelen - low_ff) / (high_ff - low_ff)
        mid = (1.0 - smooth) * scaled + smooth * inv_freq
        inv_freq = torch.where(wavelen > low_wavelen, scaled,
                               torch.where(wavelen < high_wavelen, inv_freq, mid))
    angle = (positions.float() / scaling_factor)[..., None] * inv_freq
    return torch.sin(angle), torch.cos(angle)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate (first half, second half) pairs as HF ``rotate_half`` does.

    x: [B, T, H, D]; sin/cos: [B, T, D // 2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    sin, cos = sin[..., None, :].float(), cos[..., None, :].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------- conv patches


def init_conv_patch(gen: torch.Generator, patch: int, in_ch: int, out_dim: int, *,
                    dtype=torch.float32, device=None) -> dict:
    """Patchify conv stored as its space-to-depth matrix [out_dim, patch*patch*in_ch],
    rows of the input ordered (patch row, patch column, channel) like HWIO."""
    fan_in = patch * patch * in_ch
    return init_linear(gen, fan_in, out_dim, dtype=dtype, device=device,
                       stddev=fan_in ** -0.5)


def conv_patchify(p: dict, images: torch.Tensor, *, patch: int) -> torch.Tensor:
    """images: [B, H, W, C] (NHWC) -> patch embeddings [B, (H/p)*(W/p), D]:
    space-to-depth, then one matmul."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return linear(p, x.reshape(b, gh * gw, patch * patch * c))
