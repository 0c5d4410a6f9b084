"""LayerNorm forward: a Triton kernel for CUDA tensors, its plain version for CPU ones.

Replaces the TPU kernel ``projectiontrainer_tpu/ops/fused_layernorm.py:_fwd_kernel``
(called from ``_fwd``), which the SigLIP tower runs in place of ``layers.layernorm``.

Bound on the H100 by bytes: one read of the bf16 rows and one write of the output
(plus the two [D] parameter vectors), against ~8 flops per element. So the kernel
does the whole row in one pass held in registers: one program per row, the block
``BLOCK_D = next_pow2(D)`` wide and masked at the edge, mean and variance in fp32,
the output in the input's type. At the tower shape ([8*576, 1024] bf16) that is 4608
programs of one row each, enough to fill the card.

Left for later: several rows per program for short rows, and the backward
(``fused_layernorm.py:_bwd_kernel``, needed once the tower trains).
"""

from __future__ import annotations

import functools

import torch

from projectiontrainer_tpu_torch.kernels._build import LaunchCounter
from projectiontrainer_tpu_torch.ops import layers as L

launches = LaunchCounter("layernorm_fwd")


@functools.cache
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def layernorm_fwd(x_ptr, scale_ptr, bias_ptr, out_ptr, row_stride, d, eps,
                      BLOCK_D: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        live = cols < d
        x = tl.load(x_ptr + row * row_stride + cols, mask=live, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=0) / d
        xc = tl.where(live, x - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / d
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(scale_ptr + cols, mask=live, other=0.0).to(tl.float32)
        b = tl.load(bias_ptr + cols, mask=live, other=0.0).to(tl.float32)
        y = xc * rstd * w + b
        tl.store(out_ptr + row * d + cols, y.to(out_ptr.dtype.element_ty), mask=live)

    return triton, layernorm_fwd


def layernorm_reference(p: dict, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """The plain version: ``layers.layernorm``."""
    return L.layernorm(p, x, eps=eps)


def _launch(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"layernorm kernel takes bf16 or fp32, got {x.dtype}")
    shape = x.shape
    d = shape[-1]
    x2 = x.reshape(-1, d)
    if x2.stride(-1) != 1:
        raise ValueError("layernorm kernel needs a unit stride on the last axis")
    scale, bias = p["scale"], p["bias"]
    if scale.shape != (d,) or bias.shape != (d,) or not (scale.is_cuda and bias.is_cuda):
        raise ValueError("layernorm kernel needs [D] scale and bias on the card")
    triton, kernel = _kernel()
    out = torch.empty((x2.shape[0], d), dtype=x.dtype, device=x.device)
    block = triton.next_power_of_2(d)
    kernel[(x2.shape[0],)](x2, scale.contiguous(), bias.contiguous(), out,
                           x2.stride(0), d, eps, BLOCK_D=block,
                           num_warps=4 if block <= 2048 else 8)
    launches.add()
    return out.reshape(shape)


def layernorm(p: dict, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Drop-in for ``layers.layernorm``: the Triton kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.is_cuda:
        return _launch(p, x, eps)
    if x.device.type != "cpu":
        raise RuntimeError(f"layernorm: no kernel for device {x.device}")
    return layernorm_reference(p, x, eps=eps)
