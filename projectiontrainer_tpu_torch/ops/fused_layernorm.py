"""LayerNorm forward and backward: Triton kernels for CUDA tensors, their plain
versions for CPU ones.

Replaces the TPU kernels ``projectiontrainer_tpu/ops/fused_layernorm.py:_fwd_kernel``
(K2, called from ``_fwd``) and ``:_bwd_kernel`` (K8, called from ``_bwd``), which the
SigLIP towers run in place of ``layers.layernorm``. ``layernorm`` is a
``torch.autograd.Function`` pairing the two, and saves what the JAX custom VJP saves:
x and scale (the backward recomputes the row statistics from x, which it reads anyway).

Both are bound on the H100 by bytes, with no matrix product: the forward reads the
bf16 rows once and writes the output once (~8 flops an element); the backward reads x
and dy and writes dx (~113 MB at the stage-0 tower's [16384, 1152] bf16).

- K2 (forward) does a whole row in one pass held in registers: one program per row,
  ``BLOCK_D = next_pow2(D)`` wide and masked at the edge, mean and variance in fp32,
  the output in the input's type.
- K8 (backward): dx = rstd * (g - mean(g) - xhat * mean(g * xhat)), g = dy * scale,
  per row in registers, like K2. The parameter gradients dscale = sum(dy * xhat) and
  dbias = sum(dy) are column sums over all rows: the TPU accumulates them across its
  sequential grid, but blocks on the card run in no order. So each program takes a
  block of rows, keeps its two fp32 column sums in registers, and writes them to its
  row of a ``[n_programs, 2, D]`` buffer; a second small kernel sums the buffer's rows
  in a fixed order (deterministic: no atomics). Rows past the end of the last block
  are masked in the products, not only in dy. The number of programs is about four
  per SM (rows a program rounded to a power of two), so the buffer stays a few
  percent of the traffic at the tower's shape and short inputs (the MAP head's 16
  rows, the text tower's 1024) still spread over the card.
"""

from __future__ import annotations

import functools

import torch

from projectiontrainer_tpu_torch.kernels._build import LaunchCounter
from projectiontrainer_tpu_torch.ops import layers as L

launches = LaunchCounter("layernorm_fwd")
bwd_launches = LaunchCounter("layernorm_bwd")
_PROGRAMS_PER_SM = 4


@functools.cache
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def layernorm_fwd(x_ptr, scale_ptr, bias_ptr, out_ptr, row_stride, d, eps,
                      BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
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

    @triton.jit
    def layernorm_bwd(x_ptr, dy_ptr, scale_ptr, dx_ptr, part_ptr, n_rows, x_stride,
                      dy_stride, d, eps, ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        live = cols < d
        w = tl.load(scale_ptr + cols, mask=live, other=0.0).to(tl.float32)
        acc_dscale = tl.zeros([BLOCK_D], dtype=tl.float32)
        acc_dbias = tl.zeros([BLOCK_D], dtype=tl.float32)
        for r in range(ROWS):
            row = pid.to(tl.int64) * ROWS + r
            m = live & (row < n_rows)
            x = tl.load(x_ptr + row * x_stride + cols, mask=m, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + row * dy_stride + cols, mask=m, other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) / d
            xc = tl.where(live, x - mean, 0.0)
            rstd = 1.0 / tl.sqrt(tl.sum(xc * xc, axis=0) / d + eps)
            xhat = xc * rstd
            g = dy * w
            g_mean = tl.sum(g, axis=0) / d
            gx_mean = tl.sum(g * xhat, axis=0) / d
            dx = rstd * (g - g_mean - xhat * gx_mean)
            tl.store(dx_ptr + row * d + cols, dx.to(dx_ptr.dtype.element_ty), mask=m)
            # a row past the end must add nothing: mask the products themselves
            acc_dscale += tl.where(m, dy * xhat, 0.0)
            acc_dbias += tl.where(m, dy, 0.0)
        base = part_ptr + pid.to(tl.int64) * 2 * d
        tl.store(base + cols, acc_dscale, mask=live)
        tl.store(base + d + cols, acc_dbias, mask=live)

    @triton.jit
    def layernorm_bwd_sum(part_ptr, out_ptr, n_parts, width,
                          BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        live = cols < width
        acc = tl.zeros([BLOCK_C], dtype=tl.float32)
        for p0 in range(0, n_parts, BLOCK_P):
            parts = p0 + tl.arange(0, BLOCK_P)
            m = (parts[:, None] < n_parts) & live[None, :]
            tile = tl.load(part_ptr + parts[:, None].to(tl.int64) * width + cols[None, :],
                           mask=m, other=0.0)
            acc += tl.sum(tile, axis=0)
        tl.store(out_ptr + cols, acc, mask=live)

    return triton, layernorm_fwd, layernorm_bwd, layernorm_bwd_sum


# ---------------------------------------------------------------------------- plain


def layernorm_reference(p: dict, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """The plain forward: ``layers.layernorm``."""
    return L.layernorm(p, x, eps=eps)


def layernorm_bwd_reference(x, dy, scale, eps: float = 1e-6):
    """The plain backward over rows [N, D] -> (dx in x's type, dscale fp32, dbias
    fp32): dx = rstd * (g - mean(g) - xhat * mean(g * xhat)) with g = dy * scale,
    dscale = sum over rows of dy * xhat, dbias = sum over rows of dy."""
    xf, dyf = x.float(), dy.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    g = dyf * scale.float()
    dx = rstd * (g - g.mean(-1, keepdim=True) - xhat * (g * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype), (dyf * xhat).sum(0), dyf.sum(0)


# ---------------------------------------------------------------------------- kernels


def _check_rows(name, x2):
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"layernorm kernel takes bf16 or fp32 {name}, got {x2.dtype}")
    if x2.stride(-1) != 1:
        raise ValueError(f"layernorm kernel needs a unit stride on the last axis of {name}")


def _check_params(d, *params):
    for t in params:
        if t.shape != (d,) or not t.is_cuda:
            raise ValueError("layernorm kernel needs [D] scale and bias on the card")


def layernorm_fwd(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """K2 on a CUDA tensor [..., D] -> y of x's shape and type."""
    shape, d = x.shape, x.shape[-1]
    x2 = x.reshape(-1, d)
    _check_rows("x", x2)
    _check_params(d, scale, bias)
    triton, kernel, _, _ = _kernels()
    out = torch.empty((x2.shape[0], d), dtype=x.dtype, device=x.device)
    block = triton.next_power_of_2(d)
    kernel[(x2.shape[0],)](x2, scale.contiguous(), bias.contiguous(), out,
                           x2.stride(0), d, eps, BLOCK_D=block,
                           num_warps=4 if block <= 2048 else 8)
    launches.add()
    return out.reshape(shape)


def bwd_grid(n: int, sms: int) -> tuple[int, int]:
    """K8's (rows a program, programs) for n rows on a card of `sms` SMs: about four
    programs an SM, rows a program rounded up to a power of two, so the last
    program's block is part-empty unless it divides n."""
    rows = 1 << (max(1, -(-n // (_PROGRAMS_PER_SM * sms))) - 1).bit_length()
    return rows, -(-n // rows)


def layernorm_bwd(x2: torch.Tensor, dy2: torch.Tensor, scale, eps: float):
    """K8 on CUDA rows x2, dy2 [N, D] -> (dx [N, D] in x's type, dscale fp32 [D],
    dbias fp32 [D])."""
    n, d = x2.shape
    _check_rows("x", x2)
    _check_rows("dy", dy2)
    _check_params(d, scale)
    if dy2.shape != x2.shape:
        raise ValueError(f"layernorm backward: dy {tuple(dy2.shape)} is not x {tuple(x2.shape)}")
    triton, _, kernel, sum_kernel = _kernels()
    rows, programs = bwd_grid(n, torch.cuda.get_device_properties(x2.device).multi_processor_count)
    block = triton.next_power_of_2(d)
    dx = torch.empty((n, d), dtype=x2.dtype, device=x2.device)
    parts = torch.empty((programs, 2, d), dtype=torch.float32, device=x2.device)
    kernel[(programs,)](x2, dy2, scale.contiguous(), dx, parts, n, x2.stride(0),
                        dy2.stride(0), d, eps, ROWS=rows, BLOCK_D=block,
                        num_warps=4 if block <= 2048 else 8)
    sums = torch.empty((2, d), dtype=torch.float32, device=x2.device)
    block_c = 128
    sum_kernel[(triton.cdiv(2 * d, block_c),)](parts, sums, programs, 2 * d,
                                                BLOCK_P=32, BLOCK_C=block_c, num_warps=4)
    bwd_launches.add()
    return dx, sums[0], sums[1]


# ---------------------------------------------------------------------------- autograd


class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        if x.is_cuda:
            y = layernorm_fwd(x, scale, bias, eps)
        elif x.device.type == "cpu":
            y = layernorm_reference({"scale": scale, "bias": bias}, x, eps=eps)
        else:
            raise RuntimeError(f"layernorm: no kernel for device {x.device}")
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        d = x.shape[-1]
        x2, dy2 = x.reshape(-1, d), dy.reshape(-1, d)
        if x.is_cuda:
            dx, dscale, dbias = layernorm_bwd(x2, dy2.contiguous(), scale, ctx.eps)
        else:
            dx, dscale, dbias = layernorm_bwd_reference(x2, dy2, scale, ctx.eps)
        return dx.reshape(x.shape), dscale.to(scale.dtype), dbias.to(ctx.bias_dtype), None


def layernorm(p: dict, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Drop-in for ``layers.layernorm``, differentiable in x, scale and bias: K2 and
    K8 on a CUDA tensor, the plain forward and backward on a CPU tensor."""
    return _LayerNorm.apply(x, p["scale"], p["bias"], float(eps))
