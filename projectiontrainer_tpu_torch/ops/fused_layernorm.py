"""LayerNorm forward and backward: a Triton kernel (K2) and a CUDA kernel (K8) for CUDA
tensors, their plain versions for CPU ones.

Replaces the TPU kernels ``projectiontrainer_tpu/ops/fused_layernorm.py:_fwd_kernel``
(K2, called from ``_fwd``) and ``:_bwd_kernel`` (K8, called from ``_bwd``), which the
SigLIP towers run in place of ``layers.layernorm``. ``layernorm`` is a
``torch.autograd.Function`` pairing the two, and saves what the JAX custom VJP saves:
x and scale (the backward recomputes the row statistics from x, which it reads anyway).

Both are bound on the H100 by bytes, with no matrix product: the forward reads the
bf16 rows once and writes the output once (~8 flops an element); the backward reads x
and dy and writes dx (~113 MB at the stage-0 tower's [16384, 1152] bf16).

- K2 (forward, Triton) does a whole row in one pass held in registers: one program per
  row, ``BLOCK_D = next_pow2(D)`` wide and masked at the edge, mean and variance in
  fp32, the output in the input's type. Above ``FWD_MAX_BLOCK`` columns a row no longer
  sits in registers: the program loops over column chunks of ``FWD_CHUNK`` instead (the
  mean, then the centred squares, then the output: x read three times, from L2).
- K8 (backward, ``csrc/layernorm_bwd.cu``): dx = rstd * (g - mean(g) - xhat *
  mean(g * xhat)), g = dy * scale, and the column sums dscale = sum(dy * xhat),
  dbias = sum(dy), in one persistent cooperative launch: one CTA an SM, each over a
  contiguous band of rows (``bwd_plan``), whose rows of x and dy a producer thread
  copies whole into a ring of shared-memory stages; a warp a row computes dx with
  shuffle reductions, and four column-sum warps fold each stage's rows into fp32
  registers. The CTAs' partial sums meet in a ``[C, 2, slot]`` fp32 scratch; after one
  grid barrier each CTA adds its slice of the columns over all partials in CTA order
  (deterministic: no atomics). Rows past a band's end are never loaded, so a
  part-filled stage adds nothing. bf16 or fp32 rows of any width up to what one ring
  row must fit in shared memory (19,368): a row's slot is D
  rounded up to 8 (``bwd_slot``), and rows that are not 16-byte multiples or do not start
  on 16 bytes are copied by the row warps' cp.async instead of in bulk (``bwd_direct``);
  above 4096 the column sums run through the CTA's partial row in device memory instead
  of registers. Wider rows (one ring row of x and dy and the fp32 scale no longer fits:
  above 19,368 in bf16) take K8's streamed kernel (``bwd_plan``'s ``stages`` 0): a CTA
  an SM over its band, the whole CTA on one row at a time, read from device memory in
  chunks of ``BWD_STREAM_THREADS`` vectors (the mean; the centred squares, sum(g) and
  sum(g * xhat); then dx and the partial column sums), and the same combine. The JAX
  package computes every width (its gate sends the rest to XLA,
  ``ops/fused_layernorm.py:38-53`` there).

Each launch is a ``ptt`` operator (``kernels/_build.py:kernel_op``): the wrappers
allocate what the kernel writes (``fwd_buffers``, ``bwd_buffers``: K8's partial sums
too) before it; under ``FakeTensorMode`` the operator does nothing.
"""

from __future__ import annotations

import functools
import threading

import torch

from projectiontrainer_tpu_torch.kernels import _build
from projectiontrainer_tpu_torch.ops import layers as L

launches = _build.LaunchCounter("layernorm_fwd")
bwd_launches = _build.LaunchCounter("layernorm_bwd")
# K8's launch (csrc/layernorm_bwd.cu): 8 row warps, 4 column-sum warps, 1 producer warp
BWD_MAX_D = 4096         # MAX_D: widest D whose column sums stay in registers
BWD_THREADS = 416        # THREADS
BWD_MAX_STAGES = 4       # ring stages the plan uses (the kernel takes up to 8)
BWD_STREAM_THREADS = 512  # the streamed kernel's CTA (csrc/layernorm_bwd.cu:STREAM_THREADS)
FWD_MAX_BLOCK = 16384    # K2's widest row held in registers (BLOCK_D); wider rows loop
FWD_CHUNK = 4096         # K2's column chunk on wider rows
SMEM_LIMIT = 232_448     # dynamic shared memory a block may opt into on the H100
H100_SMS = 132           # the SMs K8's plan spreads over where no card is asked (a trace)
_barriers: dict = {}     # (device index, stream) -> the grid barrier's uint32 counter
_barriers_lock = threading.Lock()


@functools.cache
def _fwd_kernel():
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
    def layernorm_fwd_chunked(x_ptr, scale_ptr, bias_ptr, out_ptr, row_stride, d, eps,
                              BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for c0 in range(0, d, BLOCK):
            cols = c0 + tl.arange(0, BLOCK)
            acc += tl.load(x_ptr + row * row_stride + cols, mask=cols < d,
                           other=0.0).to(tl.float32)
        mean = tl.sum(acc, axis=0) / d
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for c0 in range(0, d, BLOCK):
            cols = c0 + tl.arange(0, BLOCK)
            live = cols < d
            x = tl.load(x_ptr + row * row_stride + cols, mask=live, other=0.0).to(tl.float32)
            xc = tl.where(live, x - mean, 0.0)
            acc += xc * xc
        rstd = 1.0 / tl.sqrt(tl.sum(acc, axis=0) / d + eps)
        for c0 in range(0, d, BLOCK):
            cols = c0 + tl.arange(0, BLOCK)
            live = cols < d
            x = tl.load(x_ptr + row * row_stride + cols, mask=live, other=0.0).to(tl.float32)
            w = tl.load(scale_ptr + cols, mask=live, other=0.0).to(tl.float32)
            b = tl.load(bias_ptr + cols, mask=live, other=0.0).to(tl.float32)
            y = (x - mean) * rstd * w + b
            tl.store(out_ptr + row * d + cols, y.to(out_ptr.dtype.element_ty), mask=live)

    return triton, layernorm_fwd, layernorm_fwd_chunked


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
        if t.shape != (d,) or not _build.on_card(t):
            raise ValueError("layernorm kernel needs [D] scale and bias on the card")


def fwd_buffers(x2) -> dict:
    """What one K2 launch on rows x2 [N, D] writes: y, contiguous, in x's type."""
    return {"out": (tuple(x2.shape), x2.dtype)}


def fwd_plan(d: int) -> dict:
    """K2's launch at width d: one program a row, the whole row in registers
    (``block`` = next power of two of d) up to ``FWD_MAX_BLOCK``; above, ``chunked``
    over column chunks of ``FWD_CHUNK``."""
    block = 1 << max(0, d - 1).bit_length()
    if block <= FWD_MAX_BLOCK:
        return {"block": block, "chunked": False, "num_warps": 4 if block <= 2048 else 8}
    return {"block": FWD_CHUNK, "chunked": True, "num_warps": 8}


def _fwd_launch(x2, scale, bias, out, eps):
    """K2's operator on the card: ``out`` written."""
    _, kernel, chunked = _fwd_kernel()
    d = x2.shape[1]
    plan = fwd_plan(d)
    if plan["chunked"]:
        chunked[(x2.shape[0],)](x2, scale, bias, out, x2.stride(0), d, eps, BLOCK=plan["block"],
                                num_warps=plan["num_warps"])
    else:
        kernel[(x2.shape[0],)](x2, scale, bias, out, x2.stride(0), d, eps,
                               BLOCK_D=plan["block"], num_warps=plan["num_warps"])
    launches.add()


FWD_OP = _build.kernel_op(
    "layernorm_fwd", "(Tensor x, Tensor scale, Tensor bias, Tensor(a!) out, float eps) -> ()",
    _fwd_launch)


def layernorm_fwd(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """K2 on a CUDA tensor [..., D] -> y of x's shape and type."""
    shape, d = x.shape, x.shape[-1]
    x2 = x.reshape(-1, d)
    _check_rows("x", x2)
    _check_params(d, scale, bias)
    scale, bias = scale.contiguous(), bias.contiguous()
    out = _build.allocate(fwd_buffers(x2), x.device)["out"]
    FWD_OP(x2, scale, bias, out, float(eps))
    return out.reshape(shape)


def bwd_slot(d: int) -> int:
    """A row's slot in K8's ring and partial sums: d rounded up to 8 elements (16-byte
    slots in bf16 and fp32; csrc/layernorm_bwd.cu:slot_width)."""
    return -(-d // 8) * 8


def bwd_smem_bytes(d: int, itemsize: int, rows: int, stages: int) -> int:
    """K8's dynamic shared memory (csrc/layernorm_bwd.cu:smem_bytes): the ring of
    ``stages`` x ``rows`` slots of x and dy (its first bytes hold the combine's sums once
    it has drained), the scale in fp32, each slot's (mean, rstd), three mbarriers a
    stage."""
    dp = bwd_slot(d)
    ring = stages * rows * 2 * dp * itemsize
    return max(ring, 4 * max(2 * dp, BWD_THREADS)) + 4 * dp + 8 * stages * rows + 24 * stages


def bwd_plan(n: int, d: int, sms: int, itemsize: int = 2) -> dict:
    """How K8 lays n rows of width d (``itemsize`` bytes an element) over a card of
    ``sms`` SMs: ``rows`` a ring stage (8, or fewer where three stages of 8 would not fit
    in shared memory), ``stages`` (at most ``BWD_MAX_STAGES``; fewer than 3 only where
    one row a stage leaves no room for more), and ``ctas`` = min(sms, ceil(n / rows)),
    one an SM, CTA c over the contiguous band ``bwd_bands`` gives it; one CTA for up to
    2 x rows rows. Where one row of x and dy and the fp32 scale do not fit in shared
    memory (above 19,368 in bf16 and fp32), the streamed kernel: ``streamed``, ``stages``
    0, one row at a time (``rows`` 1) in ``chunk`` columns a pass (16 bytes a thread of
    ``BWD_STREAM_THREADS``), ``ctas`` = min(sms, n), or 1 up to 2 rows."""
    if d < 1:
        raise ValueError(f"layernorm backward kernel: D = {d}")
    if n < 1:
        raise ValueError("layernorm backward kernel: no rows")
    for rows in (8, 4, 2, 1):
        stages = BWD_MAX_STAGES
        while stages > 1 and bwd_smem_bytes(d, itemsize, rows, stages) > SMEM_LIMIT:
            stages -= 1
        if stages >= 3:
            break
    if bwd_smem_bytes(d, itemsize, rows, stages) > SMEM_LIMIT:
        return {"ctas": 1 if n <= 2 else min(sms, n), "rows": 1, "stages": 0,
                "streamed": True, "chunk": BWD_STREAM_THREADS * (16 // itemsize),
                "smem_bytes": 0}
    # up to two stages of rows, one CTA without the grid barrier and the combine is the
    # quicker (kernels/check_layernorm.py --time times both)
    ctas = 1 if n <= 2 * rows else min(sms, -(-n // rows))
    return {"ctas": ctas, "rows": rows, "stages": stages,
            "smem_bytes": bwd_smem_bytes(d, itemsize, rows, stages)}


def bwd_bands(n: int, ctas: int) -> list[tuple[int, int]]:
    """(first row, row count) of each CTA's band, as the kernel computes them: the first
    n % ctas bands hold one row more."""
    q, extra = divmod(n, ctas)
    return [(c * q + min(c, extra), q + (c < extra)) for c in range(ctas)]


def bwd_ragged(n: int, plan: dict) -> bool:
    """Whether some band ends in a part-filled stage (its slots past the band's end are
    never loaded and must add nothing to the column sums)."""
    return any(count % plan["rows"] for _, count in bwd_bands(n, plan["ctas"]))


def _grid_barrier(device, stream: int):
    """The grid barrier's counter for one stream (launches on one stream run in order,
    so they share it; it starts at 0 and each launch moves it by 2^31)."""
    key = (device.index, stream)
    with _barriers_lock:
        c = _barriers.get(key)
        if c is None:
            c = _barriers[key] = torch.zeros(1, dtype=torch.int32, device=device)
        return c


def sm_count(x) -> int:
    """The SMs of the card that holds ``x``; ``H100_SMS`` for a tensor that stands for
    one in a trace (``parallel/budget.py``: a fake or meta tensor, no card asked)."""
    if _build.traced(x):
        return H100_SMS
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def bwd_buffers(n: int, d: int, dtype, plan: dict) -> dict:
    """What one K8 launch on [n, d] rows of ``dtype`` under ``plan`` writes: dx in x's
    type, each CTA's fp32 partial column sums [ctas, 2, slot] and the combined sums
    [2, slot] (dscale, dbias; ``bwd_slot``: d rounded up to 8, the pad columns 0)."""
    dp = bwd_slot(d)
    return {"dx": ((n, d), dtype), "part": ((plan["ctas"], 2, dp), torch.float32),
            "sums": ((2, dp), torch.float32)}


def bwd_direct(x2, dy2) -> bool:
    """Whether K8 copies the rows with the row warps' cp.async instead of bulk copies:
    a row that is not a multiple of 16 bytes (D = 1001, 1004 in bf16) or does not start
    on 16 bytes."""
    return any(t.shape[1] * t.element_size() % 16 or t.stride(0) * t.element_size() % 16
               or t.data_ptr() % 16 for t in (x2, dy2))


def _bwd_launch(x2, dy2, scale, dx, part, sums, rows, stages, eps):
    """K8's operator on the card: ``dx``, ``part`` and ``sums`` written."""
    n, d = x2.shape
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    name = "layernorm_bwd_bf16" if x2.dtype == torch.bfloat16 else "layernorm_bwd_f32"
    err = getattr(_build.library(), name)(
        x2.data_ptr(), dy2.data_ptr(), scale.data_ptr(), dx.data_ptr(), part.data_ptr(),
        sums.data_ptr(), _grid_barrier(x2.device, stream).data_ptr(), n, d, x2.stride(0),
        dy2.stride(0), rows, stages, part.shape[0], int(scale.dtype == torch.float32),
        int(bwd_direct(x2, dy2)), eps, stream)
    _build.check(name, err)
    bwd_launches.add()


BWD_OP = _build.kernel_op(
    "layernorm_bwd", "(Tensor x, Tensor dy, Tensor scale, Tensor(a!) dx, Tensor(b!) part, "
    "Tensor(c!) sums, int rows, int stages, float eps) -> ()", _bwd_launch)


def layernorm_bwd(x2: torch.Tensor, dy2: torch.Tensor, scale, eps: float,
                  plan: dict | None = None):
    """K8 on CUDA rows x2, dy2 [N, D] (bf16 or fp32, unit stride on D) -> (dx [N, D] in
    x's type, dscale fp32 [D], dbias fp32 [D]). One launch; raises for what the kernel
    does not take. ``plan``: another ``bwd_plan`` to launch (for timing its
    alternatives), else ``bwd_plan``'s own."""
    n, d = x2.shape
    _check_rows("x", x2)
    _check_rows("dy", dy2)
    _check_params(d, scale)
    if dy2.shape != x2.shape or dy2.dtype != x2.dtype:
        raise ValueError(f"layernorm backward: dy {tuple(dy2.shape)} {dy2.dtype} is not x "
                         f"{tuple(x2.shape)} {x2.dtype}")
    if scale.dtype not in (torch.bfloat16, torch.float32) or scale.stride(0) != 1:
        raise TypeError(f"layernorm backward kernel: scale must be contiguous bf16 or fp32, "
                        f"got {scale.dtype}")
    if plan is None:
        plan = bwd_plan(n, d, sm_count(x2), x2.element_size())
    bufs = _build.allocate(bwd_buffers(n, d, x2.dtype, plan), x2.device)
    BWD_OP(x2, dy2, scale, bufs["dx"], bufs["part"], bufs["sums"], plan["rows"],
           plan["stages"], float(eps))
    return bufs["dx"], bufs["sums"][0, :d], bufs["sums"][1, :d]


# ---------------------------------------------------------------------------- autograd


class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        if _build.on_card(x):
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
        if _build.on_card(x):
            dx, dscale, dbias = layernorm_bwd(x2, dy2.contiguous(), scale, ctx.eps)
        else:
            dx, dscale, dbias = layernorm_bwd_reference(x2, dy2, scale, ctx.eps)
        return dx.reshape(x.shape), dscale.to(scale.dtype), dbias.to(ctx.bias_dtype), None


def layernorm(p: dict, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Drop-in for ``layers.layernorm``, differentiable in x, scale and bias: K2 and
    K8 on a CUDA tensor, the plain forward and backward on a CPU tensor."""
    return _LayerNorm.apply(x, p["scale"], p["bias"], float(eps))
