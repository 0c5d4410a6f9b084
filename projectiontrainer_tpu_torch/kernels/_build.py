"""Build and load the hand-written CUDA kernels under ``csrc/``.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` (all
started together), and the objects are linked into one shared library with a plain C
interface, stored under ``build/kernels/`` and named by a hash of the sources (a
changed source builds anew; an unchanged one loads the cached library). The library is loaded with ``ctypes``: pointers and the CUDA stream pass
as ``c_void_p``, each C entry point returns ``cudaGetLastError()`` after its launch,
and :func:`check` raises on anything but 0. A failed build raises too: there is no
fallback to another implementation.

The Triton kernel (the LayerNorm forward) is not built here; it is imported and
compiled inside the function that launches it.

Each launch is an operator of the ``ptt`` namespace (:func:`kernel_op`): its CUDA
implementation launches the kernel, its fake implementation (``FakeTensorMode``: the
budget's trace, ``parallel/budget.py``) does nothing. Every buffer a launch writes, its
outputs and its scratch alike, is allocated in Python on the tensor's device before the
operator and passed to it as a mutated argument, so the operator itself allocates
nothing: a memory tracker sees the same bytes under the fake mode as on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# CTAs a thread-block cluster at most, the portable size (csrc/cluster_sm90.cuh); only K4
# and K5 go past it (ops/flash_attention.py:MAX_CLUSTER)
MAX_CLUSTER = 8

# C signatures of the entry points (see the ``extern "C"`` blocks of csrc/*.cu)
SIGNATURES = {
    # q, k, v, kv_mask, out, lse, out_f32 (or null); B, T, Hq, Hkv, D; tensor maps of
    # q, k, v (long long[33]); bq, bk; out strides (b, t, h) in elements; scale, causal,
    # window; stream
    "flash_attn_fwd_bf16": [_P] * 7 + [_I] * 5 + [_P, _I, _I] + [_L] * 3 + [_F, _I, _I, _P],
    # q, kp, vp, kg, vg, prefix_mask, out, o_part, ml_part, counter; B, nb, Hkv, n_rep, P,
    # G, D; p_begin, p_splits, g_begin, g_end, g_splits, chunk; groups, beams and reps a
    # group; scale; stream
    "decode_attn_bf16": [_P] * 10 + [_I] * 7 + [_I] * 6 + [_I] * 3 + [_F, _P],
    # q, k, v, kv_mask, dout, lse, delta, dk, dv; B, T, Hq, Hkv, D;
    # strides (long long[18]: q, k, v, dout, dk, dv, each (b, t, h)); tensor maps of q, k,
    # v, dout (long long[44]); bk, bq; scale, causal, window; stream
    "flash_attn_bwd_dkv_bf16": [_P] * 9 + [_I] * 5 + [_P, _P, _I, _I, _F, _I, _I, _P],
    # q, k, v, kv_mask, dout, lse, delta, dq; B, T, Hq, Hkv, D;
    # strides (long long[15]: q, k, v, dout, dq); tensor maps of q, k, v, dout
    # (long long[44]); bq, bk; scale, causal, window; stream
    "flash_attn_bwd_dq_bf16": [_P] * 8 + [_I] * 5 + [_P, _P, _I, _I, _F, _I, _I, _P],
    # the wide kernels (head dims above 512, csrc/flash_attn_wide.cu): the same pointers as
    # the three above; B, T, Hq, Hkv, D; strides (long long[]: (b, t, h) of q, k, v, then
    # out / dout, dk, dv / dout, dq); scale, causal, window; stream
    "flash_attn_wide_fwd_bf16": [_P] * 7 + [_I] * 5 + [_P, _F, _I, _I, _P],
    # the cluster kernels (K1 at head dims 576-4096, K4 and K5 at 576-8192,
    # csrc/flash_attn_cluster.cu): the signatures of flash_attn_fwd_bf16,
    # flash_attn_bwd_dkv_bf16 and flash_attn_bwd_dq_bf16, the cluster size and ring stages
    # (and K4's and K5's ring tile) in place of the tiles
    "flash_attn_cluster_fwd_bf16": [_P] * 7 + [_I] * 5 + [_P, _I, _I] + [_L] * 3 + [_F, _I, _I, _P],
    "flash_attn_cluster_bwd_dkv_bf16": [_P] * 9 + [_I] * 5 + [_P, _P] + [_I] * 3 + [_F, _I, _I, _P],
    "flash_attn_cluster_bwd_dq_bf16": [_P] * 8 + [_I] * 5 + [_P, _P] + [_I] * 3 + [_F, _I, _I, _P],
    # kind (0 K1, 1 K4, 2 K5), D, cluster, stages, ring tile -> clusters resident at once
    "flash_attn_cluster_fit": [_I] * 5,
    "flash_attn_wide_bwd_dkv_bf16": [_P] * 9 + [_I] * 5 + [_P, _F, _I, _I, _P],
    "flash_attn_wide_bwd_dq_bf16": [_P] * 8 + [_I] * 5 + [_P, _F, _I, _I, _P],
    # hidden, table, labels, part, lse, nll; N, V, D, splits, tiles_per_split; scale;
    # stream
    "fused_ce_fwd_bf16": [_P] * 6 + [_I] * 5 + [_F, _P],
    # hidden, table, labels, lse, g, part, dh; N, V, D, splits, ranges_per_split; scale;
    # stream
    "fused_ce_bwd_bf16": [_P] * 7 + [_I] * 5 + [_F, _P],
    # x, dy, scale, dx, part, sums, counter; N, D; x and dy row strides (elements); rows,
    # stages, ctas, scale_f32, direct; eps; stream
    "layernorm_bwd_bf16": [_P] * 7 + [_I] * 2 + [_L] * 2 + [_I] * 5 + [_F, _P],
    "layernorm_bwd_f32": [_P] * 7 + [_I] * 2 + [_L] * 2 + [_I] * 5 + [_F, _P],
    # rows cut over a cluster: the pointers and sizes above; cluster, clusters, slots,
    # scale_f32; eps; stream
    "layernorm_bwd_cluster_bf16": [_P] * 7 + [_I] * 2 + [_L] * 2 + [_I] * 4 + [_F, _P],
    "layernorm_bwd_cluster_f32": [_P] * 7 + [_I] * 2 + [_L] * 2 + [_I] * 4 + [_F, _P],
    # itemsize, d, cluster, slots -> clusters resident at once
    "layernorm_bwd_cluster_fit": [_I] * 4,
}

_lock = threading.Lock()
_lib = None
_OPS = torch.library.Library("ptt", "FRAGMENT")
build_seconds: float | None = None  # wall time of the build this process did, if any


class LaunchCounter:
    """Plain count of a wrapper's kernel launches (thread-safe: two serving workers
    launch kernels concurrently)."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of projectiontrainer_tpu_torch "
                       "are built from source and need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run(cmd: list[str]) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")


def build() -> Path:
    """Compile csrc/*.cu into build/kernels/ unless the same sources were built
    before: one nvcc per source, all at once, then one link. Returns the library's
    path; raises on a failed build."""
    global build_seconds
    out = BUILD_DIR / f"libptt_kernels_{_source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    with ThreadPoolExecutor(max_workers=len(objs)) as pool:
        list(pool.map(_run, [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                             for src, obj in zip(sources(), objs)]))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)])
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def on_card(x) -> bool:
    """Whether ``x`` takes a kernel's branch: a CUDA tensor (real, or fake in a trace),
    or a meta tensor, which stands for the card in a trace where torch has no CUDA
    (autograd refuses a fake CUDA tensor there; ``parallel/budget.py``). The operators
    launch nothing on a fake or meta tensor."""
    return x.is_cuda or x.is_meta


def traced(x) -> bool:
    """Whether ``x`` is a fake or meta tensor: a trace's, on no card."""
    from torch._subclasses.fake_tensor import is_fake

    return x.is_meta or is_fake(x)


def allocate(buffers: dict, device) -> dict:
    """``torch.empty`` of each (shape, dtype) of a launch's buffers on ``device``."""
    return {n: torch.empty(shape, dtype=dt, device=device) for n, (shape, dt) in buffers.items()}


def kernel_op(name: str, schema: str, launch):
    """Define the operator ``ptt::<name><schema>`` (a schema whose buffers are mutated
    arguments and which returns nothing): ``launch`` is its CUDA implementation, and its
    fake implementation returns nothing, so under ``FakeTensorMode`` the operator runs
    no kernel and allocates nothing. Registered through ``torch.library.Library``, the
    dispatcher's cheapest path from Python. Returns the operator."""
    _OPS.define(name + schema)
    _OPS.impl(name, launch, "CUDA")
    torch.library.register_fake(f"ptt::{name}", lambda *args: None, lib=_OPS)
    return getattr(torch.ops.ptt, name).default


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
