#!/usr/bin/env python3
"""Smoke run of the PyTorch port (projectiontrainer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a card

Phases, each printing one JSON line; any failure raises, so the exit code is not 0:

0. device: the card's name, its ``nvidia-smi`` name and power limit; TF32 off.
1. build: the CUDA kernels (csrc/*.cu) compiled from the checkout's sources, one
   nvcc per source, all at once.
2. kernels: each kernel against its plain PyTorch version on the same bf16 inputs
   (the plain version evaluated in fp32), at the main paths' shapes. Attention and
   LayerNorm forward kernels within atol = rtol = 2e-2 elementwise; the fused CE
   forward's lse and nll within 1e-3 absolute; backward kernels (K4, K5, K7, K8, whose
   bf16-rounded P / dS / softmax factors or bf16 inputs feed a long fp32 sum) within
   2e-2 x max|reference|, K7 also on its softmax part alone (dh + g * W[label]), K8
   on dx, dscale and dbias each. The stage-0 shapes: K1 at head dim 72 over the
   so400m tower ([16,1024,16,72]) and text tower ([16,64,16,72]), K4/K5 over the
   tower, K1/K4/K5 through autograd there on nearly alike tokens (each gradient's
   cosine to fp32 within 0.001 of plain bf16 attention's), K1 and K4 at a T no tile
   divides ([16,1000,16,72]) with K1's fp32 copy of O held against its bf16 O and reruns
   of K1 and K4 held bit-equal (there and at the decoder's masked GQA shape), K2 and K8 over its rows ([16384,1152]; K8 also at 1000 rows, and at 16383,
   1001 and 529, which leave its last program's block part-empty, checked); and
   the TPU's merged-lane layout (kernel rows 4-6): K1/K4/K5 on head-merged
   [2,1024,8*128] tensors through ``flash_attention_merged``, MHA and GQA 8/2.
   The CE's table is scaled for a peaked softmax and its upstream gradient differs
   per row, so a kernel that loses a vocab split or a row's weight fails. Device
   times of kernel and plain (CUDA events around 10 launches queued behind a spinning
   kernel, the median of 3 such groups: the host's launch time is not in them); beside
   them each timed case's
   bound (the larger of its bf16 operations over 989 TFLOP/s and its bytes, inputs read
   once and outputs written once, over 3.35 TB/s, the H100 SXM's published peaks;
   masked (query, key) pairs are not counted) and the time of the one PyTorch call that
   computes the same function (scaled_dot_product_attention and its autograd
   backward, with the backend that ran; F.layer_norm and its backward; F.linear +
   F.cross_entropy and its backward to the hidden states), a yardstick the port never
   calls.
3. serve: VQAService at full width (SigLIP ViT-L/16-384, 24 layers; projector
   1024 -> 10240 -> 1152; Gemma3-1B, 26 layers, vocab 262,144) from seeded random
   weights, 16 client threads x 2 requests, batch 8, 3 beams; K1-K3's launch counts
   must rise during the run.
4. end to end (serve): prefill logits and 4 teacher-forced decode steps of the
   kernel path against the plain path (the same modules with the plain ops).
5. train: Stage1Trainer.train() on the same full-width model (projector fp32
   masters, bf16 compute), 32 in-memory samples (seeded pixels, 512-token captions
   right-padded to varied lengths) at batch 4 = 8 steps of 575 + 512 = 1087 tokens,
   4 validation samples (loss and greedy captions); every loss finite, the
   projector moved, projector_final.bin written, K1-K7's launch counts rose. Steps
   6-7 run under the trainer's profiler (--profile_dir): the card's kernel time of
   each piece of the step (tower, projector, decoder, LM head + CE, optimizer;
   forward and backward apart) comes from that trace of the real step, and the
   images/s from steps 1-5 (the step timer leaves out profiled steps).
6. end to end (train): one batch's loss and projector gradients through the kernel
   path against the plain path (plain attention, plain LayerNorm, chunked CE): loss
   within 1e-3 relative, every gradient leaf at cosine >= 0.999.
7. stage-0 train: the stage-1 model is freed; Stage0Trainer.train() on the full-width
   so400m-patch16-512 dual tower (vision 27 x 1152, 16 heads of 72, 1024 patches, MAP
   head, fp32 masters and bf16 compute; text 27 x 1152, vocab 256,000, bf16, frozen)
   from seeded random weights, 128 in-memory samples (seeded 512 x 512 pixels, 64
   token ids) of 4 classes at batch 16 = 8 steps, zero-shot validation on 16 samples
   with a stub tokenizer; every loss finite, the vision tower moved, the HF export
   written, K1/K2/K4/K5/K8 launched. Steps 6-7 are profiled: the kernel time of the
   vision forward and backward, text, loss and optimizer spans; images/s and ms/step
   from steps 1-5.
8. end to end (stage 0), batch 4: the loss and the gradient of every trainable leaf
   through the kernel path against the plain path (plain attention and LayerNorm):
   loss within 1e-3 relative, cosine >= 0.999 per leaf, except the key-projection
   biases, whose gradient is zero in exact arithmetic: there the kernel path's largest
   gradient norm (rounding noise) must stay within 3x the plain path's.

The second-to-last line is {"kernels": [...]} (name, route, source, replaces, launches
on the main path, max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms); the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs no network and no model snapshot; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ATOL = RTOL = 2e-2
REL_BWD = 2e-2   # backward kernels: max |err| <= REL_BWD * max |reference|
CE_ATOL = 1e-3   # fused CE lse and nll, absolute (lse ~25 at the smoke's table scale)
LOSS_REL = 1e-3  # train end to end: the kernel path's loss against the plain path's
COS_MIN = 0.999  # train end to end: each projector gradient leaf's cosine
KEY_BIAS_NOISE = 3.0  # stage-0 end to end: key-bias gradient (zero if exact) vs plain's
NEAR_COS_GAP = 1e-3   # attention gradients on nearly alike tokens: cosine vs plain bf16's
READINGS = {}    # check name -> its reading: max abs err, or err / max|ref| (compare_rel)
SEED = 0
MAX_NEW_TOKENS = 32  # the reference serving config decodes up to 1024; cut for run time
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn) -> float:
    """Device time of fn() in ms: ``utils/timing.py:device_ms`` (3 groups of 10 launches
    queued behind a spinning kernel, so the host's launch time is not in it)."""
    from projectiontrainer_tpu_torch.utils.timing import device_ms

    return device_ms(fn)


def compare(name, got, ref, atol=ATOL, rtol=RTOL) -> float:
    """Max |got - ref|; raises unless |got - ref| <= atol + rtol * |ref| everywhere."""
    got, ref = got.float(), ref.float()
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    READINGS[name] = max(READINGS.get(name, 0.0), float(err.max()))
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside atol={atol} "
                             f"rtol={rtol}, max abs err {float(err.max()):.4g}")
    return float(err.max())


def compare_rel(name, got, ref) -> float:
    """Max |got - ref|; raises unless it is <= REL_BWD * max |ref|."""
    got, ref = got.float(), ref.float()
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    READINGS[name] = max(READINGS.get(name, 0.0), err / scale)
    if not err <= REL_BWD * scale:
        raise AssertionError(f"{name}: max abs err {err:.4g} > {REL_BWD} x max|ref| {scale:.4g}")
    return err


# ------------------------------------------------------------- bounds and library calls

PEAK_BF16_OPS = 989e12  # NVIDIA H100 SXM data sheet: dense bf16 tensor-core operations / s
PEAK_BYTES = 3.35e12    # and bytes / s of its device memory


def bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the least time the card could take for `ops` bf16
    tensor-core operations on `nbytes` of inputs read once and outputs written once."""
    by_ops, by_bytes = ops / PEAK_BF16_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def _attn_bytes(b, t, hq, hkv, d, q_like: int, kv_like: int, rows_f32: int):
    """bf16 tensors shaped like q (q_like of them) and like k (kv_like), fp32 [B, Hq, T]
    row statistics (rows_f32)."""
    return 2 * b * t * d * (q_like * hq + kv_like * hkv) + 4 * b * hq * t * rows_f32


def bound_flash_fwd(b, t, hq, hkv, d, pairs=None):
    """K1: S = Q K^T and O = P V, 2 products of 2 * pairs * D operations a head; `pairs`
    counts the unmasked (query, key) pairs over the batch (default: all B * T * T)."""
    pairs = b * t * t if pairs is None else pairs
    return bound(4 * hq * pairs * d, _attn_bytes(b, t, hq, hkv, d, 2, 2, 1))


def bound_flash_bwd_dkv(b, t, hq, hkv, d, pairs=None):
    """K4: S again, dP = dO V^T, dV = P^T dO, dK = dS^T Q: 4 products. Reads q, dO, k, v,
    lse, delta; writes dk, dv."""
    pairs = b * t * t if pairs is None else pairs
    return bound(8 * hq * pairs * d, _attn_bytes(b, t, hq, hkv, d, 2, 4, 2))


def bound_flash_bwd_dq(b, t, hq, hkv, d, pairs=None):
    """K5: S again, dP, dQ = dS K: 3 products. Reads q, dO, k, v, lse, delta; writes dq."""
    pairs = b * t * t if pairs is None else pairs
    return bound(6 * hq * pairs * d, _attn_bytes(b, t, hq, hkv, d, 3, 2, 2))


def bound_layernorm_fwd(n, d):
    """K2: x read, y written (bf16), scale and bias read."""
    return bound(0, 2 * (2 * n * d + 2 * d))


def bound_layernorm_bwd(n, d):
    """K8: x and dy read, dx written (bf16), scale read, dscale and dbias written."""
    return bound(0, 2 * (3 * n * d + 3 * d))


def bound_decode_attn(b, nb, hq, hkv, p, g, d, live_keys=None):
    """K3: one query row a beam over [prefix; generated]: both caches read once, q read,
    out written; 2 products over the live keys of each row."""
    rows = b * nb
    live = rows * (p + g) if live_keys is None else live_keys
    nbytes = 2 * (2 * b * hkv * p * d + 2 * rows * hkv * g * d + 2 * rows * hq * d) + 4 * b * p
    return bound(4 * hq * live * d, nbytes)


def bound_fused_ce_fwd(n, v, d):
    """K6: the logits product, 2 N V D operations; hidden, table, labels read, lse and
    nll written."""
    return bound(2 * n * v * d, 2 * (n + v) * d + 4 * n * 3)


def bound_fused_ce_bwd(n, v, d):
    """K7: the logits again and dh = Q W, 4 N V D operations; hidden, table, labels, lse
    and g read, dh written in fp32."""
    return bound(4 * n * v * d, 2 * (n + v) * d + 4 * n * 3 + 4 * n * d)


def attention_mask(t, *, causal, window, kv_mask):
    """The attention kernels' masks as one bool [B, 1, T, T] tensor (true = the query
    sees the key): what the library call is given, and what live_pairs counts."""
    import torch

    i = torch.arange(t, device="cuda")
    ok = torch.ones((t, t), dtype=torch.bool, device="cuda")
    if causal:
        ok &= i[None, :] <= i[:, None]
    if window is not None:
        ok &= i[:, None] - i[None, :] < window
    return (ok[None] & kv_mask.bool()[:, None, :])[:, None]


def live_pairs(mask) -> int:
    """Unmasked (query, key) pairs over the batch."""
    return int(mask.sum())


def sdpa_library(q, k, v, *, scale, causal=False, mask=None):
    """F.scaled_dot_product_attention on [B, T, H, D] tensors (a yardstick only: the
    port never calls it) -> (fn, name of the backend that ran): the fused backends
    are tried in turn, the math backend last."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.MATH):
        def fn(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                    scale=scale, enable_gqa=gqa)
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return fn, backend.name
    raise AssertionError("no scaled_dot_product_attention backend took these inputs")


def sdpa_library_bwd(q, k, v, do, **kw):
    """The autograd backward of that call (dq, dk, dv together) -> (fn, backend)."""
    import torch

    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    fwd, name = sdpa_library(*leaves, **kw)
    out = fwd()
    dout = do.transpose(1, 2)
    return (lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)), name


# ---------------------------------------------------------------------------- phase 0


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit({"phase": 0, "device": device["kind"], "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return device


# ---------------------------------------------------------------------------- phase 1


def phase_build():
    from projectiontrainer_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    emit({"phase": 1, "library": str(path.relative_to(_build.BUILD_DIR.parents[1])),
          "sources": [str(p.name) for p in _build.sources()],
          "nvcc_s": _build.build_seconds, "build_s": time.perf_counter() - t0})


# ---------------------------------------------------------------------------- phase 2


def _bf16(rng, shape, scale=1.0):
    import torch

    return torch.tensor(rng.standard_normal(shape, dtype=np.float32) * scale,
                        device="cuda").to(torch.bfloat16)


def _left_pad_mask(rng, b, t, max_pad):
    import torch

    pads = rng.integers(0, max_pad, size=b)
    pads[0] = 0
    mask = np.ones((b, t), np.int32)
    for i, n in enumerate(pads):
        mask[i, :n] = 0
    return torch.tensor(mask, device="cuda"), pads


# name -> (route, source, the TPU kernels it replaces); K1/K4/K5 also serve the TPU's
# merged-lane kernels (rows 4-6 of PERF.md's table), whose layout they read as a view
PKG = "projectiontrainer_tpu_torch"
FA_TPU = "projectiontrainer_tpu/ops/flash_attention.py"
KERNELS = {
    "flash_attn_fwd": ("cuda", f"{PKG}/csrc/flash_attn_fwd.cu", [f"{FA_TPU}:84", f"{FA_TPU}:463"]),
    "layernorm_fwd": ("triton", f"{PKG}/ops/fused_layernorm.py",
                      "projectiontrainer_tpu/ops/fused_layernorm.py:59"),
    "decode_attn": ("cuda", f"{PKG}/csrc/decode_attention.cu",
                    "projectiontrainer_tpu/ops/decode_attention.py:116"),
    "flash_attn_bwd_dkv": ("cuda", f"{PKG}/csrc/flash_attn_bwd.cu",
                           [f"{FA_TPU}:210", f"{FA_TPU}:501"]),
    "flash_attn_bwd_dq": ("cuda", f"{PKG}/csrc/flash_attn_bwd.cu",
                          [f"{FA_TPU}:278", f"{FA_TPU}:544"]),
    "fused_ce_fwd": ("cuda", f"{PKG}/csrc/fused_ce.cu", "projectiontrainer_tpu/ops/fused_ce.py:74"),
    "fused_ce_bwd": ("cuda", f"{PKG}/csrc/fused_ce.cu", "projectiontrainer_tpu/ops/fused_ce.py:109"),
    "layernorm_bwd": ("triton", f"{PKG}/ops/fused_layernorm.py",
                      "projectiontrainer_tpu/ops/fused_layernorm.py:91"),
}
SERVE_KERNELS = ("flash_attn_fwd", "layernorm_fwd", "decode_attn")
STAGE1_KERNELS = ("flash_attn_fwd", "layernorm_fwd", "decode_attn", "flash_attn_bwd_dkv",
                  "flash_attn_bwd_dq", "fused_ce_fwd", "fused_ce_bwd")
STAGE0_KERNELS = ("flash_attn_fwd", "layernorm_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq",
                  "layernorm_bwd")


def counters():
    from projectiontrainer_tpu_torch.ops import decode_attention as DA
    from projectiontrainer_tpu_torch.ops import flash_attention as FA
    from projectiontrainer_tpu_torch.ops import fused_ce as CE
    from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN

    found = {c.name: c for c in (FA.launches, FLN.launches, DA.launches, FA.bwd_dkv_launches,
                                 FA.bwd_dq_launches, CE.fwd_launches, CE.bwd_launches,
                                 FLN.bwd_launches)}
    assert set(found) == set(KERNELS)
    return found


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from projectiontrainer_tpu_torch.ops import decode_attention as DA
    from projectiontrainer_tpu_torch.ops import flash_attention as FA
    from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN

    rng = np.random.default_rng(SEED)
    results = {name: [] for name in KERNELS}

    def record(kernel, case, err, ms, plain_ms, bound=(None, None), library_ms=None,
               library=None):
        row = {"kernel": kernel, "case": case, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
               "library_ms": library_ms, "library": library}
        results[kernel].append(row)
        emit({"phase": 2, **row})

    # K2: LayerNorm over the tower's rows
    x = _bf16(rng, (8 * 576, 1024))
    p = {"scale": _bf16(rng, (1024,), 0.5) + 1, "bias": _bf16(rng, (1024,), 0.1)}
    got = FLN.layernorm(p, x)
    ref = FLN.layernorm_reference({k: v.float() for k, v in p.items()}, x.float())
    record("layernorm_fwd", "[4608,1024]", compare("layernorm", got, ref),
           cuda_ms(lambda: FLN.layernorm(p, x)),
           cuda_ms(lambda: FLN.layernorm_reference(p, x)), bound_layernorm_fwd(4608, 1024),
           cuda_ms(lambda: F.layer_norm(x, (1024,), p["scale"], p["bias"], 1e-6)),
           "F.layer_norm")

    # K1: tower shape, non-causal, unmasked
    q, k, v = (_bf16(rng, (8, 576, 16, 64)) for _ in range(3))
    out, lse = FA.flash_attention(q, k, v)
    ref, ref_lse = FA.flash_attention_reference(q.float(), k.float(), v.float())
    err = compare("flash tower out", out, ref)
    compare("flash tower lse", lse, ref_lse)
    lib, backend = sdpa_library(q, k, v, scale=64 ** -0.5)
    record("flash_attn_fwd", "tower [8,576,16,64]", err,
           cuda_ms(lambda: FA.flash_attention(q, k, v)),
           cuda_ms(lambda: FA.flash_attention_reference(q, k, v)),
           bound_flash_fwd(8, 576, 16, 16, 64), cuda_ms(lib), f"SDPA {backend}")

    # K1: Gemma prefill shape, causal, GQA 4/1, ragged left padding, window 512 / none
    q = _bf16(rng, (8, 831, 4, 256))
    k, v = _bf16(rng, (8, 831, 1, 256)), _bf16(rng, (8, 831, 1, 256))
    mask, pads = _left_pad_mask(rng, 8, 831, 224)
    for window in (512, None):
        kw = dict(scale=256 ** -0.5, causal=True, window=window, kv_mask=mask)
        out, lse = FA.flash_attention(q, k, v, **kw)
        ref, ref_lse = FA.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
        err = compare(f"flash prefill window={window}", out, ref)
        live = mask.bool()[:, None, :].expand_as(lse)
        compare("flash prefill lse", lse[live], ref_lse[live])
        for i, n in enumerate(pads):
            if n and bool(out[i, :n].ne(0).any()):
                raise AssertionError(f"flash prefill: left-pad rows of batch {i} are not 0")
        seen = attention_mask(831, causal=True, window=window, kv_mask=mask)
        lib, backend = sdpa_library(q, k, v, scale=kw["scale"], mask=seen)
        record("flash_attn_fwd", f"prefill [8,831,4|1,256] causal window={window}", err,
               cuda_ms(lambda: FA.flash_attention(q, k, v, **kw)),
               cuda_ms(lambda: FA.flash_attention_reference(q, k, v, **kw)),
               bound_flash_fwd(8, 831, 4, 1, 256, live_pairs(seen)),
               cuda_ms(lib), f"SDPA {backend}, explicit mask")

    # K3: split-cache decode, B=8, 3 beams, P=831, G=32
    b, nb, p_len, g = 8, 3, 831, 32
    qd = _bf16(rng, (b * nb, 4, 256))
    kp, vp = _bf16(rng, (b, 1, p_len, 256)), _bf16(rng, (b, 1, p_len, 256))
    kg, vg = _bf16(rng, (b * nb, 1, g, 256)), _bf16(rng, (b * nb, 1, g, 256))
    pmask, _ = _left_pad_mask(rng, b, p_len, 224)
    for t in (0, 17, 31):
        for window in (512, None):
            kw = dict(prefix_mask=pmask, t=t, prefix_len=p_len, scale=256 ** -0.5,
                      window=window)
            got = DA.decode_attention(qd, kp, vp, kg, vg, **kw)
            ref = DA.decode_attention_reference(*(x.float() for x in (qd, kp, vp, kg, vg)),
                                                **kw)
            # the library call: SDPA over the concatenated caches (the prefix repeated
            # per beam, outside the timed call) with the same masks as one bool tensor
            live = pmask.bool().repeat_interleave(nb, 0)
            gen = torch.arange(g, device="cuda") <= t
            if window is not None:
                live = live & (torch.arange(p_len, device="cuda") > p_len + t - window)
                gen = gen & (torch.arange(g, device="cuda") > t - window)
            live = torch.cat([live, gen[None].expand(b * nb, g)], dim=1)
            k_cat = torch.cat([kp.repeat_interleave(nb, 0), kg], dim=2).transpose(1, 2)
            v_cat = torch.cat([vp.repeat_interleave(nb, 0), vg], dim=2).transpose(1, 2)
            lib, backend = sdpa_library(qd[:, None], k_cat, v_cat, scale=kw["scale"],
                                        mask=live[:, None, None, :])
            record("decode_attn", f"B=8 nb=3 P=831 G=32 t={t} window={window}",
                   compare(f"decode t={t} window={window}", got, ref),
                   cuda_ms(lambda: DA.decode_attention(qd, kp, vp, kg, vg, **kw)),
                   cuda_ms(lambda: DA.decode_attention_reference(qd, kp, vp, kg, vg, **kw)),
                   bound_decode_attn(b, nb, 4, 1, p_len, g, 256, int(live.sum())),
                   cuda_ms(lib), f"SDPA {backend} over concatenated caches, explicit mask")

    # K4/K5: the decoder's attention backward at the stage-1 shape, B=4, T=575+512,
    # causal, captions right-padded to varied lengths, window 512 / none
    b, t, n_vis = 4, 1087, 575
    q, do = _bf16(rng, (b, t, 4, 256)), _bf16(rng, (b, t, 4, 256))
    k, v = _bf16(rng, (b, t, 1, 256)), _bf16(rng, (b, t, 1, 256))
    mask = torch.ones((b, t), dtype=torch.int32, device="cuda")
    for i, n in enumerate(rng.integers(16, 513, size=b)):
        mask[i, n_vis + n:] = 0
    for window in (512, None):
        kw = dict(scale=256 ** -0.5, causal=True, window=window)
        out, lse = FA.flash_attention(q, k, v, kv_mask=mask, **kw)
        prep = FA.prepare_bwd(q, k, v, mask, out, lse, do)
        args = (q, k, v, prep[0], prep[1], lse, prep[2])
        dk, dv = FA.launch_bwd_dkv(*args, **kw)
        dq = FA.launch_bwd_dq(*args, **kw)
        rq, rk, rv = FA.flash_attention_bwd_reference(q.float(), k.float(), v.float(), mask,
                                                      out.float(), lse, do.float(), **kw)
        case = f"decoder [4,1087,4|1,256] causal window={window} right-padded captions"
        plain = cuda_ms(lambda: FA.flash_attention_bwd_reference(q, k, v, mask, out, lse, do, **kw))
        seen = attention_mask(t, causal=True, window=window, kv_mask=mask)
        pairs = live_pairs(seen)
        lib, backend = sdpa_library_bwd(q, k, v, do, scale=kw["scale"], mask=seen)
        library = (cuda_ms(lib), f"SDPA {backend} backward (dq, dk, dv together), explicit mask")
        record("flash_attn_bwd_dkv", case,
               max(compare_rel("flash bwd dk", dk, rk), compare_rel("flash bwd dv", dv, rv)),
               cuda_ms(lambda: FA.launch_bwd_dkv(*args, **kw)), plain,
               bound_flash_bwd_dkv(b, t, 4, 1, 256, pairs), *library)
        record("flash_attn_bwd_dq", case, compare_rel("flash bwd dq", dq, rq),
               cuda_ms(lambda: FA.launch_bwd_dq(*args, **kw)), plain,
               bound_flash_bwd_dq(b, t, 4, 1, 256, pairs), *library)

    check_fused_ce(rng, record)
    check_stage0_kernels(rng, record)
    check_flash_reruns(rng, record)
    emit({"phase": 2, "readings": READINGS})
    return results


def check_stage0_kernels(rng, record):
    """The stage-0 shapes (so400m: head dim 72, 1152-wide rows) and the merged-lane
    layout; record(kernel, case, err, ms, plain_ms, bound, library_ms, library)."""
    import torch
    import torch.nn.functional as F

    from projectiontrainer_tpu_torch.ops import flash_attention as FA
    from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN

    # K1 at head dim 72: the vision tower (1024 patches) and the text tower (64 tokens)
    for name, t in (("vision", 1024), ("text", 64)):
        q, k, v = (_bf16(rng, (16, t, 16, 72)) for _ in range(3))
        out, lse = FA.flash_attention(q, k, v)
        ref, ref_lse = FA.flash_attention_reference(q.float(), k.float(), v.float())
        err = compare(f"flash {name} d72 out", out, ref)
        compare(f"flash {name} d72 lse", lse, ref_lse)
        lib, backend = sdpa_library(q, k, v, scale=72 ** -0.5)
        record("flash_attn_fwd", f"{name} [16,{t},16,72]", err,
               cuda_ms(lambda: FA.flash_attention(q, k, v)),
               cuda_ms(lambda: FA.flash_attention_reference(q, k, v)),
               bound_flash_fwd(16, t, 16, 16, 72), cuda_ms(lib), f"SDPA {backend}")

    # K4/K5 at head dim 72 over the vision tower
    q, k, v, do = (_bf16(rng, (16, 1024, 16, 72)) for _ in range(4))
    kw = dict(scale=72 ** -0.5, causal=False, window=None)
    out, lse = FA.flash_attention(q, k, v)
    mask, do, delta = FA.prepare_bwd(q, k, v, None, out, lse, do)
    args = (q, k, v, mask, do, lse, delta)
    dk, dv = FA.launch_bwd_dkv(*args, **kw)
    dq = FA.launch_bwd_dq(*args, **kw)
    rq, rk, rv = FA.flash_attention_bwd_reference(q.float(), k.float(), v.float(), None,
                                                  out.float(), lse, do.float(), **kw)
    plain = cuda_ms(lambda: FA.flash_attention_bwd_reference(q, k, v, None, out, lse, do, **kw))
    case = "vision [16,1024,16,72] non-causal"
    lib, backend = sdpa_library_bwd(q, k, v, do, scale=kw["scale"])
    library = (cuda_ms(lib), f"SDPA {backend} backward (dq, dk, dv together)")
    record("flash_attn_bwd_dkv", case,
           max(compare_rel("flash d72 bwd dk", dk, rk), compare_rel("flash d72 bwd dv", dv, rv)),
           cuda_ms(lambda: FA.launch_bwd_dkv(*args, **kw)), plain,
           bound_flash_bwd_dkv(16, 1024, 16, 16, 72), *library)
    record("flash_attn_bwd_dq", case, compare_rel("flash d72 bwd dq", dq, rq),
           cuda_ms(lambda: FA.launch_bwd_dq(*args, **kw)), plain,
           bound_flash_bwd_dq(16, 1024, 16, 16, 72), *library)
    del q, k, v, do, out, lse, delta, dq, dk, dv, rq, rk, rv, lib
    check_nearly_alike_tokens(rng)

    # K2 and K8 over the vision tower's rows; K8 also at a ragged row count
    x = _bf16(rng, (16384, 1152))
    p = {"scale": _bf16(rng, (1152,), 0.5) + 1, "bias": _bf16(rng, (1152,), 0.1)}
    got = FLN.layernorm(p, x)
    ref = FLN.layernorm_reference({k: v.float() for k, v in p.items()}, x.float())
    record("layernorm_fwd", "vision rows [16384,1152]", compare("layernorm 1152", got, ref),
           cuda_ms(lambda: FLN.layernorm(p, x)), cuda_ms(lambda: FLN.layernorm_reference(p, x)),
           bound_layernorm_fwd(16384, 1152),
           cuda_ms(lambda: F.layer_norm(x, (1152,), p["scale"], p["bias"], 1e-6)), "F.layer_norm")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, want_ragged in ((16384, False), (16383, True), (1001, True), (1000, False),
                           (529, True)):
        rows, programs = FLN.bwd_grid(n, sms)
        ragged = rows * programs > n
        if want_ragged and not ragged:
            raise AssertionError(f"layernorm bwd: {n} rows fill every program ({rows} x "
                                 f"{programs} on {sms} SMs); the ragged case is not exercised")
        x2, dy = x[:n], _bf16(rng, (n, 1152))
        got = FLN.layernorm_bwd(x2, dy, p["scale"], 1e-6)
        ref = FLN.layernorm_bwd_reference(x2.float(), dy.float(), p["scale"].float(), 1e-6)
        err = max(compare_rel(f"layernorm bwd {part} [{n},1152]", a, b)
                  for part, a, b in zip(("dx", "dscale", "dbias"), got, ref))
        case = f"[{n},1152]" + (f" ragged: last of {programs} programs holds "
                                f"{n - rows * (programs - 1)} of {rows} rows" if ragged else "")
        leaves = [x2.detach().requires_grad_(True), p["scale"].detach().requires_grad_(True),
                  p["bias"].detach().requires_grad_(True)]
        y = F.layer_norm(leaves[0], (1152,), leaves[1], leaves[2], 1e-6)
        record("layernorm_bwd", case, err,
               cuda_ms(lambda: FLN.layernorm_bwd(x2, dy, p["scale"], 1e-6)),
               cuda_ms(lambda: FLN.layernorm_bwd_reference(x2, dy, p["scale"], 1e-6)),
               bound_layernorm_bwd(n, 1152),
               cuda_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)),
               "F.layer_norm backward (dx, dscale, dbias)")

    # rows 4-6: the merged-lane layout [B, T, H*D] through the same kernels, as views
    from projectiontrainer_tpu_torch.ops.attention import dot_product_attention

    for hkv in (8, 2):
        qm = _bf16(rng, (2, 1024, 8 * 128)).requires_grad_(True)
        km, vm = (_bf16(rng, (2, 1024, hkv * 128)).requires_grad_(True) for _ in range(2))
        g = _bf16(rng, (2, 1024, 8 * 128))
        out = FA.flash_attention_merged(qm, km, vm, heads=8, kv_heads=hkv)
        grads = torch.autograd.grad(out, (qm, km, vm), g)
        views = [x.detach().float().view(2, 1024, -1, 128).requires_grad_(True)
                 for x in (qm, km, vm)]
        ref = dot_product_attention(*views).reshape(out.shape)
        refs = torch.autograd.grad(ref, views, g.float())
        case = f"merged [2,1024,8*128] kv heads {hkv}"
        lib, backend = sdpa_library(*(x.detach().view(2, 1024, -1, 128) for x in (qm, km, vm)),
                                    scale=128 ** -0.5)
        record("flash_attn_fwd", case, compare(f"flash merged kv={hkv} out", out, ref),
               cuda_ms(lambda: FA.flash_attention_merged(qm, km, vm, heads=8, kv_heads=hkv)),
               cuda_ms(lambda: dot_product_attention(*(x.view(2, 1024, -1, 128)
                                                       for x in (qm, km, vm)))),
               bound_flash_fwd(2, 1024, 8, hkv, 128), cuda_ms(lib), f"SDPA {backend}")
        errs = [compare_rel(f"flash merged kv={hkv} d{n}", a.reshape(b.shape), b)
                for n, a, b in zip("qkv", grads, refs)]
        record("flash_attn_bwd_dq", case, errs[0], None, None)
        record("flash_attn_bwd_dkv", case, max(errs[1:]), None, None)


def check_flash_reruns(rng, record):
    """K1 and K4 at a T that no tile divides ([16,1000,16,72]; the text tower's T = 64 is
    among the stage-0 shapes), K1's fp32 copy of O against its bf16 O, and a rerun of
    each kernel held bit-equal, there and at the decoder's masked GQA shape;
    record(kernel, case, err, ms, plain_ms, bound, library_ms, library)."""
    import torch

    from projectiontrainer_tpu_torch.ops import flash_attention as FA

    q, k, v, do = (_bf16(rng, (16, 1000, 16, 72)) for _ in range(4))
    kw = dict(scale=72 ** -0.5, causal=False, window=None)
    out, lse, out32 = FA._launch(q, k, v, kv_mask=None, out_f32=True, **kw)
    ref, ref_lse = FA.flash_attention_reference(q.float(), k.float(), v.float())
    err = compare("flash ragged d72 out", out, ref)
    compare("flash ragged d72 lse", lse, ref_lse)
    if not torch.equal(out32.to(torch.bfloat16), out):
        raise AssertionError("flash forward: the fp32 copy of O does not round to its bf16 O")
    case = "ragged [16,1000,16,72] non-causal"
    lib, backend = sdpa_library(q, k, v, scale=kw["scale"])
    record("flash_attn_fwd", case, err, cuda_ms(lambda: FA.flash_attention(q, k, v)),
           cuda_ms(lambda: FA.flash_attention_reference(q, k, v)),
           bound_flash_fwd(16, 1000, 16, 16, 72), cuda_ms(lib), f"SDPA {backend}")
    mask, do, delta = FA.prepare_bwd(q, k, v, None, out32, lse, do)
    args = (q, k, v, mask, do, lse, delta)
    dk, dv = FA.launch_bwd_dkv(*args, **kw)
    _, rk, rv = FA.flash_attention_bwd_reference(q.float(), k.float(), v.float(), None, out32,
                                                 lse, do.float(), **kw)
    lib, backend = sdpa_library_bwd(q, k, v, do, scale=kw["scale"])
    record("flash_attn_bwd_dkv", case,
           max(compare_rel("flash ragged d72 dk", dk, rk), compare_rel("flash ragged d72 dv", dv, rv)),
           cuda_ms(lambda: FA.launch_bwd_dkv(*args, **kw)),
           cuda_ms(lambda: FA.flash_attention_bwd_reference(q, k, v, None, out32, lse, do, **kw)),
           bound_flash_bwd_dkv(16, 1000, 16, 16, 72), cuda_ms(lib),
           f"SDPA {backend} backward (dq, dk, dv together)")

    def rerun(name, first, fn):
        for _ in range(2):
            if not all(torch.equal(a, b) for a, b in zip(first, fn())):
                raise AssertionError(f"{name}: a rerun on the same inputs gave other bits")

    rerun("flash forward d72", (out, lse, out32),
          lambda: FA._launch(q, k, v, kv_mask=None, out_f32=True, **kw))
    rerun("flash dkv d72", (dk, dv), lambda: FA.launch_bwd_dkv(*args, **kw))
    del q, k, v, do, out, lse, out32, delta, dk, dv, rk, rv, ref, ref_lse, lib

    # the decoder's shape: causal, window 512, GQA 4/1, right-padded captions
    b, t = 4, 1087
    q, do = _bf16(rng, (b, t, 4, 256)), _bf16(rng, (b, t, 4, 256))
    k, v = _bf16(rng, (b, t, 1, 256)), _bf16(rng, (b, t, 1, 256))
    mask = torch.ones((b, t), dtype=torch.int32, device="cuda")
    for i, n in enumerate(rng.integers(16, 513, size=b)):
        mask[i, 575 + n:] = 0
    kw = dict(scale=256 ** -0.5, causal=True, window=512)
    first = FA._launch(q, k, v, kv_mask=mask, out_f32=True, **kw)
    rerun("flash forward d256", first,
          lambda: FA._launch(q, k, v, kv_mask=mask, out_f32=True, **kw))
    prep = FA.prepare_bwd(q, k, v, mask, first[2], first[1], do)
    args = (q, k, v, prep[0], prep[1], first[1], prep[2])
    rerun("flash dkv d256", FA.launch_bwd_dkv(*args, **kw), lambda: FA.launch_bwd_dkv(*args, **kw))
    emit({"phase": 2, "check": "K1 fp32 O rounds to its bf16 O; K1 and K4 reruns bit-equal at "
                               "[16,1000,16,72] and [4,1087,4|1,256] causal window 512"})


def check_nearly_alike_tokens(rng):
    """K1/K4/K5 through autograd at the vision tower's shape on tokens whose q, k and v
    share a common part 15x their spread (a trained tower's last layers), where the
    backward's delta and dS's rounding show along the common component: each gradient's
    cosine to fp32 attention within NEAR_COS_GAP of plain bf16 attention's."""
    import torch
    import torch.nn.functional as F

    from projectiontrainer_tpu_torch.ops import flash_attention as FA
    from projectiontrainer_tpu_torch.ops.attention import dot_product_attention

    shape = (16, 1024, 16, 72)
    common = 3 * rng.standard_normal((1, 1, 16, 72)).astype(np.float32)
    base = [torch.tensor(common + 0.2 * rng.standard_normal(shape, dtype=np.float32),
                         device="cuda").to(torch.bfloat16) for _ in range(3)]
    g = _bf16(rng, shape)
    grads = {}
    for path, fn, dtype in (("kernel", lambda *x: FA.flash_attention(*x)[0], torch.bfloat16),
                            ("plain", dot_product_attention, torch.bfloat16),
                            ("fp32", dot_product_attention, torch.float32)):
        inputs = [x.detach().to(dtype).requires_grad_(True) for x in base]
        grads[path] = torch.autograd.grad(fn(*inputs), inputs, g.to(dtype))
        torch.cuda.empty_cache()
    cos = {path: [float(F.cosine_similarity(a.float().flatten(), b.flatten(), dim=0))
                  for a, b in zip(grads[path], grads["fp32"])] for path in ("kernel", "plain")}
    READINGS["flash d72 nearly alike tokens cosine dq/dk/dv"] = cos
    emit({"phase": 2, "check": "nearly alike tokens [16,1024,16,72], common x3, spread 0.2",
          "cosine_to_fp32": cos})
    for name, a, b in zip(("dq", "dk", "dv"), cos["kernel"], cos["plain"]):
        if not a >= b - NEAR_COS_GAP:
            raise AssertionError(f"flash nearly alike tokens: {name} cosine {a:.5f} vs plain "
                                 f"bf16 {b:.5f}")


def check_fused_ce(rng, record):
    """K6/K7 against their plain versions and beside the library call (F.linear +
    F.cross_entropy on bf16 logits, and its autograd backward to the hidden states);
    record(kernel, case, err, ms, plain_ms, bound, library_ms, library)."""
    import torch
    import torch.nn.functional as F

    from projectiontrainer_tpu_torch.ops import fused_ce as CE

    # K6/K7: the stage-1 CE over 4 x 512 caption positions at Gemma3's vocab, a quarter
    # of the positions ignored (label -100: a dummy 0 and zero upstream gradient). At a
    # table scale of 0.15 the logits' std is ~5, so each row's softmax mass sits on a
    # few tokens in one vocab split or another, and the upstream gradient g differs
    # per row (mean-loss weights times a random factor, exact in bf16: the kernel's
    # bf16 (p - onehot) * g is then exactly -g at a label of negligible p).
    n, vocab, d = 2048, 262_144, 1152
    h, table = _bf16(rng, (n, d)), _bf16(rng, (vocab, d), 0.15)
    labels = rng.integers(0, vocab, size=n)
    ignored = rng.random(n) < 0.25
    valid = torch.tensor(~ignored, device="cuda")
    safe = torch.tensor(np.where(ignored, 0, labels), dtype=torch.int32, device="cuda")
    g = np.where(ignored, 0.0, rng.uniform(0.5, 1.5, size=n) / (~ignored).sum())
    g = torch.tensor(g, dtype=torch.float32, device="cuda").to(torch.bfloat16).float()
    case = "[2048,1152] x [262144,1152] scale 0.15, 25% ignored, g per row"
    lse, nll = CE.fused_ce_fwd(h, table, safe)
    rlse, rnll = CE.fused_ce_reference(h.float(), table.float(), safe)
    err = max(compare("fused ce lse", lse, rlse, atol=CE_ATOL, rtol=0),
              compare("fused ce nll", nll[valid], rnll[valid], atol=CE_ATOL, rtol=0))
    long_labels = safe.long()
    record("fused_ce_fwd", case, err, cuda_ms(lambda: CE.fused_ce_fwd(h, table, safe)),
           cuda_ms(lambda: CE.fused_ce_reference(h, table, safe)), bound_fused_ce_fwd(n, vocab, d),
           cuda_ms(lambda: F.cross_entropy(F.linear(h, table), long_labels, reduction="none")),
           "F.linear + F.cross_entropy(reduction='none'), bf16 logits")
    dh = CE.fused_ce_bwd(h, table, safe, lse, g)
    rdh = CE.fused_ce_bwd_reference(h.float(), table.float(), safe, rlse, g)
    # the softmax part g * sum_v p_v W_v on its own: the one-hot term -g * W[label]
    # is exact in both, and would otherwise set the bound's scale
    onehot = g[:, None] * table[safe.long()].float()
    err = max(compare_rel("fused ce dh", dh, rdh),
              compare_rel("fused ce dh softmax part", dh + onehot, rdh + onehot))
    if bool(dh[~valid].ne(0).any()):
        raise AssertionError("fused ce dh: an ignored position got a gradient")
    hg = h.detach().requires_grad_(True)
    lib_nll = F.cross_entropy(F.linear(hg, table), long_labels, reduction="none")
    lib_g = g.to(lib_nll.dtype)
    record("fused_ce_bwd", case, err,
           cuda_ms(lambda: CE.fused_ce_bwd(h, table, safe, lse, g)),
           cuda_ms(lambda: CE.fused_ce_bwd_reference(h, table, safe, lse, g)),
           bound_fused_ce_bwd(n, vocab, d),
           cuda_ms(lambda: torch.autograd.grad(lib_nll, hg, lib_g, retain_graph=True)),
           "autograd backward of F.linear + F.cross_entropy to the hidden states")


# ---------------------------------------------------------------------------- phase 3


class StubTokenizer:
    """ids -> text with no vocabulary files: the smoke needs no tokenizer snapshot."""

    pad_token_id = 0
    eos_token_id = 1

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{int(i)}" for i in ids if not (skip_special_tokens and i in (0, 1)))

    def __call__(self, texts, padding="max_length", truncation=True, max_length=16):
        """Each character's code point + 2 as a token id, padded with 0 to max_length."""
        ids = [[2 + ord(c) for c in t][:max_length] for t in texts]
        return {"input_ids": [row + [0] * (max_length - len(row)) for row in ids]}


def full_width_model():
    import torch

    from projectiontrainer_tpu_torch.models import decoder as dec
    from projectiontrainer_tpu_torch.models import projector as proj
    from projectiontrainer_tpu_torch.models import siglip, vlm

    cfg = vlm.VLMConfig(vision=siglip.vit_l_16_384(),
                        projector=proj.ProjectorConfig(vision_dim=1024, llm_dim=1152),
                        llm=dec.gemma3_config())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = vlm.init(gen, cfg, device="cuda", tower_dtype=torch.bfloat16,
                      projector_dtype=torch.float32)
    return cfg, params


def phase_serve(cfg, params, counters):
    import logging

    from projectiontrainer_tpu_torch.cli import serve

    size = cfg.vision.image_size
    args = serve.build_parser().parse_args([
        "--vision_model_name", "in-memory", "--llm_name", "in-memory", "--projector_path", "",
        "--img_size", str(size), "--batch_size", "8", "--num_beams", "3",
        "--repetition_penalty", "1.8", "--length_penalty", "1.2", "--max_q_len", "256",
        "--max_new_tokens", str(MAX_NEW_TOKENS), "--max_wait_ms", "20",
    ])
    service = serve.VQAService(args, logging.getLogger("chip_smoke"),
                               model=(cfg, params, StubTokenizer()))
    t0 = time.perf_counter()
    service.warmup()  # one batch per question bucket: first-call costs stay out of the stats
    warmup_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED + 1)
    requests = [
        serve.Request(np.clip(rng.standard_normal((size, size, 3), dtype=np.float32), -1, 1),
                      rng.integers(2, cfg.llm.vocab_size, size=int(rng.integers(8, 201))).tolist())
        for _ in range(32)
    ]
    answers: list = [None] * len(requests)
    errors: list = []

    def client(i):
        for j in (2 * i, 2 * i + 1):
            try:
                answers[j] = service.submit(requests[j], timeout_s=600)
            except Exception as e:  # reported below: the phase fails
                errors.append(repr(e))

    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    wall = time.perf_counter() - t0
    launches = {c.name: c.value for c in counters}
    service.shutdown()
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"serve: client failures {errors[:3]}")
    if any(a is None or not isinstance(a, str) for a in answers):
        raise AssertionError("serve: not every request got an answer")
    if not all(launches.values()):
        raise AssertionError(f"serve: a kernel of the path never launched: {launches}")
    stats = service.stats()
    emit({"phase": 3, "requests": len(answers), "answered": sum(a is not None for a in answers),
          "req_per_s": len(answers) / wall, "wall_s": wall, "warmup_s": warmup_s,
          "stats": stats, "launches": launches, "batch_size": 8, "num_beams": 3,
          "max_new_tokens": MAX_NEW_TOKENS,
          "cut": "max_new_tokens 32 (reference serving config: 1024), for run time"})
    return launches


# ---------------------------------------------------------------------------- phase 4


def phase_end_to_end(cfg, params):
    import torch
    import torch.nn.functional as F

    from projectiontrainer_tpu_torch.cli import infer_vqa_stage2 as vqa
    from projectiontrainer_tpu_torch.generate import decode as D
    from projectiontrainer_tpu_torch.models import decoder as dec

    plain = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, attn_impl="plain", norm_impl="plain"),
        llm=dataclasses.replace(cfg.llm, attn_impl="plain"))
    rng = np.random.default_rng(SEED + 2)
    size = cfg.vision.image_size
    pixels = np.clip(rng.standard_normal((8, size, size, 3), dtype=np.float32), -1, 1)
    q_tok = [rng.integers(2, cfg.llm.vocab_size, size=int(n)).tolist()
             for n in rng.integers(8, 120, size=8)]
    tok = StubTokenizer()
    nb = 3
    teacher = torch.tensor(rng.integers(2, cfg.llm.vocab_size, size=(4, 8 * nb)),
                           device=params["llm"]["embed_tokens"]["embedding"].device)

    def run(c):
        embeds, mask = vqa.build_prefix(pixels, q_tok, c, params, tok, max_q_len=256)
        p = embeds.shape[1]
        cache, logits, last_pos, _ = D._prefill(params["llm"], c.llm, embeds, mask, p)
        cache, pmask = dec.split_cache(cache, c.llm, 8 * nb, 4, prefix_mask=mask)
        out = [logits]
        last_pos = last_pos.repeat_interleave(nb)
        for t in range(4):
            logits, cache = D._step(params["llm"], c.llm, teacher[t], last_pos, t, pmask,
                                    cache, p, embeds.dtype)
            out.append(logits)
        return out

    kernel_path, plain_path = run(cfg), run(plain)
    rows = []
    for i, (a, b) in enumerate(zip(kernel_path, plain_path)):
        cos = float(F.cosine_similarity(a.float(), b.float(), dim=-1).min())
        top1 = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        rows.append({"step": "prefill" if i == 0 else f"decode {i - 1}", "min_cosine": cos,
                     "top1_agreement": top1})
        if not cos >= 0.99:
            raise AssertionError(f"end to end: {rows[-1]['step']} cosine {cos:.5f} < 0.99")
    emit({"phase": 4, "logits": rows})


# ---------------------------------------------------------------------------- phase 5


class CaptionDataset:
    """In-memory stage-1 samples: seeded pixels in [-1, 1] and 512-token captions
    right-padded (pad id 0) to varied lengths; no image files, no tokenizer."""

    def __init__(self, n, seed, *, size, vocab, max_len=512):
        rng = np.random.default_rng(seed)
        self.lengths = rng.integers(32, max_len + 1, size=n)
        self.lengths[0] = max_len
        self.seeds = rng.integers(0, 2 ** 31, size=n)
        self.size, self.vocab, self.max_len = size, vocab, max_len

    def __len__(self):
        return len(self.seeds)

    def __getitem__(self, i):
        rng = np.random.default_rng(int(self.seeds[i]))
        pixels = np.clip(rng.standard_normal((self.size, self.size, 3), dtype=np.float32), -1, 1)
        caption = np.zeros(self.max_len, np.int32)
        caption[:self.lengths[i]] = rng.integers(2, self.vocab, size=self.lengths[i])
        return {"pixel_values": pixels, "caption_ids": caption}


def _projector_leaves(params):
    from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths

    return list(leaves_with_paths(params["projector"]))


def phase_train(cfg, params, kernel_counters):
    import torch

    from projectiontrainer_tpu_torch.core.config import Stage1Config
    from projectiontrainer_tpu_torch.train.trainer_stage1 import Stage1Trainer

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        tcfg = Stage1Config(output_dir=out_dir, batch_size=4, num_epochs=1, logging_steps=1,
                            num_workers=2, device=DEVICE, learning_rate=1e-4,
                            save_every_n_epochs=0, disable_wandb=True, seed=SEED,
                            img_size=cfg.vision.image_size, max_caption_len=512,
                            profile_dir=os.path.join(out_dir, "profile"),
                            profile_start_step=6, profile_num_steps=2)
        data = dict(size=cfg.vision.image_size, vocab=cfg.llm.vocab_size)
        trainer = Stage1Trainer(tcfg, vlm_cfg=cfg, params=params, tokenizer=StubTokenizer(),
                                train_dataset=CaptionDataset(32, SEED + 3, **data),
                                val_dataset=CaptionDataset(4, SEED + 4, **data))
        before = {p: x.detach().clone() for p, x in _projector_leaves(params)}
        for c in kernel_counters.values():
            c.reset()
        t0 = time.perf_counter()
        result = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: c.value for name, c in kernel_counters.items()}
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        exported = os.path.exists(os.path.join(out_dir, "projector_final.bin"))
        traced = os.listdir(os.path.join(out_dir, "profile"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    losses = [r["train/batch_loss"] for r in rows if "train/batch_loss" in r]
    moved = max(float((x.detach() - before[p]).abs().max()) for p, x in _projector_leaves(params))
    if len(losses) != 8 or not np.isfinite(losses).all():
        raise AssertionError(f"train: expected 8 finite losses, got {losses}")
    if not moved > 0:
        raise AssertionError("train: the projector did not change")
    if not exported:
        raise AssertionError("train: projector_final.bin was not written")
    if not all(launches[n] for n in STAGE1_KERNELS):
        raise AssertionError(f"train: a kernel of the path never launched: {launches}")
    stats = {"images_per_sec": result.get("images_per_sec"),
             "step_time_ms": result.get("step_time_ms")}
    if not all(stats.values()):
        raise AssertionError(f"train: no throughput measured: {result}")
    split = {k[len("profile/"):]: v for r in rows for k, v in r.items()
             if k.startswith("profile/")}
    pieces = ("tower_fwd", "projector_fwd", "projector_bwd", "decoder_fwd", "decoder_bwd",
              "lm_head_ce_fwd", "lm_head_ce_bwd", "optimizer_fwd")
    if traced != ["trace_step6.json"] or not all(split.get(f"{p}_ms", 0) > 0 for p in pieces):
        raise AssertionError(f"train: no kernel time traced for a piece of the step: {split}")
    idle = 1 - split["total_ms"] / stats["step_time_ms"]
    print(f"train: {stats['images_per_sec']:.3f} images/s, {stats['step_time_ms']:.1f} ms/step "
          f"at batch 4 x 1087 tokens; kernel time {split['total_ms']:.1f} ms/step "
          f"(device idle {idle:.1%})", flush=True)
    emit({"phase": 5, "steps": len(losses), "losses": losses, **stats, "wall_s": wall,
          "val_loss": result.get("best_val_loss"), "projector_max_change": moved,
          "launches": launches, "batch_size": 4, "tokens_per_row": 1087,
          "kernel_ms_per_step": split, "device_idle_share": idle,
          "timed_steps": "1-5 (0 warms up, 6-7 profiled)",
          "cut": "8 steps of random data (a real epoch is the whole caption corpus)"})
    return launches


# ---------------------------------------------------------------------------- phase 6


def _train_batch(cfg, n=4):
    import torch

    ds = CaptionDataset(n, SEED + 5, size=cfg.vision.image_size, vocab=cfg.llm.vocab_size)
    rows = [ds[i] for i in range(n)]
    return {k: torch.tensor(np.stack([r[k] for r in rows]), device=DEVICE) for k in rows[0]}


def phase_train_end_to_end(cfg, params, kernel_counters):
    import torch
    import torch.nn.functional as F

    from projectiontrainer_tpu_torch.train import steps

    plain = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, attn_impl="plain", norm_impl="plain"),
        llm=dataclasses.replace(cfg.llm, attn_impl="plain"))
    batch = _train_batch(cfg)
    leaves = [x for _, x in _projector_leaves(params)]
    for x in leaves:
        x.requires_grad_(True)

    def run(c, ce_impl):
        for counter in kernel_counters.values():
            counter.reset()
        loss_fn = steps.stage1_loss(c, 0, logits_chunk=128, ce_impl=ce_impl,
                                    compute_dtype=torch.bfloat16)
        loss, _ = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return float(loss.detach()), grads, {n: k.value for n, k in kernel_counters.items()}

    loss_k, grads_k, launches_k = run(cfg, "auto")
    loss_p, grads_p, launches_p = run(plain, "chunked")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos = [float(F.cosine_similarity(a.flatten().float(), b.flatten().float(), dim=0))
           for a, b in zip(grads_k, grads_p)]
    emit({"phase": 6, "loss_kernel": loss_k, "loss_plain": loss_p, "loss_rel_diff": rel,
          "grad_cosine": dict(zip([n for n, _ in _projector_leaves(params)], cos)),
          "launches_kernel_path": launches_k})
    step_kernels = {n: launches_k[n] for n in STAGE1_KERNELS if n != "decode_attn"}
    if not all(step_kernels.values()) or any(launches_p.values()):
        raise AssertionError(f"train end to end: kernel path {launches_k}, plain {launches_p}")
    if not rel <= LOSS_REL:
        raise AssertionError(f"train end to end: loss {loss_k} vs plain {loss_p}")
    if not min(cos) >= COS_MIN:
        raise AssertionError(f"train end to end: projector gradient cosine {min(cos):.5f} "
                             f"< {COS_MIN}")


# ---------------------------------------------------------------------------- phase 7


class ContrastiveSamples:
    """In-memory stage-0 samples: seeded pixels in [-1, 1] (made once, in bulk), 64
    token ids each and one of ``n_classes`` classes; no image files, no tokenizer."""

    def __init__(self, n, seed, *, size, vocab, n_classes=4, text_len=64):
        rng = np.random.default_rng(seed)
        self.pixels = np.clip(rng.standard_normal((n, size, size, 3), dtype=np.float32), -1, 1)
        self.ids = rng.integers(2, vocab, size=(n, text_len)).astype(np.int32)
        self.classes = rng.integers(0, n_classes, size=n).astype(np.int32)

    def __len__(self):
        return len(self.classes)

    def __getitem__(self, i):
        return {"pixel_values": self.pixels[i], "input_ids": self.ids[i],
                "class_idx": self.classes[i], "valid": np.bool_(True)}


def stage0_model():
    import torch

    from projectiontrainer_tpu_torch.models import siglip

    cfg = siglip.SiglipConfig(vision=siglip.so400m_16_512(), text=siglip.so400m_text())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return cfg, siglip.init(gen, cfg, device="cuda", vision_dtype=torch.float32,
                            text_dtype=torch.bfloat16)


def _watched_leaves(params):
    v = params["vision"]
    return {"vision/patch_embedding/weight": v["patch_embedding"]["weight"],
            "vision/layers/13/attn/q_proj/weight": v["layers"][13]["attn"]["q_proj"]["weight"],
            "vision/layers/26/ln2/scale": v["layers"][26]["ln2"]["scale"],
            "vision/head/probe": v["head"]["probe"], "logit_bias": params["logit_bias"]}


def phase_stage0_train(cfg, params, kernel_counters):
    import torch

    from projectiontrainer_tpu_torch.core.config import Stage0Config
    from projectiontrainer_tpu_torch.train.trainer_stage0 import Stage0Trainer

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_stage0_")
    size, vocab = cfg.vision.image_size, cfg.text.vocab_size
    try:
        tcfg = Stage0Config(output_dir=out_dir, batch_size=16, num_epochs=1, logging_steps=1,
                            num_workers=2, device=DEVICE, disable_wandb=True, seed=SEED,
                            img_size=size, max_text_len=cfg.text.max_position_embeddings,
                            profile_dir=os.path.join(out_dir, "profile"),
                            profile_start_step=6, profile_num_steps=2)
        trainer = Stage0Trainer(tcfg, model_cfg=cfg, params=params, tokenizer=StubTokenizer(),
                                train_dataset=ContrastiveSamples(128, SEED + 6, size=size,
                                                                 vocab=vocab),
                                val_dataset=ContrastiveSamples(16, SEED + 7, size=size,
                                                               vocab=vocab),
                                class_names=["pneumonia", "edema", "cardiomegaly", "no finding"])
        before = {p: x.detach().clone() for p, x in _watched_leaves(params).items()}
        for c in kernel_counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: c.value for name, c in kernel_counters.items()}
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        exported = sorted(os.listdir(os.path.join(out_dir, "best_model")))
        traced = os.listdir(os.path.join(out_dir, "profile"))
        del trainer
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [r["train/batch_loss"] for r in rows if "train/batch_loss" in r]
    moved = {p: float((x.detach().float() - before[p].float()).abs().max())
             for p, x in _watched_leaves(params).items()}
    zero_shot = {k[len("zero_shot/"):]: v for r in rows for k, v in r.items()
                 if k.startswith("zero_shot/")}
    if len(losses) != 8 or not np.isfinite(losses).all():
        raise AssertionError(f"stage 0: expected 8 finite losses, got {losses}")
    if not all(m > 0 for m in moved.values()):
        raise AssertionError(f"stage 0: a trainable leaf did not change: {moved}")
    if "accuracy" not in zero_shot:
        raise AssertionError("stage 0: no zero-shot validation")
    if exported != ["config.json", "model.safetensors"]:
        raise AssertionError(f"stage 0: the HF export holds {exported}")
    if not all(launches[n] for n in STAGE0_KERNELS):
        raise AssertionError(f"stage 0: a kernel of the path never launched: {launches}")
    stats = {"images_per_sec": result.get("images_per_sec"),
             "step_time_ms": result.get("step_time_ms")}
    if not all(stats.values()):
        raise AssertionError(f"stage 0: no throughput measured: {result}")
    split = {k[len("profile/"):]: v for r in rows for k, v in r.items()
             if k.startswith("profile/")}
    pieces = ("vision_fwd", "vision_bwd", "text_fwd", "loss_fwd", "optimizer_fwd")
    if traced != ["trace_step6.json"] or not all(split.get(f"{p}_ms", 0) > 0 for p in pieces):
        raise AssertionError(f"stage 0: no kernel time traced for a piece of the step: {split}")
    if "text_bwd_ms" in split:
        raise AssertionError(f"stage 0: the frozen text tower ran a backward: {split}")
    idle = 1 - split["total_ms"] / stats["step_time_ms"]
    print(f"stage 0: {stats['images_per_sec']:.3f} images/s, {stats['step_time_ms']:.1f} ms/step "
          f"at batch 16 x 512 px (so400m); kernel time {split['total_ms']:.1f} ms/step "
          f"(device idle {idle:.1%})", flush=True)
    emit({"phase": 7, "steps": len(losses), "losses": losses, **stats, "wall_s": wall,
          "zero_shot": zero_shot, "leaf_max_change": moved, "launches": launches,
          "batch_size": 16, "image_size": size, "peak_memory_gib": peak_gb,
          "kernel_ms_per_step": split, "device_idle_share": idle, "export": exported,
          "timed_steps": "1-5 (0 warms up, 6-7 profiled)",
          "cut": "8 steps of random weights and data, 16 validation samples (a real run: "
                 "the caption corpus, many epochs)"})
    return launches


# ---------------------------------------------------------------------------- phase 8


def phase_stage0_end_to_end(cfg, params, kernel_counters):
    import torch
    import torch.nn.functional as F

    from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths
    from projectiontrainer_tpu_torch.train import masks, steps

    plain_tower = dict(attn_impl="plain", norm_impl="plain")
    plain = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, **plain_tower),
                                text=dataclasses.replace(cfg.text, **plain_tower))
    data = ContrastiveSamples(4, SEED + 8, size=cfg.vision.image_size, vocab=cfg.text.vocab_size)
    batch = {k: torch.tensor(np.stack([data[i][k] for i in range(4)]), device=DEVICE)
             for k in ("pixel_values", "input_ids")}
    mask = dict(leaves_with_paths(masks.bool_mask(masks.stage0_labels(params))))
    train = [(p, x) for p, x in leaves_with_paths(params) if mask[p]]
    for p, x in leaves_with_paths(params):
        x.requires_grad_(mask[p])

    def run(c):
        for counter in kernel_counters.values():
            counter.reset()
        loss, _ = steps.stage0_loss(c, compute_dtype=torch.bfloat16)(params, batch)
        grads = torch.autograd.grad(loss, [x for _, x in train])
        torch.cuda.synchronize()
        return float(loss.detach()), grads, {n: k.value for n, k in kernel_counters.items()}

    loss_k, grads_k, launches_k = run(cfg)
    loss_p, grads_p, launches_p = run(plain)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos, key_bias = {}, [0.0, 0.0]
    for (path, _), a, b in zip(train, grads_k, grads_p):
        if path.endswith("k_proj/bias"):  # zero in exact arithmetic: both sides are noise
            key_bias = [max(key_bias[0], float(a.float().norm())),
                        max(key_bias[1], float(b.float().norm()))]
        else:
            cos[path] = float(F.cosine_similarity(a.flatten().float(), b.flatten().float(), dim=0))
    worst = min(cos, key=cos.get)
    emit({"phase": 8, "batch_size": 4, "loss_kernel": loss_k, "loss_plain": loss_p,
          "loss_rel_diff": rel, "leaves_compared": len(cos), "min_grad_cosine": cos[worst],
          "min_grad_cosine_leaf": worst, "key_bias_grad_norm_max_kernel_plain": key_bias,
          "launches_kernel_path": launches_k})
    if not all(launches_k[n] for n in STAGE0_KERNELS) or any(launches_p.values()):
        raise AssertionError(f"stage 0 end to end: kernel path {launches_k}, plain {launches_p}")
    if not rel <= LOSS_REL:
        raise AssertionError(f"stage 0 end to end: loss {loss_k} vs plain {loss_p}")
    if not cos[worst] >= COS_MIN:
        raise AssertionError(f"stage 0 end to end: gradient cosine {cos[worst]:.5f} of {worst} "
                             f"< {COS_MIN}")
    if not key_bias[0] <= KEY_BIAS_NOISE * key_bias[1]:
        raise AssertionError(f"stage 0 end to end: key-projection bias gradient norm "
                             f"{key_bias[0]:.4g} > {KEY_BIAS_NOISE} x plain {key_bias[1]:.4g}")


def main() -> int:
    import gc

    import torch

    device = phase_device()
    phase_build()
    results = phase_kernels()

    kernel_counters = counters()
    cfg, params = full_width_model()
    serve_launches = phase_serve(cfg, params, [kernel_counters[n] for n in SERVE_KERNELS])
    phase_end_to_end(cfg, params)
    train_launches = phase_train(cfg, params, kernel_counters)
    phase_train_end_to_end(cfg, params, kernel_counters)
    del cfg, params
    gc.collect()
    torch.cuda.empty_cache()

    cfg, params = stage0_model()
    stage0_launches = phase_stage0_train(cfg, params, kernel_counters)
    gc.collect()
    torch.cuda.empty_cache()
    phase_stage0_end_to_end(cfg, params, kernel_counters)

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        rows = results[name]
        main_row = rows[-1] if name == "decode_attn" else rows[0]
        by_path = {"stage0": stage0_launches[name]} if name in STAGE0_KERNELS else {}
        if name in STAGE1_KERNELS:
            by_path["train"] = train_launches[name]
        if name in serve_launches:
            by_path["serve"] = serve_launches[name]
        main_path = next(p for p in ("serve", "train", "stage0") if p in by_path)
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": by_path[main_path], "launches_by_path": by_path,
                        "max_abs_err": max(r["max_abs_err"] for r in rows),
                        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                        "library_ms": main_row["library_ms"], "library": main_row["library"],
                        "timed_case": main_row["case"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
