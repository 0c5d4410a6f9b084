"""Build, check and time the flash-attention forward (K1) and its dK/dV (K4) and dQ (K5)
backward on the card, without the rest of the smoke run.

    python -m projectiontrainer_tpu_torch.kernels.check_flash_attn [--ptxas] [--time] [--wide]

Needs an NVIDIA GPU and ``nvcc``. Prints one JSON line per step:

- ``--ptxas``: what ``nvcc -Xptxas -v`` says of ``csrc/flash_attn_fwd.cu``,
  ``csrc/flash_attn_bwd.cu``, ``csrc/flash_attn_wide.cu`` and
  ``csrc/flash_attn_cluster.cu`` (registers, spills, shared memory of each kernel,
  warnings); a spill in ``flash_attn_cluster.cu`` (every instance of its K4 and K5, those
  of two passes too) fails the run, the others' are reported (``flash_attn_wide.cu``'s
  ``wide_dkv_kernel``, K4 past 8192, spills);
- ``--wide``: only the head dims above 512 (``csrc/flash_attn_cluster.cu`` up to its reach,
  8192 for K1, K4 and K5 (K4 and K5 in two passes past 4096), and past it
  ``csrc/flash_attn_wide.cu``), checked and, with ``--time``, timed at ``WIDE_TIMED``;
  first the clusters the card holds at once (``cluster_fit``) for K4 and K5 in 9-16 CTAs
  (head dims 2304-4096), in 16 CTAs of two passes (4160-8192, at each stage count)
  and K1 in 8-16 (4096-8192). The script times whatever package ``projectiontrainer_tpu_torch``
  resolves to: run it by path with ``PYTHONPATH`` set to another checkout (one whose
  ``ops/flash_attention.py`` has ``cluster_fit``) to time that tree's kernels on these
  shapes (its ``package`` line says which; the fits asked of it are those within its
  reach), in turns with this one's;
- always: K1's out and lse, K4's dk and dv and K5's dq against the plain versions at the main
  paths' shapes (Llama-3.2-1B's prefill at 32/8 heads of 64, causal, whole tiles
  left-padded, at P = 831 and the generation evaluation's 703; the ViT-L text tower; Mistral-7B's window of 4096 over 4608 tokens among
  them) and at ragged ones (T = 1, 63, 64, one off a tile, windows smaller than a
  tile, padding that masks whole tiles, GQA, q/k/v sliced out of one fused tensor), with
  the tolerances of ``chip_smoke.py`` (out and lse: atol = rtol = 2e-2; dk, dv, dq: 2e-2
  x max |reference|); fully masked rows must be exactly 0 (out and dq), K1's fp32 copy of
  O must round to its bf16 O, and a rerun of each kernel must give the same bits (each
  line's ``bits`` digests out, dk, dv and dq, to hold two trees' kernels bit-equal on the
  same seeded inputs). Every case is run before a failure is reported;
- ``--time``: device times (``utils/timing.py:device_ms``: launches queued behind a
  spinning kernel, so the host's launch time is not in them) of kernel, plain version and
  the library call (``scaled_dot_product_attention`` and its autograd backward, a
  yardstick the port never calls; under GQA also the forward on k and v repeated to the
  query heads, which SDPA's efficient backend takes), in turns, at the shapes of
  PERF.md's table; above 512 K1's column blocks (``csrc/flash_attn_wide.cu``, the route
  past the reach) on the same inputs beside the cluster kernel; and for the forward the
  CUDA-event time of one launch at a time, which holds the host's share.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from projectiontrainer_tpu_torch.kernels import _build
from projectiontrainer_tpu_torch.ops import flash_attention as FA
from projectiontrainer_tpu_torch.utils.timing import device_ms

TOL = 2e-2
TIMED = 14  # the first cases: the main paths' shapes
# b, t, hq, hkv, d, causal, window, padding (None, "left", "right"), q/k/v sliced of one tensor
CASES = [
    (8, 576, 16, 16, 64, False, None, None, False),     # ViT-L tower
    (16, 1024, 16, 16, 72, False, None, None, False),   # so400m vision tower
    (16, 64, 16, 16, 72, False, None, None, False),     # so400m text tower
    (2, 1024, 8, 8, 128, False, None, None, True),      # merged rows, MHA
    (2, 1024, 8, 2, 128, False, None, None, True),      # merged rows, GQA 8/2
    (8, 831, 4, 1, 256, True, 512, "left", False),      # Gemma3 prefill
    (8, 831, 4, 1, 256, True, None, "left", False),
    (4, 1087, 4, 1, 256, True, 512, "right", False),    # stage-1 decoder
    (4, 1087, 4, 1, 256, True, None, "right", False),   # its global layers
    (1, 575, 32, 8, 64, True, None, None, False),       # Llama-3.2-1B caption prefill
    (8, 831, 32, 8, 64, True, None, "left", False),     # its served prefill: whole tiles padded
    (8, 703, 32, 8, 64, True, None, "left", False),     # the generation evaluation's prefix
    (14, 64, 16, 16, 64, False, None, None, False),     # ViT-L text tower, 14 class prompts
    (1, 4608, 32, 8, 128, True, 4096, None, False),     # Mistral-7B: the window binds
    (2, 1, 2, 2, 64, False, None, None, False),
    (2, 63, 4, 4, 72, True, None, None, False),
    (2, 129, 4, 2, 128, True, 37, "left", False),       # a window smaller than a tile
    (2, 127, 4, 4, 64, True, None, "right", True),
    (2, 150, 4, 1, 256, True, 37, "left", False),
    (2, 300, 4, 2, 72, True, 37, "left", True),         # left padding masks whole tiles
    (2, 257, 8, 2, 128, False, None, "right", False),
    (4, 1024, 8, 2, 512, True, 512, None, False),       # head dim 512: columns split
    (2, 150, 4, 1, 512, True, 37, "left", False),
    (2, 257, 4, 4, 512, False, None, "right", True),
    (1, 63, 2, 2, 512, False, None, None, False),
    # above 512: K1, K4 and K5 on the cluster kernel up to 8192 (K4 and K5 in 9-16 CTAs past
    # 2048 and in two passes on 16 CTAs from 4160, K1 in 9-16 CTAs past 4096), what lies
    # past 8192 on the column blocks (ops/flash_attention.py: forward_plan, dkv_plan,
    # dq_plan)
    (2, 1024, 4, 1, 1024, True, 512, None, False),      # chip_smoke.py phase 2's shapes
    (4, 576, 4, 4, 640, False, None, None, False),
    (2, 150, 4, 1, 576, True, 37, "left", False),       # uneven slices: 192 | 128 | ...
    (2, 129, 4, 2, 576, True, 64, "right", True),
    (2, 257, 4, 2, 640, False, None, "right", True),
    (2, 300, 8, 2, 640, True, 100, "left", False),
    (1, 63, 2, 2, 1024, False, None, None, False),
    (2, 300, 8, 2, 1024, True, 128, "left", True),
    (2, 129, 4, 4, 768, True, None, None, False),
    (2, 300, 4, 2, 2048, True, 100, "left", True),      # K4's and K5's widest portable cluster
    (2, 200, 4, 1, 2048, False, None, "right", False),
    (2, 150, 4, 2, 2112, True, 37, "left", False),      # K4 and K5 in 9 CTAs, uneven slices
    (1, 512, 4, 1, 2112, True, None, None, False),      # chip_smoke.py phase 2's shapes
    (2, 200, 4, 2, 3072, True, 100, "right", True),     # 12 CTAs
    (1, 512, 4, 1, 4096, True, None, None, False),      # 16 CTAs (K1: 8, portable)
    (2, 150, 4, 2, 4096, True, 37, "left", False),
    (1, 512, 4, 1, 4160, True, None, None, False),      # K4, K5: two passes (K1: 9 CTAs, uneven)
    (2, 70, 2, 1, 4160, True, None, "right", True),
    (2, 150, 4, 2, 4160, True, 37, "left", False),
    (2, 100, 4, 2, 4608, True, 37, "left", False),      # K1: 9 CTAs of 512 columns
    (2, 130, 4, 1, 5120, True, 64, "right", False),     # 16 rows a stage; runs of 3 | 2 blocks
    (2, 200, 4, 2, 6144, True, 100, "right", True),     # passes of 128 | 64
    (2, 150, 4, 2, 6144, True, None, "left", False),
    (2, 100, 4, 2, 5184, True, None, "right", False),   # passes of 128 | 64, 64 | 64
    (2, 129, 4, 4, 7232, False, None, "right", False),  # passes of 128 | 128, 128 | 64
    (1, 512, 4, 1, 8192, True, None, None, False),      # the reach (K1: 16 CTAs)
    (2, 150, 4, 2, 8192, True, 37, "left", False),
    (2, 129, 4, 4, 8192, False, None, "right", True),
    (2, 70, 2, 1, 8256, True, None, "right", False),    # past every reach: the column blocks
]
WIDE = [case for case in CASES if case[4] > 512]
# the wide shapes timed by ``--wide --time``: PERF.md's rows (chip_smoke.py phase 2's)
WIDE_TIMED = [
    (4, 576, 4, 4, 640, False, None, None, False),
    (2, 1024, 4, 1, 1024, True, 512, None, False),
    (1, 1024, 4, 1, 2048, True, 512, None, False),
    (1, 512, 4, 1, 2112, True, None, None, False),
    (1, 512, 4, 1, 4096, True, None, None, False),
    (1, 512, 4, 1, 4160, True, None, None, False),
    (1, 512, 4, 1, 6144, True, None, None, False),
    (1, 512, 4, 1, 8192, True, None, None, False),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_report(sources=None, fail_on=None) -> bool:
    """What ``nvcc -Xptxas -v`` says of each source's kernels, a line each, and the bytes of
    spill stores and loads by source; whether none of ``fail_on`` (by default every
    source) spills."""
    sources = sources or ("flash_attn_fwd.cu", "flash_attn_bwd.cu", "flash_attn_wide.cu",
                          "flash_attn_cluster.cu")
    spills = dict.fromkeys(sources, 0)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for source in sources:
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                               str(_build.BUILD_DIR / "ptxas_report.o"),
                               str(_build.CSRC / source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
        name = None
        for line in proc.stderr.splitlines():
            found = re.search(r"Compiling entry function '(\w+)'", line)
            if found:
                name = found.group(1)
            elif "registers" in line or "spill" in line or "warning" in line.lower():
                emit({"ptxas": name, "line": line.strip()})
                spills[source] += sum(map(int, re.findall(r"(\d+) bytes spill", line)))
    ok = all(spills[source] == 0 for source in (fail_on or sources))
    emit({"ptxas_spill_bytes": spills, "ok": ok})
    return ok


def one_at_a_time_ms(fn, iters: int = 20) -> float:
    """Median CUDA-event time around single calls: the card waits for the host to launch
    each, so for a kernel of tens of microseconds this reads the wrapper's host time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def inputs(b, t, hq, hkv, d, pad, sliced, seed=11):
    """q, k, v, dO (bf16) and the padding mask; `sliced`: q, k and v are views into one
    [B, T, (Hq + 2 Hkv) * D] tensor, as a fused projection would leave them."""
    rng = np.random.default_rng(seed)

    def bf16(shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device="cuda").to(torch.bfloat16)

    if sliced:
        fused = bf16((b, t, (hq + 2 * hkv) * d))
        q, k, v = (x.view(b, t, -1, d) for x in fused.split([hq * d, hkv * d, hkv * d], dim=-1))
    else:
        q, k, v = bf16((b, t, hq, d)), bf16((b, t, hkv, d)), bf16((b, t, hkv, d))
    mask = None
    if pad:
        mask = torch.ones((b, t), dtype=torch.int32, device="cuda")
        n = max(1, min(t - 1, int(0.47 * t)))
        if pad == "left":
            mask[1, :n] = 0
        else:
            mask[1, t - n:] = 0
    return q, k, v, bf16((b, t, hq, d)), mask


def digest(*tensors) -> str:
    """A digest of the tensors' bits (bf16 as int16), in order."""
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref| (at T = 1 dk and dq are zero in exact arithmetic: the
    scale is then held at 1e-3)."""
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-3))


def check(b, t, hq, hkv, d, causal, window, pad, sliced) -> bool:
    q, k, v, do, mask = inputs(b, t, hq, hkv, d, pad, sliced)
    kw = dict(scale=d ** -0.5, causal=causal, window=window)
    out, lse, out32 = FA._launch(q, k, v, kv_mask=mask, out_f32=True, **kw)
    torch.cuda.synchronize()
    ref, ref_lse = FA.flash_attention_reference(q.float(), k.float(), v.float(), kv_mask=mask, **kw)
    live = torch.ones_like(lse, dtype=torch.bool)
    dead_rows_zero = True
    if pad == "left":  # rows with no valid key: exactly 0, lse undefined
        live = mask.bool()[:, None, :].expand_as(lse)
        dead_rows_zero = bool(out[~mask.bool()].eq(0).all())
    err = (out.float() - ref).abs()
    lse_err = (lse - ref_lse)[live].abs()
    lse_tol = TOL + TOL * ref_lse[live].abs()
    again = FA._launch(q, k, v, kv_mask=mask, out_f32=True, **kw)
    row = {"case": [b, t, hq, hkv, d, causal, window, pad, sliced],
           "routes": [plan(d).get("route", "wgmma")
                      for plan in (FA.forward_plan, FA.dkv_plan, FA.dq_plan)],
           "out_err": float(err.max()), "lse_err": float(lse_err.max()),
           "out_ok": bool((err <= TOL + TOL * ref.abs()).all() and out.isfinite().all()),
           "lse_ok": bool((lse_err <= lse_tol).all()),
           "dead_rows_zero": dead_rows_zero,
           "f32_rounds_to_bf16": bool(torch.equal(out32.to(torch.bfloat16), out)),
           "fwd_bit_equal": bool(torch.equal(out, again[0]) and torch.equal(lse[live], again[1][live])
                                 and torch.equal(out32, again[2]))}
    prep = FA.prepare_bwd(q, k, v, mask, out32, lse, do)
    args = (q, k, v, prep[0], prep[1], lse, prep[2])
    dk, dv = FA.launch_bwd_dkv(*args, **kw)
    torch.cuda.synchronize()
    _, rk, rv = FA.flash_attention_bwd_reference(q.float(), k.float(), v.float(), mask, out32, lse,
                                                 do.float(), **kw)
    dk2, dv2 = FA.launch_bwd_dkv(*args, **kw)
    dq = FA.launch_bwd_dq(*args, **kw)
    torch.cuda.synchronize()
    rq = FA.flash_attention_bwd_reference(q.float(), k.float(), v.float(), mask, out32, lse,
                                          do.float(), **kw)[0]
    dq2 = FA.launch_bwd_dq(*args, **kw)
    row.update({"dk_rel": rel_err(dk, rk), "dv_rel": rel_err(dv, rv),
                "dkv_finite": bool(dk.isfinite().all() and dv.isfinite().all()),
                "dkv_bit_equal": bool(torch.equal(dk, dk2) and torch.equal(dv, dv2)),
                "dq_rel": rel_err(dq, rq), "dq_finite": bool(dq.isfinite().all()),
                "dq_bit_equal": bool(torch.equal(dq, dq2)),
                "dq_dead_rows_zero": pad != "left" or bool(dq[~mask.bool()].eq(0).all()),
                "bits": digest(out, dk, dv, dq)})
    row["ok"] = bool(row["out_ok"] and row["lse_ok"] and dead_rows_zero
                     and row["f32_rounds_to_bf16"] and row["fwd_bit_equal"] and row["dkv_finite"]
                     and row["dk_rel"] <= TOL and row["dv_rel"] <= TOL and row["dkv_bit_equal"]
                     and row["dq_finite"] and row["dq_rel"] <= TOL and row["dq_bit_equal"]
                     and row["dq_dead_rows_zero"])
    emit(row)
    return row["ok"]


def sdpa(q, k, v, mask, scale, causal):
    """F.scaled_dot_product_attention on [B, T, H, D] tensors -> (fn, backend that ran)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def fn(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, scale=scale,
                    enable_gqa=q.shape[2] != k.shape[2])
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return fn, backend.name
    raise RuntimeError("no scaled_dot_product_attention backend took these inputs")


def column_blocks_fwd(q, k, v, mask, *, scale, causal, window):
    """K1 on the column blocks (``csrc/flash_attn_wide.cu``, the route past the cluster
    kernel's reach) at any width above 512, whatever the plan's route there: the yardstick
    of the cluster kernel on the same inputs -> (out, lse)."""
    b, t, hq, d = q.shape
    bufs = _build.allocate(FA.fwd_buffers(q), q.device)
    name = "flash_attn_wide_fwd_bf16"
    err = getattr(_build.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), FA._ptr(FA._mask_arg(mask, q)),
        bufs["out"].data_ptr(), bufs["lse"].data_ptr(), None, b, t, hq, k.shape[2], d,
        FA._strides(q, k, v, bufs["out"]), scale, int(causal), int(window or 0),
        torch.cuda.current_stream().cuda_stream)
    _build.check(name, err)
    return bufs["out"], bufs["lse"]


def time_case(b, t, hq, hkv, d, causal, window, pad, sliced) -> None:
    from projectiontrainer_tpu_torch.ops.attention import attention_probs, repeat_kv

    q, k, v, do, mask = inputs(b, t, hq, hkv, d, pad, sliced)
    kw = dict(scale=d ** -0.5, causal=causal, window=window)
    out, lse, _ = FA._launch(q, k, v, kv_mask=mask, **kw)
    prep = FA.prepare_bwd(q, k, v, mask, out, lse, do)
    args = (q, k, v, prep[0], prep[1], lse, prep[2])
    seen = None
    if mask is not None or window is not None:  # the library call takes one explicit mask
        seen = attention_probs(q[:, :, :1], k[:, :, :1], kv_mask=mask, **kw)[1]
    lib, backend = sdpa(q, k, v, seen, kw["scale"], causal)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    lib_out = sdpa(*leaves, seen, kw["scale"], causal)[0]()
    dout = do.transpose(1, 2)
    timed = [("fwd_plain", lambda: FA.flash_attention_reference(q, k, v, kv_mask=mask, **kw)),
             ("fwd_kernel", lambda: FA._launch(q, k, v, kv_mask=mask, **kw)),
             ("fwd_library", lib)]
    row = {"case": [b, t, hq, hkv, d, causal, window, pad, sliced], "library": backend,
           "routes": [plan(d).get("route", "wgmma")
                      for plan in (FA.forward_plan, FA.dkv_plan, FA.dq_plan)]}
    if hq != hkv:  # SDPA's efficient backend takes k and v repeated, not the GQA caches
        kv = (repeat_kv(k, hq // hkv), repeat_kv(v, hq // hkv))
        lib_rep, row["library_kv_repeated"] = sdpa(q, *kv, seen, kw["scale"], causal)
        timed.append(("fwd_library_kv_repeated", lib_rep))
    if row["routes"][0] == "cluster":  # the column blocks beside the cluster kernel
        blocks = column_blocks_fwd(q, k, v, mask, **kw)
        torch.cuda.synchronize()
        row["column_blocks_err"] = float((blocks[0].float() - out.float()).abs().max())
        timed.append(("fwd_column_blocks", lambda: column_blocks_fwd(q, k, v, mask, **kw)))
    timed += [("dkv_kernel", lambda: FA.launch_bwd_dkv(*args, **kw)),
              ("dq_kernel", lambda: FA.launch_bwd_dq(*args, **kw)),
              ("bwd_library_dq_dk_dv",
               lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True))]
    rows = {}
    for _ in range(2):  # in turns
        for name, fn in timed:
            rows.setdefault(name, []).append(device_ms(fn))
    rows["fwd_kernel_one_at_a_time"] = one_at_a_time_ms(
        lambda: FA._launch(q, k, v, kv_mask=mask, **kw))
    rows["fwd_library_one_at_a_time"] = one_at_a_time_ms(lib)
    emit({**row, "ms": rows})


def cluster_fits() -> dict:
    """The clusters of K4 and K5 in 9-16 CTAs (head dims 256 C), in 16 CTAs of two passes
    (4160, 6208, 7232: the first widths at four, three and two ring stages; 6144, 8192) and of
    K1 in 8 (4096), 9 (4160, 4608), 10 (5120), 12 (6144) and 16 (8192) that the card holds
    at once at their plans' shared memory (``cluster_fit``; the widths within the
    package's reach), the shared memory beside them, and whether each holds at least one
    (``ok``)."""
    widths = {"dkv": [256 * c for c in range(9, 17)] + [4160, 6144, 6208, 7232, 8192],
              "fwd": [4096, 4160, 4608, 5120, 6144, 8192]}
    widths["dq"] = widths["dkv"]
    fits = {kind: {d: FA.cluster_fit(d, kind) for d in by_kind if d <= FA.REACH[kind]}
            for kind, by_kind in widths.items()}
    smem = {kind: {d: FA.cluster_plan(d, kind)["smem"] for d in by_d}
            for kind, by_d in fits.items()}
    return {"cluster_fit": fits, "cluster_smem": smem,
            "ok": all(n >= 1 for by_d in fits.values() for n in by_d.values())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--cases", type=int, default=len(CASES), help="check the first K cases")
    ap.add_argument("--wide", action="store_true", help="only the head dims above 512")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit({"card": smi, "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "package": FA.__file__})
    ok = []
    if args.ptxas:
        ok.append(ptxas_report(("flash_attn_cluster.cu", "flash_attn_wide.cu") if args.wide
                               else None, fail_on=("flash_attn_cluster.cu",)))
    _build.library()
    emit({"build_s": _build.build_seconds})
    if args.wide:
        fits = cluster_fits()
        emit(fits)
        ok.append(fits["ok"])
    cases = WIDE if args.wide else CASES[:args.cases]
    ok += [check(*case) for case in cases]
    if args.time:
        for case in WIDE_TIMED if args.wide else CASES[:TIMED]:
            time_case(*case)
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
