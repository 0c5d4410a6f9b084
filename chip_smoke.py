#!/usr/bin/env python3
"""Smoke run of the PyTorch port (projectiontrainer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a card

Phases, each printing one JSON line; any failure raises, so the exit code is not 0:

0. device: the card's name, its ``nvidia-smi`` name and power limit; TF32 off.
1. build: the CUDA kernels (csrc/*.cu) compiled from the checkout's sources.
2. kernels: each kernel against its plain PyTorch version on the same bf16 inputs
   (the plain version evaluated in fp32), at the serving path's shapes, within
   atol = rtol = 2e-2; median CUDA-event times over 20 runs of kernel and plain.
3. serve: VQAService at full width (SigLIP ViT-L/16-384, 24 layers; projector
   1024 -> 10240 -> 1152; Gemma3-1B, 26 layers, vocab 262,144) from seeded random
   weights, 16 client threads x 2 requests, batch 8, 3 beams; every kernel's launch
   count must rise during the run.
4. end to end: prefill logits and 4 teacher-forced decode steps of the kernel path
   against the plain path (the same modules with the plain ops, on the card).

The second-to-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs no network and no model snapshot; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

ATOL = RTOL = 2e-2
SEED = 0
MAX_NEW_TOKENS = 32  # the reference serving config decodes up to 1024; cut for run time


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20) -> float:
    """Median CUDA-event time of fn() over `iters` runs, after one warm-up run."""
    import torch

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


def compare(name, got, ref) -> float:
    """Max |got - ref|; raises unless |got - ref| <= ATOL + RTOL * |ref| everywhere."""
    got, ref = got.float(), ref.float()
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    bad = err > ATOL + RTOL * ref.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside atol=rtol={ATOL}, "
                             f"max abs err {float(err.max()):.4g}")
    return float(err.max())


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


def phase_kernels():
    import torch

    from projectiontrainer_tpu_torch.ops import decode_attention as DA
    from projectiontrainer_tpu_torch.ops import flash_attention as FA
    from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN

    rng = np.random.default_rng(SEED)
    results = {"layernorm_fwd": [], "flash_attn_fwd": [], "decode_attn": []}

    def record(kernel, case, err, ms, plain_ms):
        row = {"kernel": kernel, "case": case, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms}
        results[kernel].append(row)
        emit({"phase": 2, **row})

    # K2: LayerNorm over the tower's rows
    x = _bf16(rng, (8 * 576, 1024))
    p = {"scale": _bf16(rng, (1024,), 0.5) + 1, "bias": _bf16(rng, (1024,), 0.1)}
    got = FLN.layernorm(p, x)
    ref = FLN.layernorm_reference({k: v.float() for k, v in p.items()}, x.float())
    record("layernorm_fwd", "[4608,1024]", compare("layernorm", got, ref),
           cuda_ms(lambda: FLN.layernorm(p, x)),
           cuda_ms(lambda: FLN.layernorm_reference(p, x)))

    # K1: tower shape, non-causal, unmasked
    q, k, v = (_bf16(rng, (8, 576, 16, 64)) for _ in range(3))
    out, lse = FA.flash_attention(q, k, v)
    ref, ref_lse = FA.flash_attention_reference(q.float(), k.float(), v.float())
    err = compare("flash tower out", out, ref)
    compare("flash tower lse", lse, ref_lse)
    record("flash_attn_fwd", "tower [8,576,16,64]", err,
           cuda_ms(lambda: FA.flash_attention(q, k, v)),
           cuda_ms(lambda: FA.flash_attention_reference(q, k, v)))

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
        record("flash_attn_fwd", f"prefill [8,831,4|1,256] causal window={window}", err,
               cuda_ms(lambda: FA.flash_attention(q, k, v, **kw)),
               cuda_ms(lambda: FA.flash_attention_reference(q, k, v, **kw)))

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
            record("decode_attn", f"B=8 nb=3 P=831 G=32 t={t} window={window}",
                   compare(f"decode t={t} window={window}", got, ref),
                   cuda_ms(lambda: DA.decode_attention(qd, kp, vp, kg, vg, **kw)),
                   cuda_ms(lambda: DA.decode_attention_reference(qd, kp, vp, kg, vg, **kw)))
    return results


# ---------------------------------------------------------------------------- phase 3


class StubTokenizer:
    """ids -> text with no vocabulary files: the smoke needs no tokenizer snapshot."""

    pad_token_id = 0
    eos_token_id = 1

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{int(i)}" for i in ids if not (skip_special_tokens and i in (0, 1)))


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


def main() -> int:
    device = phase_device()
    phase_build()
    results = phase_kernels()

    from projectiontrainer_tpu_torch.ops import decode_attention as DA
    from projectiontrainer_tpu_torch.ops import flash_attention as FA
    from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN

    cfg, params = full_width_model()
    launches = phase_serve(cfg, params, [FA.launches, FLN.launches, DA.launches])
    phase_end_to_end(cfg, params)

    pkg = "projectiontrainer_tpu_torch"
    meta = {
        "flash_attn_fwd": ("cuda", f"{pkg}/csrc/flash_attn_fwd.cu",
                           "projectiontrainer_tpu/ops/flash_attention.py:84"),
        "layernorm_fwd": ("triton", f"{pkg}/ops/fused_layernorm.py",
                          "projectiontrainer_tpu/ops/fused_layernorm.py:59"),
        "decode_attn": ("cuda", f"{pkg}/csrc/decode_attention.cu",
                        "projectiontrainer_tpu/ops/decode_attention.py:116"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        rows = results[name]
        main_row = rows[-1] if name == "decode_attn" else rows[0]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": max(r["max_abs_err"] for r in rows),
                        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                        "timed_case": main_row["case"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
