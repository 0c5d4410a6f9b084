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
   cosine to fp32 within 0.001 of plain bf16 attention's), K1, K4 and K5 at a T no
   tile divides ([16,1000,16,72]) with K1's fp32 copy of O held against its bf16 O and
   reruns of K1, K4 and K5 held bit-equal (there and at the decoder's masked GQA
   shape), K2 and K8 over its rows ([16384,1152]; K8 also at 1000 rows, at 16383,
   1001 and 529, whose bands end part-way through a ring stage (checked, as is 16384's),
   at the MAP head's 16 rows and at the ViT-L tower's [4608,1024], each rerun held
   bit-equal); and
   the TPU's merged-lane layout (kernel rows 4-6): K1/K4/K5 on head-merged
   [2,1024,8*128] tensors through ``flash_attention_merged``, MHA and GQA 8/2. K3 at
   the served shape (batch 8, 3 beams, P = 831, G = 32), at one request (batch 1) and at
   the reference's 1024 generated slots (t = 1000), window 512 and none, each rerun
   held bit-equal and its plan held to more CTAs than (batch, KV head) pairs.
   Stage 2's shapes (batch 1): K4/K5 over the trained ViT-L tower ([1,576,16,64]),
   K1/K4/K5 over the decoder's longest bucket ([1,1215,4|1,256], causal, window 512,
   the question's and the answer's padding masked) and K8 over the tower's rows
   ([576,1024]).
   Qwen3-8B's shapes (the QLoRA path of phases 11-13): K1/K4/K5 at [4,1855,32|8,128]
   (575 visual + 256 question + 1024 answer tokens, causal, each row's question and
   answer right-padded), K3 at head dim 128 with GQA 32/8 (batch 8 and 1, 3 beams,
   P = 831, G = 32, no window), K6/K7 at [4096,4096] x [151936,4096].
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
   kernel path against the plain path (the same modules with the plain ops); then one
   batch of the kernel path split into its pieces (``serve_split``): the card's kernel
   time of the prefix, the prefill and a decode step (and K3's share of it) from
   profiler traces, and a decode step on the host clock.
5. train: first the profile splits of ``utils/timing.py`` checked on the card
   (``check_profiler_spans``: two spans of matmuls, each split's reading equal to the
   kernels' own time); then Stage1Trainer.train() on the same full-width model
   (projector fp32 masters, bf16 compute), 32 in-memory samples (seeded pixels, 512-token captions
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
9. stage-2 train: the stage-0 model is freed; Stage2Trainer.train() full-joint
   (--unfreeze_llm --unfreeze_projection_layer --train_ve_first_epoch) on the
   full-width VLM of phase 3 from seeded random weights, fp32 masters and bf16
   compute, per-layer remat, batch 1, accumulation 8, lr 1e-5, per-module clip 1.0,
   2 epochs of 16 in-memory samples (questions of 8-128 tokens, answers of 32-512:
   buckets up to 575 + 128 + 512 = 1215 tokens), validation on 2 samples with 3-beam
   sampling and 16 new tokens. One train-state file is kept on disk at a time (~21 GB
   each; each save's bytes and seconds printed). Every loss finite; the tower moved in
   epoch 0 and not in epoch 1; the LLM, its tied table and the projector moved in
   both; checkpoint-epoch_1/ and the examples written; K1, K2, K3, K4, K5 and K8
   launched. Micro-steps 6-7 are profiled (the card's kernel time by span, forward and
   backward apart); images/s and ms a micro-step from steps 1-5.
10. end to end (stage 2), batch 1 at the longest bucket: the loss and the gradient of
   every trainable leaf (tower, projector, LLM with its tied table) through the kernel
   path against the plain path: loss within 1e-3 relative, cosine >= 0.999 per leaf,
   the key-projection biases by their noise (at most 3x plain's), and the decoder's q/k
   RMSNorm scales, whose bf16 gradient is mostly rounding at random weights, by their
   distance to the plain path's fp32 gradient: at most 1.5x plain bf16's.
11. stage-2 QLoRA train: phase 10's model is freed; the full-width ViT-L/16-384 +
   projector 1024 -> 10240 -> 4096 + Qwen3-8B (36 layers, hidden 4096, 32/8 heads of
   128, vocab 151,936, untied head) from seeded random weights, the decoder built and
   quantized (nf4 -> nf4-mirror) one layer at a time; Stage2Trainer.train() with the
   reference's recipe (--enable_qlora --quant_method nf4-mirror --lora_r 16
   --lora_alpha 32 --lora_dropout 0.05, lr 1e-5, warmup 0.05), per-layer remat, bf16
   compute, batch 4, accumulation 2, 32 in-memory samples in 8 bucket groups (questions
   of 8-256 ids, answers of 32-1024: up to 575 + 256 + 1024 = 1855 tokens) = 8
   micro-steps, validation on 2 samples (3 beams, 16 new tokens, the adapters merged).
   Every loss finite; every LoRA B off zero; every frozen leaf (quantized codes and
   scales, table, head, norms, tower, projector) bit-equal to before (a position-
   weighted byte sum); K1-K7 launched; checkpoint-epoch_0/language_model/ holds the
   PEFT adapter. Micro-steps 6-7 profiled (the span split, with ``decoder/dequant``);
   images/s and ms a micro-step from steps 1-5; peak memory; the adapter's bytes.
12. end to end (QLoRA), batch 1 at 1855 tokens, dropout off, an adapter whose B is
   drawn at std 0.02 over phase 11's quantized base: the loss (within 1e-3 relative)
   and every LoRA leaf's gradient (cosine >= 0.999) through the kernel path against
   the plain path in bf16; a leaf below 0.999 (the two bf16 paths are each ~0.9995
   from the plain path in fp32 at random weights, some A gradients 0.998) is held by
   its distance to the fp32 gradient instead: at most 1.5x plain bf16's. Then the
   decoder merged (``lora.merge_into_decoder``, the base dequantized to bf16) against
   the unmerged forward: each row's prefill-logit cosine >= 0.99.
13. serve with the adapter: the training model is freed; VQAService with
   --adapter_path (phase 11's adapter) over the dense bf16 Qwen3-8B VLM of the same
   seed, 8 client threads x 2 requests, batch 8, 3 beams, 32 new tokens; every request
   answered, K1-K3's launch counts rise; p50, p95 and req/s on the host clock.

14. cls train: the Qwen3 model is freed; ClsTrainer.train() (the cls_evaluate probe) over
   the full-width XraySigLIP__vit-l-16-siglip-384__webli tower (ViT-L/16-384, its MAP
   head kept) + the 4-class attention-probe head of the default grid's EXP1 (No
   Finding, Atelectasis, Cardiomegaly, Effusion) from seeded random weights, fp32
   masters and bf16 compute, batch 32, --freeze_mode 1EpochUnfreeze (lr 1e-4, bb_lr
   1e-5, dropout 0.1), 2 epochs of 6 steps on in-memory 384 px samples, validation on
   32. Every loss finite; every tower leaf with a nonzero exact gradient moved in epoch
   0 and every tower leaf bit-equal through epoch 1; the head moved in both epochs;
   results.tsv has 2 rows; the best checkpoint (every leaf, tower included), rebuilt
   and evaluated alone as cli/cls_test does, gives the trainer's own validation
   accuracy and AUROC (and its loss within 1e-6 relative); K1, K2, K4, K5 and K8
   launched. Steps 3-4 of epoch 0 profiled (the vision forward and backward, head,
   loss and optimizer spans); images/s and ms/step of each epoch (epoch 0 steps 1, 2,
   5; epoch 1 steps 1-5); the checkpoints' bytes.
15. end to end (cls), batch 8: the loss and the gradient of every trainable leaf
   (tower and head; the unused MAP head gets none) through the kernel path against the
   plain path in bf16: loss within 1e-3 relative, cosine >= 0.999 per leaf, a leaf
   below held by PR 8's rule (its distance to the plain fp32 gradient at most 1.5x
   plain bf16's); the key-projection biases and the class-shared biases (the tower's
   last LayerNorm bias, the probe's value and output biases, the scoring bias), zero
   in exact arithmetic, by their noise (at most 3x plain's).
   Phase 2 adds the cls shapes: K1, K4 and K5 at [32,576,16,64] and K2 and K8 at
   [18432,1024], each rerun held bit-equal.
16. the input feed from files, run after phase 8 on phase 7's so400m model: one line
   of the environment (Pillow, cv2, scipy found; g++'s version; the CPUs this process
   may use; /dev/shm's free bytes); 256 seeded 1024 x 1024 and 32 2048 x 2048 CXR-like
   gray JPEGs (stored as RGB, 4 caption classes) written to a temp dir; (a) the feed
   alone: images/s of ``epoch_batches`` (batch 16, onto the card) over 128 of them at
   512 px on 8 threads and on the process feeder at N = 1, 4 and every CPU, augmentation
   off and on (on: the workers at OMP_NUM_THREADS 1 and at OpenMP's default), then at
   384 px (threads and the best N) and from the 2048 px files, each beside the demand
   (stage 0: 63-104 images/s; the cls frozen epoch: 606-735); (b) Stage0Trainer.train()
   as phase 7 runs it but fed from 128 of the files with --use_online_augmentation and
   --num_loader_procs at the best N (8 steps at batch 16, zero-shot validation on 16
   files; steps 6-7 profiled): images/s, ms/step and the card's idle share beside phase
   7's in-memory step; every loss finite, the tower moved, no invalid sample, K1, K2, K4,
   K5 and K8 launched, no worker in ``nvidia-smi --query-compute-apps`` (at most the one
   training process there) nor with libcuda mapped; the pools closed and their shared
   memory unlinked.

17. caption: the cls model is freed; the full-width ViT-L/16-384 + projector 1024 ->
   10240 -> 2048 + Llama-3.2-1B (16 layers, hidden 2048, 32/8 heads of 64, vocab 128,256,
   tied table, rope theta 500,000 with llama3 scaling; ``decoder.from_hf_config`` of its
   published config.json) from seeded random weights; ``infer_stage1.caption_image`` on
   an in-memory CXR-like image (1024 px, to 384 px by ``I.preprocess``), greedy and 3
   beams, 128 new tokens (the CLI's default); each caption repeated and held equal;
   K1, K2 and K3 launched; the prefill logits and 4 teacher-forced 3-beam decode steps
   of the kernel path against the plain path (every row's cosine >= 0.99); the kernel
   time of the prefix, the prefill and a 3-beam decode step (the mean of MAX_NEW_TOKENS
   steps) from profiler traces (``serve_split``) beside the captions' host time.
18. generation evaluation: ``infer_generation.generate_results`` + ``display_summary``
   over 16 seeded 1024 px CXR-like JPEG files with a manifest of 4 labels, on phase 17's
   model: batch 8, 3 beams, max_q_len 256 and the question buckets of the CLI,
   MAX_NEW_TOKENS; 16 results, the per-label counts adding up to 16; samples/s on the
   host clock, the median of 3 passes after the counted one (each giving the same
   answers); then the first batch's prefix (its 8 files and the diagnostic prompt,
   through ``build_prefix``: [8,703], the prompt left-padded to its bucket, as phase 2's
   ``generation_eval_mask``) through the prefill and 4 teacher-forced 3-beam decode
   steps of the kernel path against the plain path (every row's cosine >= 0.99): K1 at
   the left-padded GQA 32/8 head-dim-64 prefill and K3 at head dim 64 held at the
   evaluation's own shapes.
19. zero-shot and t-SNE: phase 17's model is freed; the full-width
   XraySigLIP__vit-l-16-siglip-384__webli dual tower (vision 24 x 1024 with its MAP
   head; text 24 x 1024, vocab 32,000, 64 positions; bf16) from seeded random weights;
   ``ZeroShotClassifier`` over the 14 CheXpert labels (the prompts encoded once: K1 at
   [14,64,16,64]) and ``predict`` at batch 32 (probabilities within atol = rtol = 2e-2
   of the plain path's, the text embeddings at cosine >= 0.99); ``tsne.
   compute_image_embeddings`` at batch 32, pooled and through a projector 1024 -> 10240
   -> 2048 (every row's cosine to the plain path >= 0.99); K1 and K2 launched; images/s
   on the host clock and a zero-shot batch's kernel time from a profiler trace. The
   card's machine has no sklearn: ``tsne_2d`` and ``plot_tsne`` are held by the CPU tests.
   Phase 2 adds this slice's shapes: K1 at the Llama-3.2-1B prefill ([1,575,32|8,64]
   causal; [8,831,32|8,64] causal with each row's question left-padded; phase 18's
   [8,703,32|8,64] with its own prefix mask), at the ViT-L
   text tower ([14,64,16,64]) and at Mistral-7B-v0.1's window ([1,4608,32|8,128],
   causal, window 4096); K3 at head dim 64 with GQA 32/8 (8 x 3 beams at P = 831, G =
   32, and at phase 18's P = 703 with its prefix mask; one caption of 3 beams at P =
   575, G = 128); each rerun held bit-equal.

The second-to-last line is {"kernels": [...]} (name, route, source, replaces, launches
on the main path, launches_by_path (serve, train, stage0, stage0_files, stage2,
stage2_qlora, serve_qwen3_adapter, cls, caption_llama, generation_eval, zero_shot,
tsne), max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms, and the
launches of one epoch-0 stage-2 micro-step at the longest bucket, phase 9's); the last is
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
# stage-2 end to end: the decoder's q/k RMSNorm scales, whose bf16 gradient is mostly
# rounding at random weights (kernel and plain paths alike read cosine 0.1-0.44 to
# fp32), are held by the kernel path's distance to the plain fp32 gradient over plain
# bf16's
ROUNDING_LEAVES = ("attn/q_norm/scale", "attn/k_norm/scale")
ROUNDING_GAP = 1.5
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
    "layernorm_bwd": ("cuda", f"{PKG}/csrc/layernorm_bwd.cu",
                      "projectiontrainer_tpu/ops/fused_layernorm.py:91"),
}
# the timed case that a kernel's entry of the {"kernels": ...} line reports: its first,
# or the one named here
MAIN_CASE = {"decode_attn": "B=8 nb=3 P=831 G=32 t=31 window=None"}
SERVE_KERNELS = ("flash_attn_fwd", "layernorm_fwd", "decode_attn")
STAGE1_KERNELS = ("flash_attn_fwd", "layernorm_fwd", "decode_attn", "flash_attn_bwd_dkv",
                  "flash_attn_bwd_dq", "fused_ce_fwd", "fused_ce_bwd")
STAGE0_KERNELS = ("flash_attn_fwd", "layernorm_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq",
                  "layernorm_bwd")
# stage 2 trains the table: the fused CE kernels (K6/K7) are refused there
STAGE2_KERNELS = ("flash_attn_fwd", "layernorm_fwd", "decode_attn", "flash_attn_bwd_dkv",
                  "flash_attn_bwd_dq", "layernorm_bwd")
# stage 2 QLoRA: the table is frozen (K6/K7 run), the tower too (no K8)
STAGE2_QLORA_KERNELS = ("flash_attn_fwd", "layernorm_fwd", "decode_attn", "flash_attn_bwd_dkv",
                        "flash_attn_bwd_dq", "fused_ce_fwd", "fused_ce_bwd")


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

    # K3: split-cache decode, B=8, 3 beams, P=831, G=32; then one request (B=1) and the
    # reference's max_new_tokens (G=1024, t=1000); each against its plain version, a
    # rerun held bit-equal
    for b, g, steps in ((8, 32, (0, 17, 31)), (1, 32, (31,)), (8, 1024, (1000,))):
        check_decode(rng, record, b, 3, 831, g, steps)

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
    check_stage2_kernels(rng, record)
    check_qwen3_kernels(rng, record)
    check_cls_kernels(rng, record)
    check_llama_kernels(rng, record)
    emit({"phase": 2, "readings": READINGS})
    return results


def check_decode(rng, record, b, nb, p_len, g, steps, *, hq=4, hkv=1, d=256,
                 windows=(512, None), label="", pmask=None):
    """K3 at batch b, nb beams, GQA hq/hkv at head dim d (Gemma3-1B's 4/1 at 256 by
    default), a prefix of p_len slots with ragged left padding (or the [b, p_len] mask
    ``pmask``) and g generated slots, at
    each step t of `steps` and each window of `windows`; record(kernel, case, err, ms,
    plain_ms, bound, library_ms, library)."""
    import torch

    from projectiontrainer_tpu_torch.kernels.check_decode_attn import library_call
    from projectiontrainer_tpu_torch.ops import decode_attention as DA

    qd = _bf16(rng, (b * nb, hq, d))
    kp, vp = _bf16(rng, (b, hkv, p_len, d)), _bf16(rng, (b, hkv, p_len, d))
    kg, vg = _bf16(rng, (b * nb, hkv, g, d)), _bf16(rng, (b * nb, hkv, g, d))
    if pmask is None:
        pmask, _ = _left_pad_mask(rng, b, p_len, 224)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for t in steps:
        for window in windows:
            kw = dict(prefix_mask=pmask, t=t, prefix_len=p_len, scale=d ** -0.5,
                      window=window)
            got = DA.decode_attention(qd, kp, vp, kg, vg, **kw)
            ref = DA.decode_attention_reference(*(x.float() for x in (qd, kp, vp, kg, vg)),
                                                **kw)
            case = f"{label}B={b} nb={nb} P={p_len} G={g} t={t} window={window}"
            for _ in range(2):
                if not torch.equal(got, DA.decode_attention(qd, kp, vp, kg, vg, **kw)):
                    raise AssertionError(f"decode {case}: a rerun gave other bits")
            plan = DA.decode_plan(b, nb, hkv, p_len, g, t, p_len, window, sms)
            if not plan["ctas"] > b * hkv:
                raise AssertionError(f"decode {case}: {plan['ctas']} CTAs for {b * hkv} "
                                     "(batch, KV head) pairs")
            lib, backend, live = library_call(qd, kp, vp, kg, vg, **kw)
            record("decode_attn", f"{case} ({plan['ctas']} CTAs)",
                   compare(f"decode {case}", got, ref),
                   cuda_ms(lambda: DA.decode_attention(qd, kp, vp, kg, vg, **kw)),
                   cuda_ms(lambda: DA.decode_attention_reference(qd, kp, vp, kg, vg, **kw)),
                   bound_decode_attn(b, nb, hq, hkv, p_len, g, d, live),
                   cuda_ms(lib), f"SDPA {backend} over concatenated caches, explicit mask")


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

    # K2 and K8 over the vision tower's rows; K8 also at fewer rows
    x = _bf16(rng, (16384, 1152))
    p = {"scale": _bf16(rng, (1152,), 0.5) + 1, "bias": _bf16(rng, (1152,), 0.1)}
    got = FLN.layernorm(p, x)
    ref = FLN.layernorm_reference({k: v.float() for k, v in p.items()}, x.float())
    record("layernorm_fwd", "vision rows [16384,1152]", compare("layernorm 1152", got, ref),
           cuda_ms(lambda: FLN.layernorm(p, x)), cuda_ms(lambda: FLN.layernorm_reference(p, x)),
           bound_layernorm_fwd(16384, 1152),
           cuda_ms(lambda: F.layer_norm(x, (1152,), p["scale"], p["bias"], 1e-6)), "F.layer_norm")
    check_layernorm_bwd(rng, record, x, p)
    del x, p
    # the ViT-L tower's rows (stage 2 trains it): [B * 576, 1024]
    x = _bf16(rng, (8 * 576, 1024))
    check_layernorm_bwd(rng, record, x, {"scale": _bf16(rng, (1024,), 0.5) + 1},
                        cases=((4608, True),))

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


def check_attention_layer(rng, record, case, b, t, hq, hkv, d, mask, rerun=False, **kw):
    """K1 (when ``mask`` is given: the forward of the same layer), K4 and K5 at one
    decoder or tower shape against their plain versions, each beside its bound and the
    library call, and with ``rerun`` a second launch of K4 and K5 held bit-equal;
    record(kernel, case, err, ms, plain_ms, bound, library_ms, library)."""
    import torch

    from projectiontrainer_tpu_torch.ops import flash_attention as FA

    q, do = _bf16(rng, (b, t, hq, d)), _bf16(rng, (b, t, hq, d))
    k, v = _bf16(rng, (b, t, hkv, d)), _bf16(rng, (b, t, hkv, d))
    out, lse = FA.flash_attention(q, k, v, kv_mask=mask, **kw)
    seen = (attention_mask(t, causal=kw["causal"], window=kw["window"], kv_mask=mask)
            if mask is not None or kw["causal"] else None)
    pairs = None if seen is None else live_pairs(seen)
    if mask is not None:  # K1 at this shape: the forward of the same layer
        ref, ref_lse = FA.flash_attention_reference(q.float(), k.float(), v.float(),
                                                    kv_mask=mask, **kw)
        err = compare(f"flash {case} out", out, ref)
        compare(f"flash {case} lse", lse[mask.bool()[:, None, :].expand_as(lse)],
                ref_lse[mask.bool()[:, None, :].expand_as(lse)])
        del ref, ref_lse
        lib, backend = sdpa_library(q, k, v, scale=kw["scale"], mask=seen)
        record("flash_attn_fwd", case, err,
               cuda_ms(lambda: FA.flash_attention(q, k, v, kv_mask=mask, **kw)),
               cuda_ms(lambda: FA.flash_attention_reference(q, k, v, kv_mask=mask, **kw)),
               bound_flash_fwd(b, t, hq, hkv, d, pairs), cuda_ms(lib),
               f"SDPA {backend}, explicit mask")
    prep = FA.prepare_bwd(q, k, v, mask, out, lse, do)
    args = (q, k, v, prep[0], prep[1], lse, prep[2])
    dk, dv = FA.launch_bwd_dkv(*args, **kw)
    dq = FA.launch_bwd_dq(*args, **kw)
    if rerun:
        again = (*FA.launch_bwd_dkv(*args, **kw), FA.launch_bwd_dq(*args, **kw))
        if not all(torch.equal(x, y) for x, y in zip((dk, dv, dq), again)):
            raise AssertionError(f"flash {case}: a rerun of K4 or K5 gave other bits")
        del again
    rq, rk, rv = FA.flash_attention_bwd_reference(q.float(), k.float(), v.float(), mask,
                                                  out.float(), lse, do.float(), **kw)
    err_kv = max(compare_rel(f"flash {case} dk", dk, rk), compare_rel(f"flash {case} dv", dv, rv))
    err_q = compare_rel(f"flash {case} dq", dq, rq)
    del rq, rk, rv
    plain = cuda_ms(lambda: FA.flash_attention_bwd_reference(q, k, v, mask, out, lse, do, **kw))
    lib, backend = sdpa_library_bwd(q, k, v, do, scale=kw["scale"], mask=seen)
    library = (cuda_ms(lib), f"SDPA {backend} backward (dq, dk, dv together)"
               + (", explicit mask" if seen is not None else ""))
    record("flash_attn_bwd_dkv", case, err_kv, cuda_ms(lambda: FA.launch_bwd_dkv(*args, **kw)),
           plain, bound_flash_bwd_dkv(b, t, hq, hkv, d, pairs), *library)
    record("flash_attn_bwd_dq", case, err_q, cuda_ms(lambda: FA.launch_bwd_dq(*args, **kw)),
           plain, bound_flash_bwd_dq(b, t, hq, hkv, d, pairs), *library)


def check_stage2_kernels(rng, record):
    """The shapes stage 2 adds (batch 1): K4/K5 over the trained ViT-L tower
    ([1,576,16,64], non-causal), K1/K4/K5 over the decoder's longest bucket (575 visual
    + 128 question + 512 answer = 1215 tokens, GQA 4/1, causal, window 512, the
    question's and the answer's padding masked) and K8 over the tower's rows
    ([576,1024]); record(kernel, case, err, ms, plain_ms, bound, library_ms, library)."""
    import torch

    check_attention_layer(rng, record, "stage-2 tower [1,576,16,64] non-causal", 1, 576, 16,
                          16, 64, None, scale=64 ** -0.5, causal=False, window=None)
    mask = torch.zeros((1, 1215), dtype=torch.int32, device="cuda")
    mask[0, :575 + 40] = 1             # visual tokens, a question of 40 tokens
    mask[0, 575 + 128:575 + 128 + 300] = 1  # an answer of 300 tokens
    check_attention_layer(
        rng, record, "stage-2 decoder [1,1215,4|1,256] causal window=512, padded question and "
        "answer", 1, 1215, 4, 1, 256, mask, scale=256 ** -0.5, causal=True, window=512)
    x = _bf16(rng, (576, 1024))
    check_layernorm_bwd(rng, record, x, {"scale": _bf16(rng, (1024,), 0.5) + 1},
                        cases=((576, False),))


def check_qwen3_kernels(rng, record):
    """The shapes of Qwen3-8B's QLoRA path (phases 11-13): K1/K4/K5 at the longest
    stage-2 bucket at batch 4 ([4,1855,32|8,128]: 575 visual + 256 question + 1024
    answer tokens, causal, no window, each row's question and answer right-padded to
    its own length), K3 at head dim 128 with GQA 32/8 (the served batch and one
    request, no window), and K6/K7 over the answer positions of a batch of 4 at
    Qwen3's untied head ([4096,4096] x [151936,4096]);
    record(kernel, case, err, ms, plain_ms, bound, library_ms, library)."""
    import torch

    b, t = 4, 575 + 256 + 1024
    mask = torch.zeros((b, t), dtype=torch.int32, device="cuda")
    q_lens, a_lens = rng.integers(8, 257, size=b), rng.integers(32, 1025, size=b)
    q_lens[0], a_lens[0] = 256, 1024
    for i in range(b):
        mask[i, :575 + q_lens[i]] = 1
        mask[i, 575 + 256:575 + 256 + a_lens[i]] = 1
    check_attention_layer(
        rng, record, "Qwen3 decoder [4,1855,32|8,128] causal, padded questions and answers",
        b, t, 32, 8, 128, mask, scale=128 ** -0.5, causal=True, window=None)
    for bb in (8, 1):
        check_decode(rng, record, bb, 3, 575 + 256, 32, (31,), hq=32, hkv=8, d=128,
                     windows=(None,), label="Qwen3 ")
    check_fused_ce(rng, record, n=4 * 1024, vocab=151_936, d=4096, label="Qwen3 ")


def check_cls_kernels(rng, record):
    """The cls probe's shapes (phases 14-15: ViT-L/16-384 at batch 32): K1 forward, K4
    and K5 at [32,576,16,64] non-causal, K2 and K8 over the tower's [18432,1024] rows;
    each against its plain version, a rerun held bit-equal, timed beside its bound and
    the library call; record(kernel, case, err, ms, plain_ms, bound, library_ms, library)."""
    import torch
    import torch.nn.functional as F

    from projectiontrainer_tpu_torch.ops import flash_attention as FA
    from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN

    q, k, v = (_bf16(rng, (32, 576, 16, 64)) for _ in range(3))
    out, lse = FA.flash_attention(q, k, v)
    ref, ref_lse = FA.flash_attention_reference(q.float(), k.float(), v.float())
    err = compare("flash cls tower out", out, ref)
    compare("flash cls tower lse", lse, ref_lse)
    if not all(torch.equal(x, y) for x, y in zip((out, lse), FA.flash_attention(q, k, v))):
        raise AssertionError("flash cls tower: a rerun of K1 gave other bits")
    del ref, ref_lse
    lib, backend = sdpa_library(q, k, v, scale=64 ** -0.5)
    record("flash_attn_fwd", "cls tower [32,576,16,64]", err,
           cuda_ms(lambda: FA.flash_attention(q, k, v)),
           cuda_ms(lambda: FA.flash_attention_reference(q, k, v)),
           bound_flash_fwd(32, 576, 16, 16, 64), cuda_ms(lib), f"SDPA {backend}")
    del q, k, v, out, lse, lib
    check_attention_layer(rng, record, "cls tower [32,576,16,64] non-causal", 32, 576, 16, 16,
                          64, None, rerun=True, scale=64 ** -0.5, causal=False, window=None)

    x = _bf16(rng, (32 * 576, 1024))
    p = {"scale": _bf16(rng, (1024,), 0.5) + 1, "bias": _bf16(rng, (1024,), 0.1)}
    got = FLN.layernorm(p, x)
    ref = FLN.layernorm_reference({k: v.float() for k, v in p.items()}, x.float())
    err = compare("layernorm cls rows", got, ref)
    if not torch.equal(got, FLN.layernorm(p, x)):
        raise AssertionError("layernorm cls rows: a rerun of K2 gave other bits")
    record("layernorm_fwd", "cls rows [18432,1024]", err,
           cuda_ms(lambda: FLN.layernorm(p, x)), cuda_ms(lambda: FLN.layernorm_reference(p, x)),
           bound_layernorm_fwd(18432, 1024),
           cuda_ms(lambda: F.layer_norm(x, (1024,), p["scale"], p["bias"], 1e-6)), "F.layer_norm")
    check_layernorm_bwd(rng, record, x, p, cases=((18432, True),))


def check_flash_forward(rng, record, case, b, t, hq, hkv, d, mask, **kw):
    """K1 alone at one shape (``mask``: the [B, T] key padding or None): out and lse
    against the plain version, a rerun held bit-equal, timed beside its bound and the
    library call; record(kernel, case, err, ms, plain_ms, bound, library_ms, library)."""
    import torch

    from projectiontrainer_tpu_torch.ops import flash_attention as FA

    q, k, v = _bf16(rng, (b, t, hq, d)), _bf16(rng, (b, t, hkv, d)), _bf16(rng, (b, t, hkv, d))
    out, lse = FA.flash_attention(q, k, v, kv_mask=mask, **kw)
    ref, ref_lse = FA.flash_attention_reference(q.float(), k.float(), v.float(), kv_mask=mask,
                                                **kw)
    err = compare(f"flash {case} out", out, ref)
    live = (torch.ones_like(lse, dtype=torch.bool) if mask is None
            else mask.bool()[:, None, :].expand_as(lse))
    compare(f"flash {case} lse", lse[live], ref_lse[live])
    del ref, ref_lse
    again, again_lse = FA.flash_attention(q, k, v, kv_mask=mask, **kw)
    if not (torch.equal(out, again) and torch.equal(lse[live], again_lse[live])):
        raise AssertionError(f"flash {case}: a rerun gave other bits")
    keys = torch.ones((b, t), dtype=torch.int32, device="cuda") if mask is None else mask
    seen = attention_mask(t, causal=kw["causal"], window=kw["window"], kv_mask=keys)
    explicit = mask is not None or kw["window"] is not None
    lib, backend = sdpa_library(q, k, v, scale=kw["scale"], causal=kw["causal"],
                                mask=seen if explicit else None)
    record("flash_attn_fwd", case, err,
           cuda_ms(lambda: FA.flash_attention(q, k, v, kv_mask=mask, **kw)),
           cuda_ms(lambda: FA.flash_attention_reference(q, k, v, kv_mask=mask, **kw)),
           bound_flash_fwd(b, t, hq, hkv, d, live_pairs(seen)), cuda_ms(lib),
           f"SDPA {backend}" + (", explicit mask" if explicit else ""))


def check_llama_kernels(rng, record):
    """The shapes of the inference and analysis slice (phases 17-19): K1 at the
    Llama-3.2-1B prefill (32/8 heads of 64, causal): the caption's [1,575] and the
    largest question bucket's [8,831] with each row's question left-padded after the
    visual tokens, and the generation evaluation's own prefix (phase 18: the diagnostic
    prompt left-padded to its bucket, ``generation_eval_mask``); K1 at the ViT-L text tower ([14,64,16,64], non-causal, unmasked:
    14 class prompts); K1 at Mistral-7B-v0.1's every-layer window ([1,4608,32|8,128],
    causal, window 4096: the window binds past 4096 tokens); K3 at head dim 64 with GQA
    32/8: the served batch (8 x 3 beams, P = 831, G = 32), one caption (1 x 3 beams,
    P = 575, G = 128) and the generation evaluation's batch over its own prefix mask,
    no window; each against its plain version, a rerun held
    bit-equal; record(kernel, case, err, ms, plain_ms, bound, library_ms, library)."""
    import torch

    llama = dict(scale=64 ** -0.5, causal=True, window=None)
    check_flash_forward(rng, record, "Llama prefill [1,575,32|8,64] causal", 1, 575, 32, 8, 64,
                        None, **llama)
    mask = torch.ones((8, 831), dtype=torch.int32, device="cuda")
    for i, n in enumerate(rng.integers(0, 249, size=8)):
        mask[i, 575:575 + n] = 0  # the question's left padding
    check_flash_forward(rng, record, "Llama prefill [8,831,32|8,64] causal, left-padded "
                        "questions", 8, 831, 32, 8, 64, mask, **llama)
    check_flash_forward(rng, record, "ViT-L text tower [14,64,16,64]", 14, 64, 16, 16, 64, None,
                        scale=64 ** -0.5, causal=False, window=None)
    check_flash_forward(rng, record, "Mistral-7B [1,4608,32|8,128] causal window=4096", 1, 4608,
                        32, 8, 128, None, scale=128 ** -0.5, causal=True, window=4096)
    check_decode(rng, record, 8, 3, 831, 32, (0, 17, 31), hq=32, hkv=8, d=64, windows=(None,),
                 label="Llama ")
    check_decode(rng, record, 1, 3, 575, 128, (0, 127), hq=32, hkv=8, d=64, windows=(None,),
                 label="Llama caption ")
    mask = generation_eval_mask()
    p_len = mask.shape[1]
    check_flash_forward(rng, record, f"Llama generation eval [8,{p_len},32|8,64] causal, the "
                        "prompt left-padded", 8, p_len, 32, 8, 64, mask, **llama)
    check_decode(rng, record, 8, 3, p_len, 32, (0, 17, 31), hq=32, hkv=8, d=64,
                 windows=(None,), label="Llama generation eval ", pmask=mask)


def generation_eval_mask(b=8, n_visual=575):
    """The key mask of phase 18's prefix, as ``infer_vqa_stage2.build_prefix`` builds it:
    n_visual visual tokens, then DIAGNOSTIC_PROMPT's stub ids left-padded to their
    question bucket (max_q_len GENERATION_MAX_Q_LEN), alike in every row."""
    import torch

    from projectiontrainer_tpu_torch.cli import infer_generation as ig
    from projectiontrainer_tpu_torch.data.bucketing import (DEFAULT_Q_BUCKETS, bucket_for,
                                                           buckets_covering)

    n = len(PromptTokenizer()(ig.DIAGNOSTIC_PROMPT, max_length=GENERATION_MAX_Q_LEN)["input_ids"])
    q_len = min(bucket_for(n, buckets_covering(GENERATION_MAX_Q_LEN, DEFAULT_Q_BUCKETS)),
                GENERATION_MAX_Q_LEN)
    mask = torch.ones((b, n_visual + q_len), dtype=torch.int32, device="cuda")
    mask[:, n_visual:n_visual + q_len - n] = 0
    return mask


def check_layernorm_bwd(rng, record, x, p, cases=((16384, True), (16383, True), (1001, True),
                                                 (1000, False), (529, True), (16, False))):
    """K8 over the first n rows of x for each (n, ragged) of `cases`: dx, dscale and dbias
    against the plain backward (each within REL_BWD x max|reference|), a rerun held
    bit-equal, and the plan (ops/fused_layernorm.py:bwd_plan) held to its raggedness (a
    CTA's last ring stage part-filled); kernel, plain and library times beside the bound.
    The default cases: the stage-0 tower's rows (16384), row counts whose bands end
    part-way through a stage (16383, 1001, 529) or fill whole stages (1000), and the MAP
    head's 16 rows (one CTA, no grid barrier)."""
    import torch
    import torch.nn.functional as F

    from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    d = x.shape[1]
    for n, want_ragged in cases:
        plan = FLN.bwd_plan(n, d, sms)
        ragged = FLN.bwd_ragged(n, plan)
        if sms == 132 and ragged != want_ragged:
            raise AssertionError(f"layernorm bwd: {n} rows on {sms} SMs, plan {plan}: "
                                 f"ragged {ragged}, expected {want_ragged}")
        x2, dy = x[:n], _bf16(rng, (n, d))
        got = FLN.layernorm_bwd(x2, dy, p["scale"], 1e-6)
        ref = FLN.layernorm_bwd_reference(x2.float(), dy.float(), p["scale"].float(), 1e-6)
        err = max(compare_rel(f"layernorm bwd {part} [{n},{d}]", a, b)
                  for part, a, b in zip(("dx", "dscale", "dbias"), got, ref))
        for _ in range(2):
            if not all(torch.equal(a, b) for a, b in
                       zip(got, FLN.layernorm_bwd(x2, dy, p["scale"], 1e-6))):
                raise AssertionError(f"layernorm bwd [{n},{d}]: a rerun gave other bits")
        counts = sorted({c for _, c in FLN.bwd_bands(n, plan["ctas"])})
        case = (f"[{n},{d}] {plan['ctas']} CTAs, bands of {counts} rows, "
                f"{plan['stages']} stages of {plan['rows']} rows" + (" (ragged)" if ragged else ""))
        leaves = [x2.detach().requires_grad_(True), p["scale"].detach().requires_grad_(True),
                  torch.zeros(d, dtype=x.dtype, device="cuda", requires_grad=True)]
        y = F.layer_norm(leaves[0], (d,), leaves[1], leaves[2], 1e-6)
        record("layernorm_bwd", case, err,
               cuda_ms(lambda: FLN.layernorm_bwd(x2, dy, p["scale"], 1e-6)),
               cuda_ms(lambda: FLN.layernorm_bwd_reference(x2, dy, p["scale"], 1e-6)),
               bound_layernorm_bwd(n, d),
               cuda_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)),
               "F.layer_norm backward (dx, dscale, dbias)")


def check_flash_reruns(rng, record):
    """K1, K4 and K5 at a T that no tile divides ([16,1000,16,72]; the text tower's T = 64
    is among the stage-0 shapes), K1's fp32 copy of O against its bf16 O, and a rerun of
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

    dq = FA.launch_bwd_dq(*args, **kw)
    rq = FA.flash_attention_bwd_reference(q.float(), k.float(), v.float(), None, out32, lse,
                                          do.float(), **kw)[0]
    record("flash_attn_bwd_dq", case, compare_rel("flash ragged d72 dq", dq, rq),
           cuda_ms(lambda: FA.launch_bwd_dq(*args, **kw)),
           cuda_ms(lambda: FA.flash_attention_bwd_reference(q, k, v, None, out32, lse, do, **kw)),
           bound_flash_bwd_dq(16, 1000, 16, 16, 72), cuda_ms(lib),
           f"SDPA {backend} backward (dq, dk, dv together)")

    rerun("flash forward d72", (out, lse, out32),
          lambda: FA._launch(q, k, v, kv_mask=None, out_f32=True, **kw))
    rerun("flash dkv d72", (dk, dv), lambda: FA.launch_bwd_dkv(*args, **kw))
    rerun("flash dq d72", (dq,), lambda: (FA.launch_bwd_dq(*args, **kw),))
    del q, k, v, do, out, lse, out32, delta, dk, dv, dq, rk, rv, rq, ref, ref_lse, lib

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
    rerun("flash dq d256", (FA.launch_bwd_dq(*args, **kw),),
          lambda: (FA.launch_bwd_dq(*args, **kw),))
    emit({"phase": 2, "check": "K1 fp32 O rounds to its bf16 O; K1, K4 and K5 reruns bit-equal "
                               "at [16,1000,16,72] and [4,1087,4|1,256] causal window 512"})


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


def check_fused_ce(rng, record, n=2048, vocab=262_144, d=1152, label=""):
    """K6/K7 against their plain versions and beside the library call (F.linear +
    F.cross_entropy on bf16 logits, and its autograd backward to the hidden states);
    record(kernel, case, err, ms, plain_ms, bound, library_ms, library). The default
    shape is stage 1's: 4 x 512 caption positions at Gemma3's vocab."""
    import torch
    import torch.nn.functional as F

    from projectiontrainer_tpu_torch.ops import fused_ce as CE

    # A quarter of the positions ignored (label -100: a dummy 0 and zero upstream
    # gradient). The table's scale puts the logits' std at ~5 (0.15 at D = 1152), so
    # each row's softmax mass sits on a few tokens in one vocab split or another, and
    # the upstream gradient g differs per row (mean-loss weights times a random factor,
    # exact in bf16: the kernel's bf16 (p - onehot) * g is then exactly -g at a label of
    # negligible p).
    scale = 0.15 * (1152 / d) ** 0.5
    h, table = _bf16(rng, (n, d)), _bf16(rng, (vocab, d), scale)
    labels = rng.integers(0, vocab, size=n)
    ignored = rng.random(n) < 0.25
    valid = torch.tensor(~ignored, device="cuda")
    safe = torch.tensor(np.where(ignored, 0, labels), dtype=torch.int32, device="cuda")
    g = np.where(ignored, 0.0, rng.uniform(0.5, 1.5, size=n) / (~ignored).sum())
    g = torch.tensor(g, dtype=torch.float32, device="cuda").to(torch.bfloat16).float()
    case = f"{label}[{n},{d}] x [{vocab},{d}] scale {scale:.3g}, 25% ignored, g per row"
    lse, nll = CE.fused_ce_fwd(h, table, safe)
    rlse, rnll = CE.fused_ce_reference(h.float(), table.float(), safe)
    err = max(compare(f"{label}fused ce lse", lse, rlse, atol=CE_ATOL, rtol=0),
              compare(f"{label}fused ce nll", nll[valid], rnll[valid], atol=CE_ATOL, rtol=0))
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
    err = max(compare_rel(f"{label}fused ce dh", dh, rdh),
              compare_rel(f"{label}fused ce dh softmax part", dh + onehot, rdh + onehot))
    if bool(dh[~valid].ne(0).any()):
        raise AssertionError(f"{label}fused ce dh: an ignored position got a gradient")
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


def phase_serve(cfg, params, counters, *, clients=16, adapter_path=None, phase=3):
    """VQAService over the in-memory model: ``clients`` threads of 2 requests each,
    batch 8, 3 beams, MAX_NEW_TOKENS; ``adapter_path`` merges a LoRA adapter first.
    The service holds the params from here on (drop the caller's reference)."""
    import logging

    from projectiontrainer_tpu_torch.cli import serve

    size = cfg.vision.image_size
    args = serve.build_parser().parse_args([
        "--vision_model_name", "in-memory", "--llm_name", "in-memory", "--projector_path", "",
        "--img_size", str(size), "--batch_size", "8", "--num_beams", "3",
        "--repetition_penalty", "1.8", "--length_penalty", "1.2", "--max_q_len", "256",
        "--max_new_tokens", str(MAX_NEW_TOKENS), "--max_wait_ms", "20",
        *(["--adapter_path", adapter_path] if adapter_path else []),
    ])
    t0 = time.perf_counter()
    service = serve.VQAService(args, logging.getLogger("chip_smoke"),
                               model=(cfg, params, StubTokenizer()))
    del params
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    service.warmup()  # one batch per question bucket: first-call costs stay out of the stats
    warmup_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED + 1)
    requests = [
        serve.Request(np.clip(rng.standard_normal((size, size, 3), dtype=np.float32), -1, 1),
                      rng.integers(2, cfg.llm.vocab_size, size=int(rng.integers(8, 201))).tolist())
        for _ in range(2 * clients)
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
    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
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
    if phase == 13:
        print(f"serve (Qwen3-8B + adapter): {len(answers) / wall:.3f} req/s, p50 "
              f"{stats['p50_latency_s']:.3f} s, p95 {stats['p95_latency_s']:.3f} s "
              f"({clients} clients x 2 requests, batch 8, 3 beams, {MAX_NEW_TOKENS} new tokens)",
              flush=True)
    emit({"phase": phase, "requests": len(answers),
          "answered": sum(a is not None for a in answers),
          "req_per_s": len(answers) / wall, "wall_s": wall, "warmup_s": warmup_s,
          "service_build_s": build_s, "adapter_path": adapter_path,
          "stats": stats, "launches": launches, "batch_size": 8, "num_beams": 3,
          "clients": clients, "max_new_tokens": MAX_NEW_TOKENS,
          "cut": "max_new_tokens 32 (reference serving config: 1024), for run time"})
    return launches


# ---------------------------------------------------------------------------- phase 4


def plain_config(cfg):
    """The same VLM or dual-tower config with the plain attention and LayerNorm in every
    tower and the decoder."""
    tower = dict(attn_impl="plain", norm_impl="plain")
    parts = {"vision": tower, "text": tower, "llm": {"attn_impl": "plain"}}
    return dataclasses.replace(cfg, **{name: dataclasses.replace(getattr(cfg, name), **kw)
                                       for name, kw in parts.items() if hasattr(cfg, name)})


def teacher_forced(cfg, params, prefix, nb, teacher):
    """The prefill logits and len(teacher) decode steps of ``nb`` beams a sample through
    the split cache, fed the rows of ``teacher`` [steps, B * nb]; ``prefix(cfg)`` builds
    the (embeds, mask) prefix."""
    import torch

    from projectiontrainer_tpu_torch.generate import decode as D
    from projectiontrainer_tpu_torch.models import decoder as dec

    with torch.no_grad():
        embeds, mask = prefix(cfg)
        b, p = embeds.shape[:2]
        cache, logits, last_pos, _ = D._prefill(params["llm"], cfg.llm, embeds, mask, p)
        cache, pmask = dec.split_cache(cache, cfg.llm, b * nb, len(teacher), prefix_mask=mask)
        out = [logits]
        last_pos = last_pos.repeat_interleave(nb)
        for t in range(len(teacher)):
            logits, cache = D._step(params["llm"], cfg.llm, teacher[t], last_pos, t, pmask,
                                    cache, p, embeds.dtype)
            out.append(logits)
    return out


def hold_logits(label, kernel_path, plain_path) -> list:
    """Each step's logits of the kernel path against the plain path's: every row's
    cosine >= 0.99 (the argmax agreement reported)."""
    import torch.nn.functional as F

    rows = []
    for i, (a, b) in enumerate(zip(kernel_path, plain_path)):
        if not bool(a.isfinite().all()):
            raise AssertionError(f"{label}: non-finite logits")
        cos = float(F.cosine_similarity(a.float(), b.float(), dim=-1).min())
        top1 = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        rows.append({"step": "prefill" if i == 0 else f"decode {i - 1}", "min_cosine": cos,
                     "top1_agreement": top1})
        if not cos >= 0.99:
            raise AssertionError(f"{label}: {rows[-1]['step']} cosine {cos:.5f} < 0.99")
    return rows


def phase_end_to_end(cfg, params):
    import torch

    from projectiontrainer_tpu_torch.cli import infer_vqa_stage2 as vqa

    rng = np.random.default_rng(SEED + 2)
    size = cfg.vision.image_size
    pixels = np.clip(rng.standard_normal((8, size, size, 3), dtype=np.float32), -1, 1)
    q_tok = [rng.integers(2, cfg.llm.vocab_size, size=int(n)).tolist()
             for n in rng.integers(8, 120, size=8)]
    tok = StubTokenizer()
    nb = 3
    teacher = torch.tensor(rng.integers(2, cfg.llm.vocab_size, size=(4, 8 * nb)),
                           device=params["llm"]["embed_tokens"]["embedding"].device)

    def prefix(c):
        return vqa.build_prefix(pixels, q_tok, c, params, tok, max_q_len=256)

    rows = hold_logits("end to end", teacher_forced(cfg, params, prefix, nb, teacher),
                       teacher_forced(plain_config(cfg), params, prefix, nb, teacher))
    split = serve_split(cfg, params, lambda: prefix(cfg), nb)
    print(f"serve: a decode step of {8 * nb} rows {split['decode_step_host_ms']:.1f} ms on the "
          f"host clock, {split['decode_step_kernel_ms']:.1f} ms of kernel time", flush=True)
    emit({"phase": 4, "logits": rows, "serve_split": split})


def serve_split(cfg, params, prefix, nb, steps=MAX_NEW_TOKENS):
    """One batch of the kernel path split into its pieces: the prefix (``prefix()`` ->
    (embeds, mask): tower, projector, embedding), the prefill, and ``steps``
    teacher-forced decode steps of B * nb rows. Each piece's kernel time on the card from
    a torch.profiler trace of it alone (every kernel counts, also those the port launches
    through ctypes, which no torch operator encloses), the decode step's attention
    kernels (K3) apart; and a decode step on the host clock, synchronised, without the
    profiler."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from projectiontrainer_tpu_torch.generate import decode as D
    from projectiontrainer_tpu_torch.models import decoder as dec
    from projectiontrainer_tpu_torch.utils import timing

    llm = params["llm"]

    def kernel_ms(fn):
        """(all kernels, attention kernels) in ms while fn() runs."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [(timing.kernel_family(name), ms) for name, ms in timing.device_kernels(prof.events())]
        return sum(t for _, t in kernels), sum(t for f, t in kernels if f == "attention")

    def prefill(embeds, mask):
        cache, _, last_pos, _ = D._prefill(llm, cfg.llm, embeds, mask, embeds.shape[1])
        cache, pmask = dec.split_cache(cache, cfg.llm, embeds.shape[0] * nb, steps,
                                       prefix_mask=mask)
        return cache, pmask, last_pos.repeat_interleave(nb)

    def decode(embeds, cache, pmask, last_pos, host=None):
        for t in range(steps):
            t0 = time.perf_counter()
            _, cache = D._step(llm, cfg.llm, tokens[t], last_pos, t, pmask, cache,
                               embeds.shape[1], embeds.dtype)
            if host is not None:
                torch.cuda.synchronize()
                host.append(time.perf_counter() - t0)

    with torch.no_grad():
        embeds, mask = prefix()  # the first calls' costs
        rows = embeds.shape[0] * nb
        rng = np.random.default_rng(SEED + 9)
        tokens = torch.tensor(rng.integers(2, cfg.llm.vocab_size, size=(steps, rows)),
                              device=DEVICE)
        state = prefill(embeds, mask)
        decode(embeds, *state)
        host = []
        torch.cuda.synchronize()
        decode(embeds, *prefill(embeds, mask), host=host)
        prefix_ms, _ = kernel_ms(prefix)
        prefill_ms, _ = kernel_ms(lambda: prefill(embeds, mask))
        state = prefill(embeds, mask)
        decode_ms, attention_ms = kernel_ms(lambda: decode(embeds, *state))
    split = {"prefix_kernel_ms": prefix_ms, "prefill_kernel_ms": prefill_ms,
             "decode_step_kernel_ms": decode_ms / steps,
             "decode_step_attention_ms": attention_ms / steps,
             "decode_step_host_ms": statistics.median(host) * 1e3,
             "decode_steps": steps, "rows": rows, "prefix_len": embeds.shape[1]}
    if not all(v > 0 for v in split.values()):
        raise AssertionError(f"serve split: a piece has no kernel time: {split}")
    return split


# ---------------------------------------------------------------------------- phase 5


def check_profiler_spans():
    """The profile splits of ``utils/timing.py`` on the card, before the train phases
    read them: two ``span``s of matmuls with host sleeps between their launches (each
    range's user annotation on the card's timeline spans far more than its kernels).
    ``span_times``, ``kernel_families`` and ``device_kernels`` must each read the
    kernels' own time. Beside them: the spans' ``device_time_total`` (the profiler's own
    sum) and the CPU events that share an earlier event's id (the profiler's "Activity
    Buffer Request", whose linked kernels that sum counts twice)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from projectiontrainer_tpu_torch.utils import timing

    a = torch.randn(2048, 2048, device=DEVICE, dtype=torch.bfloat16)
    a @ a
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name in ("first", "second"):
            with timing.span(name):
                for _ in range(4):
                    a @ a
                    torch.cuda.synchronize()
                    time.sleep(0.002)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = sum(ms for _, ms in timing.device_kernels(events))
    reads = {"span_times": timing.span_times(events, device=True)["total_ms"],
             "kernel_families": sum(timing.kernel_families(events).values())}
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    ids, shared = set(), []
    for e in cpu:
        if e.id in ids:
            shared.append(e.name)
        ids.add(e.id)
    row = {"kernel_ms": kernels, **{f"{k}_ms": v for k, v in reads.items()},
           "device_time_total_ms": sum(e.device_time_total for e in cpu
                                       if e.name.startswith(timing.SPAN)) / 1e3,
           "events_sharing_an_id": shared}
    emit({"phase": 5, "profiler_spans": row})
    if not kernels > 0 or any(abs(v - kernels) > 1e-3 * kernels for v in reads.values()):
        raise AssertionError(f"profile splits: {row}")


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

    plain = plain_config(cfg)
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
    return launches, {**stats, "device_idle_share": idle}


# ---------------------------------------------------------------------------- phase 8


def phase_stage0_end_to_end(cfg, params, kernel_counters):
    import torch
    import torch.nn.functional as F

    from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths
    from projectiontrainer_tpu_torch.train import masks, steps

    plain = plain_config(cfg)
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


# ---------------------------------------------------------------------------- phase 9


class VQASamples:
    """In-memory stage-2 samples: seeded pixels in [-1, 1] (made once, in bulk),
    questions of 8-128 token ids and answers of 32-512 (the first sample at both
    maxima: the longest bucket, 575 + 128 + 512 = 1215 tokens), or the given
    ``lengths`` (question, answer), and their lengths for the bucket plan; no image
    files, no tokenizer."""

    def __init__(self, n, seed, *, size, vocab, lengths=None):
        rng = np.random.default_rng(seed)
        self.pixels = np.clip(rng.standard_normal((n, size, size, 3), dtype=np.float32), -1, 1)
        if lengths is None:
            self.q_lens = rng.integers(8, 129, size=n).astype(np.int32)
            self.a_lens = rng.integers(32, 513, size=n).astype(np.int32)
            self.q_lens[0], self.a_lens[0] = 128, 512
        else:
            self.q_lens, self.a_lens = (np.asarray(x, np.int32) for x in lengths)
        self.questions = [rng.integers(2, vocab, size=n_q).astype(np.int32) for n_q in self.q_lens]
        self.answers = [rng.integers(2, vocab, size=n_a).astype(np.int32) for n_a in self.a_lens]

    def __len__(self):
        return len(self.q_lens)

    def token_lengths(self):
        return self.q_lens, self.a_lens

    def __getitem__(self, i):
        return {"pixel_values": self.pixels[i], "question_ids": self.questions[i],
                "answer_ids": self.answers[i]}


def _stage2_watched(params):
    """Slices of the leaves whose moves phase 9 checks (the table's first rows only:
    all of it is 1.2 GB in fp32)."""
    v, llm = params["vision"], params["llm"]
    mid = len(v["layers"]) // 2
    return {"vision/patch_embedding/weight": v["patch_embedding"]["weight"],
            f"vision/layers/{mid}/attn/q_proj/weight": v["layers"][mid]["attn"]["q_proj"]["weight"],
            "vision/layers/-1/ln2/scale": v["layers"][-1]["ln2"]["scale"],
            "projector/fc1/weight": params["projector"]["fc1"]["weight"],
            "llm/embed_tokens/embedding[:4096]": llm["embed_tokens"]["embedding"][:4096],
            "llm/layers/-1/mlp/down_proj/weight": llm["layers"][-1]["mlp"]["down_proj"]["weight"]}


def phase_stage2_train(cfg, params, kernel_counters):
    """Stage2Trainer.train() at full width, the full-joint recipe; returns (launches,
    the launches of one epoch-0 micro-step at the longest bucket, the trained params)."""
    import torch

    from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
    from projectiontrainer_tpu_torch.core.config import Stage2Config
    from projectiontrainer_tpu_torch.train.trainer_stage2 import Stage2Trainer

    class OneCheckpointOnDisk(CheckpointManager):
        """Keeps one train-state file at a time (~21 GB each at this width) and records
        each save's name, bytes and seconds."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.saves = []

        def _save(self, name, state, metadata=None):
            for f in os.listdir(self.directory):
                if f.endswith(".pt"):
                    os.remove(os.path.join(self.directory, f))
            t0 = time.perf_counter()
            super()._save(name, state, metadata)
            self.saves.append({"name": name, "bytes": os.path.getsize(self._path(name)),
                               "seconds": time.perf_counter() - t0})

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_stage2_")
    size, vocab = cfg.vision.image_size, cfg.llm.vocab_size
    try:
        free_gb = shutil.disk_usage(out_dir).free / 1e9
        tcfg = Stage2Config(
            output_dir=out_dir, batch_size=1, gradient_accumulation_steps=8, num_epochs=2,
            learning_rate=1e-5, grad_clip=1.0, master_dtype="fp32", remat="full",
            mixed_precision="bf16", unfreeze_llm=True, unfreeze_projection_layer=True,
            train_ve_first_epoch=True, max_q_len=128, max_a_len=512, img_size=size,
            eval_max_new_tokens=16, eval_num_beams=3, eval_do_sample=True, logging_steps=1,
            num_workers=2, device=DEVICE, disable_wandb=True, seed=SEED,
            profile_dir=os.path.join(out_dir, "profile"), profile_start_step=6,
            profile_num_steps=2)
        trainer = Stage2Trainer(tcfg, vlm_cfg=cfg, params=params, tokenizer=StubTokenizer(),
                                train_dataset=VQASamples(16, SEED + 9, size=size, vocab=vocab),
                                val_dataset=VQASamples(2, SEED + 10, size=size, vocab=vocab))
        del params  # the trainer holds the fp32 masters now
        trainer.ckpt = OneCheckpointOnDisk(trainer.ckpt.directory, best_mode="min",
                                           save_paths=trainer.ckpt.save_paths)
        state_params = trainer.state["params"]
        seen = [{p: x.detach().clone() for p, x in _stage2_watched(state_params).items()}]
        save_checkpoint = trainer.save_checkpoint

        def save_and_watch(epoch):
            seen.append({p: x.detach().clone() for p, x in _stage2_watched(state_params).items()})
            save_checkpoint(epoch)

        trainer.save_checkpoint = save_and_watch
        # the first epoch-0 micro-step at the longest bucket runs with the counts set to
        # 0 and is read just after it; the counts before it go into the run's total
        longest = max(pb.q_bucket + pb.a_bucket for pb in trainer._train_plans[0])
        step_fn, tx, schedule = trainer._steps[True]
        before, one_step = {}, {}

        def counted_step(state, batch, rng=None):
            if one_step or batch["question_ids"].shape[1] + batch["answer_ids"].shape[1] < longest:
                return step_fn(state, batch, rng)
            before.update({n: c.value for n, c in kernel_counters.items()})
            for c in kernel_counters.values():
                c.reset()
            out = step_fn(state, batch, rng)
            one_step.update({n: c.value for n, c in kernel_counters.items()})
            return out

        trainer._steps[True] = (counted_step, tx, schedule)
        for c in kernel_counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: before.get(name, 0) + c.value for name, c in kernel_counters.items()}
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        exported = sorted(os.listdir(os.path.join(out_dir, "checkpoint-epoch_1")))
        llm_bytes = os.path.getsize(os.path.join(out_dir, "checkpoint-epoch_1", "language_model",
                                                 "model.safetensors"))
        examples = sorted(os.listdir(os.path.join(out_dir, "validation_examples")))
        traced = os.listdir(os.path.join(out_dir, "profile"))
        saves = trainer.ckpt.saves
        trained = trainer.state["params"]
        del trainer
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [r["train/step_loss"] for r in rows if "train/step_loss" in r]
    moved = [{p: float((b[p].float() - a[p].float()).abs().max()) for p in a}
             for a, b in zip(seen, seen[1:])]
    if len(losses) != 32 or not np.isfinite(losses).all():
        raise AssertionError(f"stage 2: expected 32 finite losses, got {losses}")
    if len(moved) != 2 or not all(m > 0 for m in moved[0].values()):
        raise AssertionError(f"stage 2: a leaf did not move in epoch 0: {moved}")
    if any(m != 0 for p, m in moved[1].items() if p.startswith("vision/")):
        raise AssertionError(f"stage 2: the tower moved in epoch 1: {moved[1]}")
    if not all(m > 0 for p, m in moved[1].items() if not p.startswith("vision/")):
        raise AssertionError(f"stage 2: the LLM, table or projector did not move in epoch 1: "
                             f"{moved[1]}")
    if exported != ["language_model", "metadata.json", "projection_layer"]:
        raise AssertionError(f"stage 2: checkpoint-epoch_1/ holds {exported}")
    if examples != ["epoch_0_examples.txt", "epoch_1_examples.txt"]:
        raise AssertionError(f"stage 2: validation examples {examples}")
    if not all(launches[n] for n in STAGE2_KERNELS):
        raise AssertionError(f"stage 2: a kernel of the path never launched: {launches}")
    if not all(one_step.get(n) for n in STAGE2_KERNELS if n != "decode_attn"):
        raise AssertionError(f"stage 2: an epoch-0 micro-step of {575 + longest} tokens "
                             f"launched {one_step}")
    # the row logged after step 6 sums the timed windows so far: steps 1-5
    step6 = next((r for r in rows if r.get("step") == 6 and "step_time_ms" in r), {})
    stats = {"images_per_sec": step6.get("images_per_sec"),
             "micro_step_ms": step6.get("step_time_ms")}
    if not all(stats.values()):
        raise AssertionError(f"stage 2: no throughput measured for steps 1-5: {rows[:8]}")
    split = {k[len("profile/"):]: v for r in rows for k, v in r.items()
             if k.startswith("profile/")}
    pieces = ("tower_fwd", "tower_bwd", "projector_fwd", "projector_bwd", "decoder_fwd",
              "decoder_bwd", "lm_head_ce_fwd", "lm_head_ce_bwd", "optimizer_fwd")
    if traced != ["trace_step6.json"] or not all(split.get(f"{p}_ms", 0) > 0 for p in pieces):
        raise AssertionError(f"stage 2: no kernel time traced for a piece of the step: {split}")
    idle = 1 - split["total_ms"] / stats["micro_step_ms"]
    print(f"stage 2: {stats['images_per_sec']:.3f} images/s, {stats['micro_step_ms']:.1f} ms a "
          f"micro-step (steps 1-5, batch 1, up to 1215 tokens); kernel time "
          f"{split['total_ms']:.1f} ms a micro-step in steps 6-7 (device idle {idle:.1%}); "
          f"checkpoints {[(c['name'], round(c['bytes'] / 1e9, 2), round(c['seconds'], 1)) for c in saves]} "
          f"(GB, s; {free_gb:.0f} GB free)", flush=True)
    emit({"phase": 9, "micro_steps": len(losses), "losses": losses, **stats,
          "train_result": result, "wall_s": wall, "leaf_max_change_by_epoch": moved,
          "launches": launches, "launches_one_epoch0_micro_step": one_step,
          "launches_one_epoch0_micro_step_tokens": 575 + longest,
          "batch_size": 1, "accumulation": 8, "peak_memory_gib": peak_gb,
          "kernel_ms_per_micro_step": split, "device_idle_share_steps_6_7": idle,
          "checkpoint_saves": saves, "language_model_bytes": llm_bytes, "disk_free_gb": free_gb,
          "timed_steps": "1-5 (0 warms up, 6-7 profiled)",
          "cut": "2 epochs of 16 random samples, 2 validation samples, 16 new tokens (a real "
                 "run: the VQA corpus, 5 epochs, 128 new tokens)"})
    return launches, one_step, trained


# ---------------------------------------------------------------------------- phase 10


def phase_stage2_end_to_end(cfg, params, kernel_counters):
    """One batch-1 stage-2 loss at the longest bucket and the gradient of every trainable
    leaf (tower, projector, LLM with its tied table) through the kernel path and the
    plain path, each bf16 gradient also against the plain path in fp32."""
    import torch
    import torch.nn.functional as F

    from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
    from projectiontrainer_tpu_torch.train import steps

    plain = plain_config(cfg)
    data = VQASamples(1, SEED + 11, size=cfg.vision.image_size, vocab=cfg.llm.vocab_size)
    batch = {"pixel_values": torch.tensor(data.pixels[:1], device=DEVICE),
             "question_ids": torch.tensor(data.questions[0][None], device=DEVICE),
             "answer_ids": torch.tensor(data.answers[0][None], device=DEVICE)}
    train = list(unique_leaves_with_paths(params))
    for _, x in train:
        x.requires_grad_(True)

    def run(c, compute_dtype=torch.bfloat16):
        for counter in kernel_counters.values():
            counter.reset()
        loss_fn = steps.stage2_loss(c, 0, logits_chunk=128, table_frozen=False,
                                    compute_dtype=compute_dtype, remat=True)
        loss, _ = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, [x for _, x in train])
        torch.cuda.synchronize()
        return float(loss.detach()), grads, {n: k.value for n, k in kernel_counters.items()}

    def cosine(a, b):
        return float(F.cosine_similarity(a.flatten().float(), b.flatten().float(), dim=0))

    loss_k, grads_k, launches_k = run(cfg)
    loss_p, grads_p, launches_p = run(plain)
    _, grads_f, _ = run(plain, None)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos, rounding, plain_to_fp32, key_bias = {}, {}, {}, [0.0, 0.0]
    for (path, _), a, b, f in zip(train, grads_k, grads_p, grads_f):
        a, b, f = a.float(), b.float(), f.float()
        if path.endswith("k_proj/bias"):  # zero in exact arithmetic: both sides are noise
            key_bias = [max(key_bias[0], float(a.norm())), max(key_bias[1], float(b.norm()))]
            continue
        gap = float((b - f).norm())
        # (cosine, whether plain bf16's distance to fp32 exceeds the gradient's norm)
        plain_to_fp32[path] = (cosine(b, f), gap > float(f.norm()))
        if path.startswith("llm/") and path.endswith(ROUNDING_LEAVES):
            rounding[path] = {"plain_cos_to_fp32": plain_to_fp32[path][0],
                              "kernel_cos_to_fp32": cosine(a, f),
                              "gap_ratio": float((a - f).norm()) / gap}
        else:
            cos[path] = cosine(a, b)
    del grads_k, grads_p, grads_f, a, b, f
    worst = min(cos, key=cos.get, default=None)
    worst_gap = max(rounding, key=lambda p: rounding[p]["gap_ratio"], default=None)
    lowest = sorted(rounding, key=lambda p: rounding[p]["plain_cos_to_fp32"])[:5]
    groups = ("vision", "projector", "llm")
    emit({"phase": 10, "batch_size": 1, "tokens": 575 + 128 + 512, "loss_kernel": loss_k,
          "loss_plain": loss_p, "loss_rel_diff": rel, "leaves_compared": len(cos),
          "min_grad_cosine": cos.get(worst), "min_grad_cosine_leaf": worst,
          "min_grad_cosine_by_group": {
              g: min((v for p, v in cos.items() if p.startswith(g + "/")), default=None)
              for g in groups},
          "lowest_grad_cosines": {p: cos[p] for p in sorted(cos, key=cos.get)[:5]},
          "plain_bf16_cos_to_fp32_quantiles_0_10_50_90": [
              float(np.quantile([c for c, _ in plain_to_fp32.values()], q))
              for q in (0, 0.1, 0.5, 0.9)],
          "plain_bf16_error_above_fp32_norm_by_group": {
              g: sum(p.startswith(g + "/") and over for p, (_, over) in plain_to_fp32.items())
              for g in groups},
          "rounding_leaves": len(rounding),
          "max_gap_ratio_to_fp32": rounding[worst_gap]["gap_ratio"] if rounding else None,
          "max_gap_ratio_leaf": worst_gap,
          "rounding_leaves_lowest_plain_cos_to_fp32": {p: rounding[p] for p in lowest},
          "table_grad_cosine": cos.get("llm/embed_tokens/embedding"),
          "key_bias_grad_norm_max_kernel_plain": key_bias, "launches_kernel_path": launches_k})
    step_kernels = [n for n in STAGE2_KERNELS if n != "decode_attn"]
    if not all(launches_k[n] for n in step_kernels) or any(launches_p.values()):
        raise AssertionError(f"stage 2 end to end: kernel path {launches_k}, plain {launches_p}")
    if not rel <= LOSS_REL:
        raise AssertionError(f"stage 2 end to end: loss {loss_k} vs plain {loss_p}")
    if worst is None or not cos[worst] >= COS_MIN:
        raise AssertionError(f"stage 2 end to end: gradient cosine {cos.get(worst)} of {worst} "
                             f"< {COS_MIN}")
    if rounding and not rounding[worst_gap]["gap_ratio"] <= ROUNDING_GAP:
        raise AssertionError(f"stage 2 end to end: {worst_gap}'s distance to fp32 is "
                             f"{rounding[worst_gap]['gap_ratio']:.4g} x plain bf16's "
                             f"> {ROUNDING_GAP}")
    if not key_bias[0] <= KEY_BIAS_NOISE * key_bias[1]:
        raise AssertionError(f"stage 2 end to end: key-projection bias gradient norm "
                             f"{key_bias[0]:.4g} > {KEY_BIAS_NOISE} x plain {key_bias[1]:.4g}")


# ---------------------------------------------------------------------------- phase 11

# (question bucket, answer bucket) of each group of 4 phase-11 samples: the plan batches
# by bucket, so 32 samples make 8 full micro-steps; the first group is the longest
# bucket, 575 + 256 + 1024 = 1855 tokens
QLORA_GROUPS = ((256, 1024), (32, 128), (64, 256), (128, 512), (256, 512), (32, 1024),
                (128, 128), (64, 1024))
_Q_FLOOR = {32: 8, 64: 33, 128: 65, 256: 129}
_A_FLOOR = {128: 32, 256: 129, 512: 257, 1024: 513}


def qlora_lengths(seed, groups=QLORA_GROUPS, per=4):
    """(question lengths, answer lengths): `per` samples inside each bucket pair of
    `groups` (questions of 8-256 ids, answers of 32-1024), the first at both maxima."""
    rng = np.random.default_rng(seed)
    q = np.concatenate([rng.integers(_Q_FLOOR[qb], qb + 1, size=per) for qb, _ in groups])
    a = np.concatenate([rng.integers(_A_FLOOR[ab], ab + 1, size=per) for _, ab in groups])
    q[0], a[0] = groups[0]
    return q, a


def qwen3_model(quant_method=None):
    """The stage-2 QLoRA VLM at full width from seeded random weights: SigLIP
    ViT-L/16-384 (bf16), projector 1024 -> 10240 -> 4096 (fp32), Qwen3-8B (36 layers,
    hidden 4096, MLP 12288, 32/8 heads of 128, vocab 151,936, untied head; bf16). The
    decoder is built one layer at a time and, with ``quant_method``, each layer is
    quantized before the next is drawn, so the dense 16 GB of projections is never
    resident whole. The same seed draws the same dense weights either way."""
    import torch

    from projectiontrainer_tpu_torch.models import decoder as dec
    from projectiontrainer_tpu_torch.models import projector as proj
    from projectiontrainer_tpu_torch.models import siglip, vlm
    from projectiontrainer_tpu_torch.ops import quant

    vision, llm_cfg = siglip.vit_l_16_384(), dec.qwen3_config()
    cfg = vlm.VLMConfig(vision=vision, llm=llm_cfg, projector=proj.ProjectorConfig(
        vision_dim=vision.hidden_size, llm_dim=llm_cfg.hidden_size))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = {"vision": siglip.init_vision(gen, cfg.vision, torch.bfloat16, DEVICE),
              "projector": proj.init(gen, cfg.projector, torch.float32, DEVICE)}
    llm = dec.init(gen, dataclasses.replace(cfg.llm, num_layers=0, layer_types=()),
                   torch.bfloat16, DEVICE)
    for _ in range(cfg.llm.num_layers):
        layer = dec.init_layer(gen, cfg.llm, torch.bfloat16, DEVICE)
        llm["layers"].append(layer if quant_method is None
                             else quant.quantize_layer(layer, method=quant_method))
    params["llm"] = llm
    return cfg, params


def fingerprint(x) -> int:
    """A position-weighted sum of a tensor's bytes (64-bit, on the card, in chunks):
    a change of any byte changes it."""
    import torch

    b = x.detach().contiguous().reshape(-1).view(torch.uint8)
    total, chunk = 0, 1 << 26
    for s in range(0, b.numel(), chunk):
        c = b[s:s + chunk].to(torch.int64)
        w = torch.arange(s, s + c.numel(), device=c.device, dtype=torch.int64) % 65521 + 1
        total += int((c * w).sum())
    return total


def _frozen_fingerprints(params):
    from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths

    return {p: fingerprint(x) for p, x in unique_leaves_with_paths(params)
            if not p.startswith("lora/")}


def phase_qlora_train(cfg, params, kernel_counters):
    """Stage2Trainer.train() with the reference's QLoRA recipe over Qwen3-8B; returns
    (launches, the trained params, a directory holding a copy of the adapter)."""
    import torch

    from projectiontrainer_tpu_torch.core.config import Stage2Config
    from projectiontrainer_tpu_torch.train.trainer_stage2 import Stage2Trainer

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_qlora_")
    adapter_dir = tempfile.mkdtemp(prefix="chip_smoke_adapter_")
    size, vocab = cfg.vision.image_size, cfg.llm.vocab_size
    try:
        tcfg = Stage2Config(
            output_dir=out_dir, batch_size=4, gradient_accumulation_steps=2, num_epochs=1,
            learning_rate=1e-5, warmup_ratio=0.05, grad_clip=1.0, remat="full",
            mixed_precision="bf16", enable_qlora=True, quant_method="nf4-mirror", lora_r=16,
            lora_alpha=32, lora_dropout=0.05, max_q_len=256, max_a_len=1024, img_size=size,
            eval_max_new_tokens=16, eval_num_beams=3, eval_do_sample=True, logging_steps=1,
            num_workers=2, device=DEVICE, disable_wandb=True, seed=SEED,
            profile_dir=os.path.join(out_dir, "profile"), profile_start_step=6,
            profile_num_steps=2)
        train_data = VQASamples(32, SEED + 12, size=size, vocab=vocab,
                                lengths=qlora_lengths(SEED + 12))
        val_data = VQASamples(2, SEED + 13, size=size, vocab=vocab,
                              lengths=([40, 60], [200, 240]))
        frozen = _frozen_fingerprints(params)
        trainer = Stage2Trainer(tcfg, vlm_cfg=cfg, params=params, tokenizer=StubTokenizer(),
                                train_dataset=train_data, val_dataset=val_data)
        del params
        if len(trainer._train_plans[0]) != 8:
            raise AssertionError(f"QLoRA: {len(trainer._train_plans[0])} micro-steps planned")
        for c in kernel_counters.values():
            c.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = {name: c.value for name, c in kernel_counters.items()}
        trained = trainer.state["params"]
        del trainer
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        lm = os.path.join(out_dir, "checkpoint-epoch_0", "language_model")
        written = sorted(os.listdir(lm))
        shutil.copytree(lm, adapter_dir, dirs_exist_ok=True)
        adapter_bytes = os.path.getsize(os.path.join(lm, "adapter_model.safetensors"))
        examples = os.listdir(os.path.join(out_dir, "validation_examples"))
        traced = os.listdir(os.path.join(out_dir, "profile"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    losses = [r["train/step_loss"] for r in rows if "train/step_loss" in r]
    if len(losses) != 8 or not np.isfinite(losses).all():
        raise AssertionError(f"QLoRA: expected 8 finite losses, got {losses}")
    b_still_zero = [f"{i}/{t}" for i, layer in enumerate(trained["lora"]["layers"])
                    for t, p in layer.items() if not bool(p["b"].ne(0).any())]
    if b_still_zero:
        raise AssertionError(f"QLoRA: lora B still zero at {b_still_zero[:5]}")
    changed = [p for p, h in _frozen_fingerprints(trained).items() if frozen[p] != h]
    if changed or set(frozen) != set(_frozen_fingerprints(trained)):
        raise AssertionError(f"QLoRA: frozen leaves changed: {changed[:5]}")
    if not all(launches[n] for n in STAGE2_QLORA_KERNELS):
        raise AssertionError(f"QLoRA: a kernel of the path never launched: {launches}")
    if written != ["adapter_config.json", "adapter_model.safetensors"]:
        raise AssertionError(f"QLoRA: language_model/ holds {written}")
    if examples != ["epoch_0_examples.txt"]:
        raise AssertionError(f"QLoRA: validation examples {examples}")
    step6 = next((r for r in rows if r.get("step") == 6 and "step_time_ms" in r), {})
    stats = {"images_per_sec": step6.get("images_per_sec"),
             "micro_step_ms": step6.get("step_time_ms")}
    if not all(stats.values()):
        raise AssertionError(f"QLoRA: no throughput measured for steps 1-5: {rows[:8]}")
    split = {k[len("profile/"):]: v for r in rows for k, v in r.items()
             if k.startswith("profile/")}
    pieces = ("tower_fwd", "projector_fwd", "decoder_fwd", "decoder_bwd", "lm_head_ce_fwd",
              "lm_head_ce_bwd", "optimizer_fwd", "decoder/dequant_fwd", "decoder/dequant_bwd")
    if traced != ["trace_step6.json"] or not all(split.get(f"{p}_ms", 0) > 0 for p in pieces):
        raise AssertionError(f"QLoRA: no kernel time traced for a piece of the step: {split}")
    dequant = split["decoder/dequant_fwd_ms"] + split["decoder/dequant_bwd_ms"]
    idle = 1 - split["total_ms"] / stats["micro_step_ms"]
    print(f"stage 2 QLoRA (Qwen3-8B, nf4-mirror): {stats['images_per_sec']:.3f} images/s, "
          f"{stats['micro_step_ms']:.1f} ms a micro-step (steps 1-5, batch 4, up to 1855 "
          f"tokens); kernel time {split['total_ms']:.1f} ms a micro-step in steps 6-7, "
          f"dequant {dequant:.1f} ms ({dequant / split['total_ms']:.1%}), device idle "
          f"{idle:.1%}; peak {peak_gb:.1f} GiB; adapter {adapter_bytes / 1e6:.1f} MB", flush=True)
    emit({"phase": 11, "micro_steps": len(losses), "losses": losses, **stats,
          "train_result": result, "wall_s": wall, "launches": launches, "batch_size": 4,
          "accumulation": 2, "peak_memory_gib": peak_gb, "kernel_ms_per_micro_step": split,
          "dequant_ms_per_micro_step": dequant, "dequant_share": dequant / split["total_ms"],
          "device_idle_share_steps_6_7": idle, "adapter_bytes": adapter_bytes,
          "frozen_leaves_checked": len(frozen), "timed_steps": "1-5 (0 warms up, 6-7 profiled)",
          "cut": "8 micro-steps of 32 random samples, 2 validation samples, 16 new tokens (a "
                 "real run: the VQA corpus, 3 epochs, accumulation 8)"})
    return launches, trained, adapter_dir


# ---------------------------------------------------------------------------- phase 12


def phase_qlora_end_to_end(cfg, params, kernel_counters):
    """Batch 1 at the longest bucket (1855 tokens), dropout off, an adapter whose B is
    drawn at std 0.02 over phase 11's quantized base: the loss and every LoRA leaf's
    gradient through the kernel path against the plain path (plain attention and
    LayerNorm, chunked CE); then the merged decoder against the unmerged forward."""
    import torch
    import torch.nn.functional as F

    from projectiontrainer_tpu_torch.core import dtypes
    from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths
    from projectiontrainer_tpu_torch.models import vlm
    from projectiontrainer_tpu_torch.train import lora, steps

    plain = plain_config(cfg)
    lcfg = lora.LoraConfig(r=16, alpha=32, dropout=0.0)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    adapters = lora.init(gen, cfg.llm, lcfg, device=DEVICE)
    for layer in adapters["layers"]:
        for p in layer.values():
            p["b"].normal_(0.0, 0.02, generator=gen)  # B = 0 would zero every A gradient
    params = {**params, "lora": adapters}
    data = VQASamples(1, SEED + 15, size=cfg.vision.image_size, vocab=cfg.llm.vocab_size,
                      lengths=([256], [1024]))
    batch = {"pixel_values": torch.tensor(data.pixels[:1], device=DEVICE),
             "question_ids": torch.tensor(data.questions[0][None], device=DEVICE),
             "answer_ids": torch.tensor(data.answers[0][None], device=DEVICE)}
    train = list(leaves_with_paths(adapters))
    for _, x in train:
        x.requires_grad_(True)

    def run(c, ce_impl, compute_dtype=torch.bfloat16):
        for counter in kernel_counters.values():
            counter.reset()
        loss_fn = steps.stage2_loss(c, 0, lora_cfg=lcfg, logits_chunk=128, ce_impl=ce_impl,
                                    compute_dtype=compute_dtype, remat=True)
        loss, _ = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, [x for _, x in train])
        torch.cuda.synchronize()
        return (float(loss.detach()), [g.float() for g in grads],
                {n: k.value for n, k in kernel_counters.items()})

    def cosine(a, b):
        return float(F.cosine_similarity(a.flatten(), b.flatten(), dim=0))

    loss_k, grads_k, launches_k = run(cfg, "auto")
    loss_p, grads_p, launches_p = run(plain, "chunked")
    _, grads_f, _ = run(plain, "chunked", torch.float32)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    # each leaf against plain bf16; where the two bf16 paths differ by more than 0.001
    # (each is ~0.9995 from fp32 at random weights, the A gradients down to 0.998: a sum
    # over 1855 tokens of nearly cancelling terms), the kernel path's distance to the
    # plain fp32 gradient over plain bf16's (ROUNDING_GAP, PR 8's rule)
    cos, gap, plain_to_fp32 = {}, {}, {}
    for (p, _), a, b, f in zip(train, grads_k, grads_p, grads_f):
        cos[p] = cosine(a, b)
        plain_to_fp32[p] = cosine(b, f)
        gap[p] = float((a - f).norm() / (b - f).norm())
    del grads_k, grads_p, grads_f
    for _, x in train:
        x.requires_grad_(False)
    by_gap = [p for p in cos if cos[p] < COS_MIN]

    # the merged decoder (the quantized base dequantized to bf16 + B A) against the
    # unmerged forward, at the last position of a [visual; question] prefix of 4 rows
    rng = np.random.default_rng(SEED + 16)
    size = cfg.vision.image_size
    pixels = torch.tensor(np.clip(rng.standard_normal((4, size, size, 3), dtype=np.float32),
                                  -1, 1), device=DEVICE)
    q_ids = np.zeros((4, 256), np.int64)
    for i, n in enumerate((256, 200, 90, 17)):  # left-padded
        q_ids[i, 256 - n:] = rng.integers(2, cfg.llm.vocab_size, size=n)
    with torch.no_grad():
        compute = dtypes.cast_compute_params(params, torch.bfloat16)
        embeds, mask = vlm.question_prefix(compute, cfg, pixels, torch.tensor(q_ids, device=DEVICE),
                                           pad_token_id=0)
        unmerged = vlm.forward_logits(compute, cfg, embeds, mask, lora_cfg=lcfg)[:, -1]
        merged_llm = lora.merge_into_decoder(compute["llm"], adapters, lcfg)
        merged = vlm.forward_logits({**compute, "llm": merged_llm}, cfg, embeds, mask)[:, -1]
        del merged_llm, compute
        row_cos = F.cosine_similarity(merged.float(), unmerged.float(), dim=-1).tolist()
        top1 = (merged.argmax(-1) == unmerged.argmax(-1)).float().mean().item()
    worst = min(cos, key=cos.get)
    worst_gap = max(by_gap, key=gap.get, default=None)
    emit({"phase": 12, "batch_size": 1, "tokens": 575 + 256 + 1024, "loss_kernel": loss_k,
          "loss_plain": loss_p, "loss_rel_diff": rel, "leaves_compared": len(cos),
          "min_grad_cosine": cos[worst], "min_grad_cosine_leaf": worst,
          "lowest_grad_cosines": {p: cos[p] for p in sorted(cos, key=cos.get)[:5]},
          "plain_bf16_cos_to_fp32_quantiles_0_10_50": [
              float(np.quantile(list(plain_to_fp32.values()), q)) for q in (0, 0.1, 0.5)],
          "leaves_held_by_gap": len(by_gap),
          "max_gap_ratio_to_fp32": None if worst_gap is None else gap[worst_gap],
          "max_gap_ratio_leaf": worst_gap,
          "held_by_gap": {p: {"cos_plain_bf16": cos[p], "plain_cos_to_fp32": plain_to_fp32[p],
                              "gap_ratio": gap[p]} for p in sorted(by_gap, key=cos.get)[:8]},
          "merged_vs_unmerged_row_cosine": row_cos, "merged_vs_unmerged_top1": top1,
          "launches_kernel_path": launches_k})
    step_kernels = [n for n in STAGE2_QLORA_KERNELS if n != "decode_attn"]
    if not all(launches_k[n] for n in step_kernels) or any(launches_p.values()):
        raise AssertionError(f"QLoRA end to end: kernel path {launches_k}, plain {launches_p}")
    if not rel <= LOSS_REL:
        raise AssertionError(f"QLoRA end to end: loss {loss_k} vs plain {loss_p}")
    if worst_gap is not None and not gap[worst_gap] <= ROUNDING_GAP:
        raise AssertionError(f"QLoRA end to end: {worst_gap}'s gradient cosine {cos[worst_gap]} "
                             f"< {COS_MIN} and its distance to fp32 {gap[worst_gap]:.4g} x "
                             f"plain bf16's > {ROUNDING_GAP}")
    if not min(row_cos) >= 0.99:
        raise AssertionError(f"QLoRA end to end: merged against unmerged logits, row cosines "
                             f"{row_cos} (< 0.99)")


# ---------------------------------------------------------------------------- phase 14

CLS_KERNELS = ("flash_attn_fwd", "layernorm_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq",
               "layernorm_bwd")
# the default grid's EXP1 (eval/sweep.py:DEFAULT_EXPERIMENT_GRID)
CLS_CLASSES = "No Finding,Atelectasis,Cardiomegaly,Effusion"
# the class-shared biases move every class's logit alike: their gradient is zero in
# exact arithmetic (the CE's gradient over the classes sums to 0), as a key bias's is
CLS_ZERO_SUM = ("vision/post_layernorm/bias", "mha/v_proj/bias", "mha/out_proj/bias",
                "head/bias")


class ClsSamples:
    """In-memory cls samples: seeded pixels in [-1, 1] (made once, in bulk) and a class
    index each; no image files."""

    def __init__(self, n, seed, *, size, n_classes):
        rng = np.random.default_rng(seed)
        self.pixels = np.clip(rng.standard_normal((n, size, size, 3), dtype=np.float32), -1, 1)
        self.targets = rng.integers(0, n_classes, size=n).astype(np.int32)

    def __len__(self):
        return len(self.targets)

    def __getitem__(self, i):
        return {"pixel_values": self.pixels[i], "target_indices": self.targets[i]}


def cls_model():
    """The probe over XraySigLIP__vit-l-16-siglip-384__webli's tower (ViT-L/16-384, its
    MAP head kept as a snapshot carries it) and EXP1's 4 classes; fp32 masters."""
    import torch

    from projectiontrainer_tpu_torch.models import classifier, siglip

    cfg = classifier.ClassifierConfig(vision=siglip.vit_l_16_384(),
                                      num_classes=len(CLS_CLASSES.split(",")))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return cfg, classifier.init(gen, cfg, device="cuda")


def _cls_fingerprints(params):
    """Fingerprints of every leaf but the tower's unused MAP head (decay alone moves
    it, by a few ulps)."""
    from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths

    return {p: fingerprint(x) for p, x in leaves_with_paths(params)
            if not p.startswith("vision/head/")}


def _zero_sum(path) -> bool:
    """A leaf whose gradient is zero in exact arithmetic: a zero-initialised one may
    never move, so moves are required of the others only."""
    return path.endswith("k_proj/bias") or path in CLS_ZERO_SUM


def phase_cls_train(cfg, params, kernel_counters):
    import torch

    from projectiontrainer_tpu_torch.core import dtypes
    from projectiontrainer_tpu_torch.core.config import ClsConfig
    from projectiontrainer_tpu_torch.train import trainer_cls

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_cls_")
    size, n_cls = cfg.vision.image_size, cfg.num_classes
    try:
        tcfg = ClsConfig(exp_id="EXP1", class_names=CLS_CLASSES, freeze_mode="1EpochUnfreeze",
                         output_base_dir=out_dir, batch_size=32, epochs=2, logging_steps=1,
                         num_workers=4, device=DEVICE, seed=SEED, img_size=size,
                         profile_dir=os.path.join(out_dir, "profile"), profile_start_step=3,
                         profile_num_steps=2)
        val = ClsSamples(32, SEED + 10, size=size, n_classes=n_cls)
        trainer = trainer_cls.ClsTrainer(
            tcfg, model_cfg=cfg, params=params, val_dataset=val,
            train_dataset=ClsSamples(6 * 32, SEED + 9, size=size, n_classes=n_cls))
        prints = [_cls_fingerprints(params)]
        step_fn, tx, schedule = trainer._steps[True]  # the frozen-tower variant, epoch 1

        def first_frozen_step(state, batch, rng):
            if len(prints) == 1:  # the params as epoch 0 left them
                prints.append(_cls_fingerprints(state["params"]))
            return step_fn(state, batch, rng)

        trainer._steps[True] = (first_frozen_step, tx, schedule)
        for c in kernel_counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: c.value for name, c in kernel_counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        prints.append(_cls_fingerprints(params))
        exp_dir = trainer.exp_dir
        with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        with open(trainer.results_tsv) as f:
            tsv = f.read().strip().splitlines()
        ckpt_dir = os.path.join(exp_dir, "checkpoints")
        ckpt_bytes = {n: os.path.getsize(os.path.join(ckpt_dir, n))
                      for n in sorted(os.listdir(ckpt_dir)) if n.endswith(".pt")}
        traced = os.listdir(os.path.join(out_dir, "profile"))
        best_epoch = trainer.ckpt.metadata("best")["epoch"]
        del trainer
        gc_cuda()
        # cls_test's evaluation: the classifier rebuilt from the best checkpoint alone
        t1 = time.perf_counter()
        ccfg, model_cfg, restored = trainer_cls.load_classifier(exp_dir, "best", device=DEVICE)
        logits, targets = trainer_cls.predict(
            restored, model_cfg, val, batch_size=32, device=DEVICE,
            compute_dtype=dtypes.compute_dtype(ccfg.mixed_precision))
        restored_metrics = trainer_cls.classification_metrics(logits, targets)
        restore_s = time.perf_counter() - t1
        del restored
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    losses = [r["train/batch_loss"] for r in rows if "train/batch_loss" in r]
    epochs = {int(r["epoch"]): r for r in rows if "train/epoch_loss" in r}
    start, at_swap, end = prints
    tower = [p for p in start if p.startswith("vision/")]
    head = [p for p in start if not p.startswith("vision/") and not _zero_sum(p)]
    must_move = [p for p in tower if not _zero_sum(p)]
    tower_moved_e0 = sum(start[p] != at_swap[p] for p in must_move)
    tower_moved_e1 = sum(at_swap[p] != end[p] for p in tower)
    head_moved = [sum(a[p] != b[p] for p in head) for a, b in ((start, at_swap), (at_swap, end))]
    trained = tuple(epochs[best_epoch][k] for k in ("val/loss", "val/accuracy", "val/auc"))
    if len(losses) != 12 or not np.isfinite(losses).all():
        raise AssertionError(f"cls: expected 12 finite losses, got {losses}")
    if tower_moved_e0 != len(must_move) or tower_moved_e1:
        raise AssertionError(f"cls: tower leaves moved {tower_moved_e0} of {len(must_move)} in "
                             f"epoch 0 (all expected), {tower_moved_e1} of {len(tower)} in "
                             f"epoch 1 (none expected)")
    if head_moved != [len(head)] * 2:
        raise AssertionError(f"cls: head leaves moved {head_moved} of {len(head)} per epoch")
    if len(tsv) != 3 or not tsv[0].startswith("Epoch\tTrain Loss"):
        raise AssertionError(f"cls: results.tsv holds {tsv}")
    if not all(launches[n] for n in CLS_KERNELS):
        raise AssertionError(f"cls: a kernel of the path never launched: {launches}")
    if (restored_metrics[1:] != trained[1:]
            or not abs(restored_metrics[0] - trained[0]) <= 1e-6 * abs(trained[0])):
        raise AssertionError(f"cls: the best checkpoint evaluated alone gives (loss, acc, auc) "
                             f"{restored_metrics}, the trainer logged {trained}")
    per_epoch = result["epochs"]
    if not all(e.get("images_per_sec") for e in per_epoch):
        raise AssertionError(f"cls: no throughput measured: {per_epoch}")
    split = {k[len("profile/"):]: v for r in rows for k, v in r.items()
             if k.startswith("profile/")}
    pieces = ("vision_fwd", "vision_bwd", "head_fwd", "head_bwd", "loss_fwd", "optimizer_fwd")
    if traced != ["trace_step3.json"] or not all(split.get(f"{p}_ms", 0) > 0 for p in pieces):
        raise AssertionError(f"cls: no kernel time traced for a piece of the step: {split}")
    idle = 1 - split["total_ms"] / per_epoch[0]["step_time_ms"]
    print(f"cls: epoch 0 (tower trained) {per_epoch[0]['images_per_sec']:.2f} images/s, "
          f"{per_epoch[0]['step_time_ms']:.1f} ms/step; epoch 1 (tower frozen) "
          f"{per_epoch[1]['images_per_sec']:.2f} images/s, {per_epoch[1]['step_time_ms']:.1f} "
          f"ms/step at batch 32 x {size} px; epoch-0 kernel time "
          f"{split['total_ms']:.1f} ms/step (device idle {idle:.1%})", flush=True)
    emit({"phase": 14, "steps": len(losses), "losses": losses, "per_epoch": per_epoch,
          "wall_s": wall, "launches": launches, "batch_size": 32, "image_size": size,
          "peak_memory_gib": peak_gb, "kernel_ms_per_step_epoch0": split,
          "device_idle_share_epoch0": idle, "results_tsv": tsv,
          "tower_leaves_moved_epoch0_of": [tower_moved_e0, len(must_move)],
          "tower_leaves_moved_epoch1_of": [tower_moved_e1, len(tower)],
          "head_leaves_moved_per_epoch_of": [*head_moved, len(head)],
          "checkpoint_bytes": ckpt_bytes, "best_epoch": best_epoch,
          "val_trainer_loss_acc_auc": trained, "val_restored_loss_acc_auc": restored_metrics,
          "restore_and_eval_s": restore_s,
          "timed_steps": "epoch 0: 1, 2, 5 (0 warms up, 3-4 profiled); epoch 1: 1-5",
          "cut": "2 epochs of 6 steps on random weights and data, 32 validation samples "
                 "(a real run: the labelled corpus, 10 epochs)"})
    return launches


def gc_cuda():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------- phase 15


def phase_cls_end_to_end(cfg, params, kernel_counters):
    """One batch-8 loss and the gradient of every trainable leaf (tower and head; the
    unused MAP head has none) through the kernel path against the plain path in bf16,
    and the plain path in fp32 for the leaves below COS_MIN (PR 8's distance rule)."""
    import torch
    import torch.nn.functional as F

    from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths
    from projectiontrainer_tpu_torch.train import masks, steps

    plain = plain_config(cfg)
    data = ClsSamples(8, SEED + 11, size=cfg.vision.image_size, n_classes=cfg.num_classes)
    batch = {"pixel_values": torch.tensor(data.pixels, device=DEVICE),
             "target_indices": torch.tensor(data.targets, device=DEVICE)}
    train = [(p, x) for p, x in leaves_with_paths(params) if not p.startswith("vision/head/")]
    for p, x in leaves_with_paths(params):
        x.requires_grad_(not p.startswith("vision/head/"))

    def run(c, dtype):
        for counter in kernel_counters.values():
            counter.reset()
        loss, _ = steps.classifier_loss(c, compute_dtype=dtype)(params, batch)
        grads = torch.autograd.grad(loss, [x for _, x in train])
        torch.cuda.synchronize()
        return float(loss.detach()), grads, {n: k.value for n, k in kernel_counters.items()}

    loss_k, grads_k, launches_k = run(cfg, torch.bfloat16)
    loss_p, grads_p, launches_p = run(plain, torch.bfloat16)
    _, grads_f, _ = run(plain, None)  # fp32 masters, computed in fp32
    for _, x in leaves_with_paths(params):
        x.requires_grad_(False)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    def cosine(a, b):
        return float(F.cosine_similarity(a.flatten().float(), b.flatten().float(), dim=0))

    # at random weights the probe's gradients are sums of nearly cancelling terms (the
    # classes' attended queries differ little, and the CE's gradient over the classes
    # sums to 0), so each bf16 path's own rounding shows: both paths' cosines to fp32
    # are printed beside the cosine between them
    cos, gap, to_fp32, noise = {}, {}, {"kernel": [], "plain": []}, [0.0, 0.0]
    for (path, _), a, b, f in zip(train, grads_k, grads_p, grads_f):
        if _zero_sum(path):
            noise = [max(noise[0], float(a.float().norm())), max(noise[1], float(b.float().norm()))]
            continue
        cos[path] = cosine(a, b)
        to_fp32["kernel"].append(cosine(a, f))
        to_fp32["plain"].append(cosine(b, f))
        if cos[path] < COS_MIN:
            gap[path] = float((a.float() - f).norm() / (b.float() - f).norm())
    del grads_k, grads_p, grads_f
    worst = min(cos, key=cos.get)
    worst_gap = max(gap, key=gap.get, default=None)
    emit({"phase": 15, "batch_size": 8, "loss_kernel": loss_k, "loss_plain": loss_p,
          "loss_rel_diff": rel, "leaves_compared": len(cos), "min_grad_cosine": cos[worst],
          "min_grad_cosine_leaf": worst,
          "lowest_grad_cosines": {p: cos[p] for p in sorted(cos, key=cos.get)[:5]},
          "cos_to_fp32_quantiles_0_10_50": {
              k: [float(np.quantile(v, q)) for q in (0, 0.1, 0.5)] for k, v in to_fp32.items()},
          "leaves_held_by_gap": len(gap),
          "gap_ratio_quantiles_50_90_100": [float(np.quantile(list(gap.values()), q))
                                            for q in (0.5, 0.9, 1.0)] if gap else None,
          "max_gap_ratio_leaf": worst_gap,
          "zero_sum_grad_norm_max_kernel_plain": noise, "launches_kernel_path": launches_k})
    if not all(launches_k[n] for n in CLS_KERNELS) or any(launches_p.values()):
        raise AssertionError(f"cls end to end: kernel path {launches_k}, plain {launches_p}")
    if not rel <= LOSS_REL:
        raise AssertionError(f"cls end to end: loss {loss_k} vs plain {loss_p}")
    if worst_gap is not None and not gap[worst_gap] <= ROUNDING_GAP:
        raise AssertionError(f"cls end to end: {worst_gap}'s gradient cosine {cos[worst_gap]} < "
                             f"{COS_MIN} and its distance to fp32 {gap[worst_gap]:.4g} x plain "
                             f"bf16's > {ROUNDING_GAP}")
    if not noise[0] <= KEY_BIAS_NOISE * noise[1]:
        raise AssertionError(f"cls end to end: zero-sum bias gradient norm {noise[0]:.4g} > "
                             f"{KEY_BIAS_NOISE} x plain {noise[1]:.4g}")


# ---------------------------------------------------------------------------- phase 16

FEED_SOURCES = 256        # seeded 1024 x 1024 CXR-like JPEG files
FEED_SOURCES_2048 = 32    # and 2048 x 2048 ones, for one row
FEED_ROW_IMAGES = 128     # images each feed-alone row reads (8 batches of 16)
FEED_ROW_REPEATS = 3      # times each row is timed; its median and its spread are kept
FEED_CLASSES = ("pneumonia", "edema", "cardiomegaly", "no finding")
# what the feed must deliver (PERF.md section 5, NVIDIA H100 80GB HBM3 at 700 W): stage 0
# at batch 16 asks 63 images/s at its host step (253.0 ms) and 104 at its kernel time
# (153.82 ms); the cls probe's frozen epoch read 606-735 images/s
STAGE0_DEMAND = (63, 104)
CLS_FROZEN_DEMAND = (606, 735)


class FileTokenizer(StubTokenizer):
    """The stub tokenizer, also for one caption string (the datasets' call)."""

    def __call__(self, texts, **kw):
        if isinstance(texts, str):
            return {"input_ids": super().__call__([texts], **kw)["input_ids"][0]}
        return super().__call__(texts, **kw)


def cxr_base(size):
    """The shared picture of the CXR-like images: a bright body ellipse, two dark lung
    fields and ribs, [size, size] fp32 gray levels."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    body = np.exp(-(((y - 0.5) / 0.48) ** 2 + ((x - 0.5) / 0.42) ** 2) ** 2)
    lungs = sum(np.exp(-(((y - 0.45) / 0.25) ** 2 + ((x - side) / 0.12) ** 2))
                for side in (0.33, 0.67))
    return 40 + 170 * body - 90 * lungs + 2.0 * np.sin(y * 60.0 + np.sin(x * 3.0)) * body


def cxr_gray(base, seed):
    """One seeded CXR-like uint8 gray image: ``base`` shifted, plus noise."""
    size = base.shape[0]
    rng = np.random.default_rng(seed)
    img = np.roll(base, tuple(rng.integers(-size // 16, size // 16, 2)), axis=(0, 1))
    img = img + rng.normal(0, 6, (size, size)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_cxr_sources(directory, n, size, seed):
    """``n`` seeded CXR-like gray JPEGs of ``size`` x ``size`` stored as RGB (a bright
    body ellipse, two dark lung fields, ribs, per-image noise and offset) and a
    manifest of FEED_CLASSES captions; returns the manifest's samples."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    base = cxr_base(size)

    def one(i):
        name = f"cxr_{size}_{i}.jpg"
        Image.fromarray(cxr_gray(base, seed + i)).convert("RGB").save(
            os.path.join(directory, name), quality=90)
        return {"image": name, "normal_caption": FEED_CLASSES[i % len(FEED_CLASSES)]}

    with ThreadPoolExecutor(max_workers=len(os.sched_getaffinity(0))) as pool:
        return list(pool.map(one, range(n)))


def feed_environment():
    import importlib.util

    from projectiontrainer_tpu_torch.data import feeder

    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60)
    siblings = "/sys/devices/system/cpu/cpu0/topology/thread_siblings_list"
    try:
        with open(siblings) as f:  # "0,4" or "0-1": two hardware threads share a core
            threads_per_core = sum(len(range(int(a), int(b) + 1)) if b else 1 for a, _, b in
                                   (part.partition("-") for part in f.read().strip().split(",")))
    except OSError:
        threads_per_core = None
    return {"threads_per_core": threads_per_core,"PIL": importlib.util.find_spec("PIL") is not None,
            "cv2": importlib.util.find_spec("cv2") is not None,
            "scipy": importlib.util.find_spec("scipy") is not None,
            "gxx": gxx.stdout.splitlines()[0] if gxx.returncode == 0 else None,
            "cpus": len(os.sched_getaffinity(0)), "shm_free_bytes": feeder.shm_free_bytes()}


def compute_apps() -> list:
    """The processes ``nvidia-smi`` lists on the card."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def maps_libcuda(pid) -> bool:
    with open(f"/proc/{pid}/maps") as f:
        return "libcuda" in f.read()


def feed_row(make, samples, *, size, augment, threads=0, procs=0, omp_threads=None):
    """images/s of ``epoch_batches`` (batch 16, onto the card) over ``samples``, timed
    FEED_ROW_REPEATS times in a row: the thread feed on ``threads`` threads, or the
    process feeder on ``procs`` workers at OMP_NUM_THREADS ``omp_threads`` (None:
    OpenMP's default; set through ``feeder.WORKER_OMP_THREADS``), its pool made and
    warmed on 2 x procs samples first (spawning is not timed)."""
    import torch

    from projectiontrainer_tpu_torch.data import feeder, pipeline

    saved = feeder.WORKER_OMP_THREADS
    feeder.WORKER_OMP_THREADS = omp_threads
    try:
        if procs:
            warm = samples[:2 * procs]
            list(feeder.map_samples_processes(make(warm, size, augment), range(len(warm)),
                                              feeder.get_pool(size, procs)))
        rates = []
        for _ in range(FEED_ROW_REPEATS):
            ds = make(samples, size, augment)
            n = 0
            t0 = time.perf_counter()
            for batch in pipeline.epoch_batches(ds, batch_size=16, epoch=0, device=DEVICE,
                                                seed=SEED, num_workers=threads,
                                                num_procs=procs):
                n += batch["pixel_values"].shape[0]
            torch.cuda.synchronize()
            rates.append(n / (time.perf_counter() - t0))
            if ds.n_invalid:
                raise AssertionError(f"feed: {ds.n_invalid} invalid samples from generated "
                                     "files")
    finally:
        feeder.WORKER_OMP_THREADS = saved
    return {"path": f"procs {procs}" if procs else f"threads {threads}", "size": size,
            "augment": augment, "omp_threads": omp_threads if procs else None,
            "images": n, "images_per_sec": float(np.median(rates)),
            "images_per_sec_runs": rates}


def phase_feed(cfg, params, kernel_counters, stage0_stats):
    """Phase 16: the input feed from JPEG files, alone and under stage-0 training."""
    from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths
    from projectiontrainer_tpu_torch.data import datasets, feeder

    for _, x in leaves_with_paths(params):  # as phase 7 found them (phase 8 set some)
        x.requires_grad_(False)
    env = feed_environment()
    emit({"phase": 16, "environment": env})
    if not env["PIL"]:
        raise RuntimeError("phase 16: no Pillow on this machine, so no JPEG can be written "
                           "or decoded")
    root = tempfile.mkdtemp(prefix="chip_smoke_feed_")

    class Counting(datasets.ContrastiveDataset):
        """The stage-0 dataset, counting the invalid placeholders it hands out."""

        n_invalid = 0

        def _invalid(self):
            self.n_invalid += 1
            return super()._invalid()

    def make(samples, size, augment):
        return Counting(samples, image_root=root, tokenizer=FileTokenizer(), image_size=size,
                        max_text_len=cfg.text.max_position_embeddings, augment=augment,
                        seed=SEED)

    try:
        t0 = time.perf_counter()
        samples = write_cxr_sources(root, FEED_SOURCES, 1024, SEED)
        big = write_cxr_sources(root, FEED_SOURCES_2048, 2048, SEED + 1000)
        write_s = time.perf_counter() - t0
        rows_in = samples[:FEED_ROW_IMAGES]
        cpus = env["cpus"]
        ns = sorted({1, 4, cpus})
        rows = [feed_row(make, rows_in, size=512, augment=a, threads=8) for a in (False, True)]
        for n in ns:
            for augment in (False, True):
                rows.append(feed_row(make, rows_in, size=512, augment=augment, procs=n))
            rows.append(feed_row(make, rows_in, size=512, augment=True, procs=n, omp_threads=1))
            feeder.close_pools()
        aug_rows = [r for r in rows if r["augment"] and r["path"].startswith("procs")]
        best = max(aug_rows, key=lambda r: r["images_per_sec"])
        best_n = int(best["path"].split()[1])
        omp_faster = {n: max((r for r in aug_rows if r["path"] == f"procs {n}"),
                             key=lambda r: r["images_per_sec"])["omp_threads"] for n in ns}
        rows.append(feed_row(make, rows_in, size=384, augment=False, threads=8))
        rows.append(feed_row(make, rows_in, size=384, augment=False, procs=best_n,
                             omp_threads=best["omp_threads"]))
        rows.append(feed_row(make, big, size=512, augment=True, procs=best_n,
                             omp_threads=best["omp_threads"]))
        rows[-1]["source_px"] = 2048
        feeder.close_pools()
        for r in rows:
            demand = CLS_FROZEN_DEMAND if r["size"] == 384 else STAGE0_DEMAND
            print(f"feed {r['path']:>10} {r['size']} px from {r.get('source_px', 1024)} px, "
                  f"augment {'on ' if r['augment'] else 'off'}, OMP threads "
                  f"{r['omp_threads'] or 'default'}: {r['images_per_sec']:8.1f} images/s, "
                  f"median of {min(r['images_per_sec_runs']):.1f}-"
                  f"{max(r['images_per_sec_runs']):.1f} (demand {demand[0]}-{demand[1]})",
                  flush=True)
        emit({"phase": 16, "feed_rows": rows, "sources_written_s": write_s,
              "best_procs": best_n, "faster_omp_threads_by_procs": omp_faster,
              "omp_default_in_feeder": feeder.WORKER_OMP_THREADS})

        # (b) stage-0 training from the files, augmentation on: the process feeder at the
        # best N (the feeder's OpenMP setting) is the path whose launches count; then
        # the thread feed for comparison
        for c in kernel_counters.values():
            c.reset()
        procs_run = train_from_files(cfg, params, make, samples, procs=best_n,
                                     out_dir=os.path.join(root, "procs"))
        launches = {name: c.value for name, c in kernel_counters.items()}
        threads_run = train_from_files(cfg, params, make, samples, procs=0,
                                       out_dir=os.path.join(root, "threads"))
    finally:
        feeder.close_pools()
        shutil.rmtree(root, ignore_errors=True)
    if not all(launches[n] for n in STAGE0_KERNELS):
        raise AssertionError(f"stage 0 from files: a kernel of the path never launched: "
                             f"{launches}")
    ref = stage0_stats or {}
    for run in (procs_run, threads_run):
        print(f"stage 0 from files ({run['feed']}): {run['images_per_sec']:.3f} images/s, "
              f"{run['step_time_ms']:.1f} ms/step, kernel time {run['kernel_ms']:.1f} ms/step "
              f"(device idle {run['device_idle_share']:.1%}); in memory (phase 7): "
              f"{ref.get('images_per_sec')} images/s, {ref.get('step_time_ms')} ms/step, "
              f"idle {ref.get('device_idle_share')}", flush=True)
    emit({"phase": 16, **procs_run, "launches": launches, "thread_feed": threads_run,
          "in_memory_phase7": ref, "timed_steps": "1-5 (0 warms up, 6-7 profiled)",
          "cut": "8 steps of 128 generated files, validation on 16 (a real run: the caption "
                 "corpus, many epochs)"})
    return launches


def train_from_files(cfg, params, make, samples, *, procs, out_dir):
    """Stage0Trainer.train() as phase 7 runs it, fed from 128 of the files with online
    augmentation on ``procs`` feeder workers (0: 8 threads), validated on 16 others;
    checks it and returns its numbers."""
    import torch

    from projectiontrainer_tpu_torch.core.config import Stage0Config
    from projectiontrainer_tpu_torch.data import feeder
    from projectiontrainer_tpu_torch.train.trainer_stage0 import Stage0Trainer

    train_ds = make(samples[:128], 512, True)
    val_ds = make(samples[128:144], 512, False)
    tcfg = Stage0Config(output_dir=out_dir, batch_size=16, num_epochs=1, logging_steps=1,
                        num_workers=8, num_loader_procs=procs, use_online_augmentation=True,
                        device=DEVICE, disable_wandb=True, seed=SEED, img_size=512,
                        max_text_len=cfg.text.max_position_embeddings,
                        profile_dir=os.path.join(out_dir, "profile"), profile_start_step=6,
                        profile_num_steps=2)
    trainer = Stage0Trainer(tcfg, model_cfg=cfg, params=params, tokenizer=FileTokenizer(),
                            train_dataset=train_ds, val_dataset=val_ds,
                            class_names=list(FEED_CLASSES))
    before = {p: x.detach().clone() for p, x in _watched_leaves(params).items()}
    result = trainer.train()
    torch.cuda.synchronize()
    # the card's processes, read after the steps with the workers still alive: a worker
    # that had made a CUDA context would hold it, and be listed, until it exits
    listed = compute_apps()
    pools = list(feeder._pools.values())
    worker_pids = [pid for p in pools for pid in p.pids]
    cuda_in_workers = [pid for pid in worker_pids if maps_libcuda(pid)]
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    del trainer
    shm_names = [p._shm.name for p in pools]
    feeder.close_pools()
    leaked = [n for n in shm_names if os.path.exists(os.path.join(feeder.SHM_DIR, n))]
    losses = [r["train/batch_loss"] for r in metrics if "train/batch_loss" in r]
    moved = {p: float((x.detach().float() - before[p].float()).abs().max())
             for p, x in _watched_leaves(params).items()}
    split = {k[len("profile/"):]: v for r in metrics for k, v in r.items()
             if k.startswith("profile/")}
    stats = {"images_per_sec": result.get("images_per_sec"),
             "step_time_ms": result.get("step_time_ms")}
    listed_pids = {int(line.split(",")[0]) for line in listed}
    feed = f"{procs} feeder processes" if procs else "8 threads"
    if len(losses) != 8 or not np.isfinite(losses).all():
        raise AssertionError(f"stage 0 from files ({feed}): expected 8 finite losses, got "
                             f"{losses}")
    if not all(m > 0 for m in moved.values()):
        raise AssertionError(f"stage 0 from files ({feed}): a trainable leaf did not change: "
                             f"{moved}")
    if train_ds.n_invalid or val_ds.n_invalid:
        raise AssertionError(f"stage 0 from files ({feed}): {train_ds.n_invalid} + "
                             f"{val_ds.n_invalid} invalid samples")
    if [p.num_workers for p in pools] != ([procs] if procs else []):
        raise AssertionError(f"stage 0 from files ({feed}): the feed ran on {pools}")
    if cuda_in_workers or listed_pids & set(worker_pids) or len(listed) > 1:
        raise AssertionError(f"stage 0 from files ({feed}): the card's processes {listed}; "
                             f"workers {worker_pids}, with libcuda mapped {cuda_in_workers}")
    if leaked:
        raise AssertionError(f"feeder: shared memory left behind: {leaked}")
    if not all(stats.values()) or "total_ms" not in split:
        raise AssertionError(f"stage 0 from files ({feed}): no throughput or trace: {result}")
    return {"feed": feed, "steps": len(losses), "losses": losses, **stats,
            "kernel_ms": split["total_ms"], "kernel_ms_per_step": split,
            "device_idle_share": 1 - split["total_ms"] / stats["step_time_ms"],
            "num_loader_procs": procs, "omp_threads": pools[0].omp_threads if pools else None,
            "invalid_samples": 0, "leaf_max_change": moved, "compute_apps": listed,
            "worker_pids": worker_pids}


# ------------------------------------------------------------------- phases 17-19

# meta-llama/Llama-3.2-1B config.json: the fields the decoder reads
LLAMA_3_2_1B = {
    "model_type": "llama", "vocab_size": 128_256, "hidden_size": 2048,
    "intermediate_size": 8192, "num_hidden_layers": 16, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 64, "rms_norm_eps": 1e-5, "rope_theta": 500_000.0,
    "rope_scaling": {"factor": 32.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    "tie_word_embeddings": True, "attention_bias": False, "max_position_embeddings": 131_072,
}
CAPTION_NEW_TOKENS = 128  # the stage-1 caption CLI's default --max_new_tokens
CAPTION_REPEATS = 2       # timed captions a decoding mode, after the counted one
GENERATION_SAMPLES = 16
GENERATION_MAX_Q_LEN = 256  # infer_generation's default --max_q_len
GENERATION_PASSES = 3       # timed passes of phase 18's loop, after the counted one
# the CheXpert labels: the zero-shot classes
CHEXPERT = ("No Finding", "Enlarged Cardiomediastinum", "Cardiomegaly", "Lung Opacity",
            "Lung Lesion", "Edema", "Consolidation", "Pneumonia", "Atelectasis",
            "Pneumothorax", "Pleural Effusion", "Pleural Other", "Fracture", "Support Devices")
ZERO_SHOT_BATCH = 32
SLICE_KERNELS = ("flash_attn_fwd", "layernorm_fwd", "decode_attn")


class PromptTokenizer(StubTokenizer):
    """The stub tokenizer, also for one prompt string (the inference CLIs' call): its
    ids unpadded, cut to ``max_length``."""

    def __call__(self, texts, padding="max_length", truncation=True, max_length=16,
                 add_special_tokens=True):
        if isinstance(texts, str):
            return {"input_ids": [2 + ord(c) for c in texts][:max_length]}
        return super().__call__(texts, padding=padding, truncation=truncation,
                                max_length=max_length)


def llama_vlm():
    """ViT-L/16-384 + projector 1024 -> 10240 -> 2048 + Llama-3.2-1B, seeded random: the
    towers in bf16, the projector in fp32."""
    import torch

    from projectiontrainer_tpu_torch.models import decoder as dec
    from projectiontrainer_tpu_torch.models import projector as proj
    from projectiontrainer_tpu_torch.models import siglip, vlm

    cfg = vlm.VLMConfig(vision=siglip.vit_l_16_384(),
                        projector=proj.ProjectorConfig(vision_dim=1024, llm_dim=2048),
                        llm=dec.from_hf_config(LLAMA_3_2_1B))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return cfg, vlm.init(gen, cfg, device="cuda", tower_dtype=torch.bfloat16,
                         projector_dtype=torch.float32)


def _counted(kernel_counters, names, fn):
    """(fn()'s result, {kernel: launches during it}); every one of ``names`` must launch."""
    for name in names:
        kernel_counters[name].reset()
    out = fn()
    launches = {name: kernel_counters[name].value for name in names}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    return out, launches


def phase_caption(cfg, params, kernel_counters):
    """Phase 17: ``infer_stage1.caption_image`` at full width from an in-memory image."""
    import statistics

    import torch

    from projectiontrainer_tpu_torch.cli import infer_stage1
    from projectiontrainer_tpu_torch.data import image as I
    from projectiontrainer_tpu_torch.generate import GenerationConfig
    from projectiontrainer_tpu_torch.models import vlm

    size = cfg.vision.image_size
    image = np.repeat(cxr_gray(cxr_base(1024), SEED + 17)[..., None], 3, axis=-1)
    tok = PromptTokenizer()
    modes = {"greedy": 1, "beams3": 3}
    gen = {mode: GenerationConfig(max_new_tokens=CAPTION_NEW_TOKENS, num_beams=nb,
                                  eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id)
           for mode, nb in modes.items()}

    def caption(mode):
        return infer_stage1.caption_image(image, cfg, params, tok, img_size=size,
                                          gen_cfg=gen[mode])

    captions, launches = _counted(kernel_counters, SLICE_KERNELS,
                                  lambda: {mode: caption(mode) for mode in modes})
    host = {}
    for mode in modes:
        times = []
        for _ in range(CAPTION_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = caption(mode)
            times.append(time.perf_counter() - t0)
            if again != captions[mode]:
                raise AssertionError(f"caption {mode}: a rerun gave another caption")
        host[mode] = statistics.median(times)
    for mode, text in captions.items():
        if not text.strip():
            raise AssertionError(f"caption {mode}: empty")

    pixels = torch.as_tensor(I.preprocess(image, size)[None], device=DEVICE)
    rng = np.random.default_rng(SEED + 17)
    nb = 3
    teacher = torch.tensor(rng.integers(2, cfg.llm.vocab_size, size=(4, nb)), device=DEVICE)

    def prefix(c):
        return vlm.visual_prefix(params, c, pixels)

    rows = hold_logits("caption", teacher_forced(cfg, params, prefix, nb, teacher),
                       teacher_forced(plain_config(cfg), params, prefix, nb, teacher))
    split = serve_split(cfg, params, lambda: prefix(cfg), nb)
    print(f"caption (Llama-3.2-1B, {CAPTION_NEW_TOKENS} new tokens): greedy "
          f"{host['greedy']:.3f} s, 3 beams {host['beams3']:.3f} s on the host clock; kernel "
          f"time: prefix {split['prefix_kernel_ms']:.2f} ms, prefill "
          f"{split['prefill_kernel_ms']:.2f} ms, a 3-beam decode step "
          f"{split['decode_step_kernel_ms']:.3f} ms (host {split['decode_step_host_ms']:.2f} ms)",
          flush=True)
    emit({"phase": 17, "caption_words": {m: len(c.split()) for m, c in captions.items()},
          "caption_host_s": host, "max_new_tokens": CAPTION_NEW_TOKENS, "logits": rows,
          "split": split, "launches": launches,
          "model": "ViT-L/16-384 + projector 1024->10240->2048 + Llama-3.2-1B, random"})
    return launches


def phase_generation_eval(cfg, params, kernel_counters):
    """Phase 18: ``infer_generation``'s loop over GENERATION_SAMPLES JPEG files, counted
    once (its shapes' first calls), then timed over GENERATION_PASSES passes that must
    give the same answers; then the first batch's prefix, built from its files and the
    prompt as the loop builds it, through the prefill and 4 teacher-forced decode steps
    against the plain path: K1 and K3 held at the evaluation's own shapes."""
    import logging
    import statistics

    import torch

    from projectiontrainer_tpu_torch.cli import infer_generation as ig
    from projectiontrainer_tpu_torch.cli import infer_vqa_stage2 as vqa
    from projectiontrainer_tpu_torch.data import image as I
    from projectiontrainer_tpu_torch.eval import metrics as M

    batch, nb = 8, 3
    tmp = tempfile.mkdtemp(prefix="chip_smoke_generation_")
    try:
        samples = write_cxr_sources(tmp, GENERATION_SAMPLES, 1024, SEED + 18)
        with open(os.path.join(tmp, "data.json"), "w") as f:
            json.dump(samples, f)
        args = ig.build_parser().parse_args([
            "--input_json", os.path.join(tmp, "data.json"), "--image_root", tmp,
            "--vision_model_name", "in-memory", "--llm_name", "in-memory",
            "--projector_path", "", "--img_size", str(cfg.vision.image_size),
            "--batch_size", str(batch), "--num_beams", str(nb),
            "--max_q_len", str(GENERATION_MAX_Q_LEN), "--max_new_tokens", str(MAX_NEW_TOKENS),
            "--candidate_labels", ",".join(FEED_CLASSES)])
        tok = PromptTokenizer()
        logger = logging.getLogger("chip_smoke")
        gen_cfg = vqa.generation_config(args, tok)

        def run():
            return ig.generate_results(samples, args, cfg, params, tok, gen_cfg, logger)

        results, launches = _counted(kernel_counters, SLICE_KERNELS, run)
        walls = []
        for _ in range(GENERATION_PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = run()
            walls.append(time.perf_counter() - t0)
            if again != results:
                raise AssertionError("generation eval: a timed pass gave other answers")
        accuracy = ig.display_summary(results, logger, list(FEED_CLASSES))
        pixels = np.stack([I.preprocess(I.load_image(I.resolve_image_path(s["image"], tmp, None)),
                                        args.img_size) for s in samples[:batch]])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    per_label = M.per_label_substring_accuracy([r["generated_answer"] for r in results],
                                               [r["normal_caption"] for r in results])
    counted = sum(n for _, n in per_label.values())
    if len(results) != GENERATION_SAMPLES or counted != GENERATION_SAMPLES:
        raise AssertionError(f"generation eval: {len(results)} results, {counted} counted")

    q_tok = [tok(args.prompt, max_length=args.max_q_len, truncation=True,
                 add_special_tokens=False)["input_ids"]] * batch

    def prefix(c):
        return vqa.build_prefix(pixels, q_tok, c, params, tok, max_q_len=args.max_q_len)

    with torch.no_grad():
        embeds, mask = prefix(cfg)
    want = generation_eval_mask(batch)
    llm = cfg.llm
    if (not torch.equal(mask, want) or bool(mask.all())
            or (llm.num_heads, llm.num_kv_heads, llm.head_dim) != (32, 8, 64)):
        raise AssertionError(f"generation eval: prefix {tuple(mask.shape)} with "
                             f"{int((mask == 0).sum(1)[0])} pad slots a row is not phase 2's "
                             f"{tuple(want.shape)}, or the heads are not 32/8 of 64")
    rng = np.random.default_rng(SEED + 18)
    teacher = torch.tensor(rng.integers(2, llm.vocab_size, size=(4, batch * nb)), device=DEVICE)
    rows = hold_logits("generation eval", teacher_forced(cfg, params, prefix, nb, teacher),
                       teacher_forced(plain_config(cfg), params, prefix, nb, teacher))
    rate = GENERATION_SAMPLES / statistics.median(walls)
    print(f"generation eval: {GENERATION_SAMPLES} files, {rate:.2f} samples/s (median of "
          f"{GENERATION_PASSES} passes after a counted one; batch {batch}, {nb} beams, "
          f"{MAX_NEW_TOKENS} new tokens: a smoke reading, the CLI decodes up to 1024); prefix "
          f"{tuple(mask.shape)} held against plain", flush=True)
    emit({"phase": 18, "samples": len(results), "accuracy": accuracy,
          "per_label": {k: list(v) for k, v in per_label.items()}, "walls_s": walls,
          "samples_per_s": rate, "launches": launches, "logits": rows,
          "prefix": list(mask.shape), "prompt_pad_slots": int((mask == 0).sum(1)[0]),
          "batch_size": batch, "num_beams": nb, "max_new_tokens": MAX_NEW_TOKENS,
          "cut": f"{GENERATION_SAMPLES} files (a test manifest: thousands), max_new_tokens "
                 f"{MAX_NEW_TOKENS} (the CLI's default: 1024)"})
    return launches


def dual_tower_vit_l():
    """The XraySigLIP__vit-l-16-siglip-384__webli dual tower (google/siglip-large-patch16-384
    layout: vision 24 x 1024 with its MAP head, text 24 x 1024, vocab 32,000, 64
    positions), seeded random, bf16."""
    import torch

    from projectiontrainer_tpu_torch.models import siglip

    cfg = siglip.SiglipConfig(
        vision=siglip.vit_l_16_384(),
        text=siglip.TextConfig(hidden_size=1024, intermediate_size=4096, num_layers=24,
                               num_heads=16, vocab_size=32_000, max_position_embeddings=64))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return cfg, siglip.init(gen, cfg, device="cuda", vision_dtype=torch.bfloat16,
                            text_dtype=torch.bfloat16)


def _median_s(fn, repeats=3) -> float:
    import statistics

    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase_zero_shot_tsne(kernel_counters):
    """Phase 19: ``ZeroShotClassifier.predict`` and ``tsne.compute_image_embeddings`` at
    batch ZERO_SHOT_BATCH over the full-width ViT-L dual tower, each against the plain
    path."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from projectiontrainer_tpu_torch.data import image as I
    from projectiontrainer_tpu_torch.eval import tsne, zero_shot
    from projectiontrainer_tpu_torch.models import projector as proj
    from projectiontrainer_tpu_torch.utils import timing

    cfg, params = dual_tower_vit_l()
    plain = plain_config(cfg)
    size = cfg.vision.image_size
    base = cxr_base(size)
    pixels = np.stack([I.preprocess(np.repeat(cxr_gray(base, SEED + 19 + i)[..., None], 3, -1),
                                    size) for i in range(ZERO_SHOT_BATCH)])
    tok = PromptTokenizer()

    def classify(c):
        clf = zero_shot.ZeroShotClassifier(c, params, tok, CHEXPERT, max_text_len=64)
        return clf, clf.predict(pixels)

    (clf, (probs, _)), zs_launches = _counted(kernel_counters, ("flash_attn_fwd", "layernorm_fwd"),
                                              lambda: classify(cfg))
    plain_clf, (plain_probs, _) = classify(plain)
    err = compare("zero-shot probabilities", torch.tensor(probs), torch.tensor(plain_probs))
    txt_cos = float(F.cosine_similarity(clf.text_embeds.float(),
                                        plain_clf.text_embeds.float(), dim=-1).min())
    if not txt_cos >= 0.99:
        raise AssertionError(f"zero-shot: text embeddings' cosine {txt_cos:.5f} < 0.99")
    zs_s = _median_s(lambda: clf.predict(pixels))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        clf.predict(pixels)
        torch.cuda.synchronize()
    zs_kernel_ms = sum(ms for _, ms in timing.device_kernels(prof.events()))

    pcfg = proj.ProjectorConfig(vision_dim=cfg.vision.hidden_size, llm_dim=2048)
    projector = proj.init(torch.Generator(device=DEVICE).manual_seed(SEED + 19), pcfg,
                          torch.float32, DEVICE)
    embeds, emb_cos, tsne_launches = {}, {}, {}
    for name, pp in (("pooled", None), ("projector", projector)):
        def run(c, pp=pp):
            return tsne.compute_image_embeddings(params["vision"], c.vision, [pixels],
                                                 projector_params=pp)
        embeds[name], tsne_launches[name] = _counted(
            kernel_counters, ("flash_attn_fwd", "layernorm_fwd"), lambda: run(cfg))
        want = run(plain)
        if embeds[name].shape != (ZERO_SHOT_BATCH, pcfg.vision_dim if pp is None
                                  else pcfg.llm_dim):
            raise AssertionError(f"t-SNE {name}: shape {embeds[name].shape}")
        emb_cos[name] = float(F.cosine_similarity(torch.tensor(embeds[name]),
                                                  torch.tensor(want), dim=-1).min())
        if not (np.isfinite(embeds[name]).all() and emb_cos[name] >= 0.99):
            raise AssertionError(f"t-SNE {name}: cosine to plain {emb_cos[name]:.5f} < 0.99")
    tsne_s = _median_s(lambda: tsne.compute_image_embeddings(params["vision"], cfg.vision,
                                                             [pixels]))
    launches = {"zero_shot": zs_launches,
                "tsne": {k: sum(v[k] for v in tsne_launches.values())
                         for k in ("flash_attn_fwd", "layernorm_fwd")}}
    print(f"zero-shot (ViT-L/16-384 dual tower, {len(CHEXPERT)} classes): batch "
          f"{ZERO_SHOT_BATCH} in {zs_s * 1e3:.1f} ms on the host clock "
          f"({ZERO_SHOT_BATCH / zs_s:.1f} images/s), {zs_kernel_ms:.2f} ms of kernels; t-SNE "
          f"embeddings {ZERO_SHOT_BATCH / tsne_s:.1f} images/s", flush=True)
    emit({"phase": 19, "zero_shot": {"max_abs_err_probs": err, "text_min_cosine": txt_cos,
                                     "batch_ms_host": zs_s * 1e3, "images_per_s": ZERO_SHOT_BATCH / zs_s,
                                     "batch_kernel_ms": zs_kernel_ms, "classes": len(CHEXPERT),
                                     "top1_agreement": float((probs.argmax(-1)
                                                              == plain_probs.argmax(-1)).mean())},
          "tsne": {"min_cosine": emb_cos, "images_per_s": ZERO_SHOT_BATCH / tsne_s},
          "launches": launches})
    del clf, plain_clf, params
    return launches


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
    check_profiler_spans()
    train_launches = phase_train(cfg, params, kernel_counters)
    phase_train_end_to_end(cfg, params, kernel_counters)
    del cfg, params
    gc.collect()
    torch.cuda.empty_cache()

    cfg, params = stage0_model()
    stage0_launches, stage0_stats = phase_stage0_train(cfg, params, kernel_counters)
    gc.collect()
    torch.cuda.empty_cache()
    phase_stage0_end_to_end(cfg, params, kernel_counters)
    gc.collect()
    torch.cuda.empty_cache()
    files_launches = phase_feed(cfg, params, kernel_counters, stage0_stats)
    del cfg, params
    gc.collect()
    torch.cuda.empty_cache()

    cfg, params = full_width_model()
    stage2_launches, stage2_step, params = phase_stage2_train(cfg, params, kernel_counters)
    gc.collect()
    torch.cuda.empty_cache()
    phase_stage2_end_to_end(cfg, params, kernel_counters)
    del cfg, params
    gc.collect()
    torch.cuda.empty_cache()

    cfg, params = qwen3_model("nf4-mirror")
    qlora_launches, params, adapter_dir = phase_qlora_train(cfg, params, kernel_counters)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        phase_qlora_end_to_end(cfg, params, kernel_counters)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        cfg, params = qwen3_model()  # dense bf16, the same seed
        qlora_serve = phase_serve(cfg, params, [kernel_counters[n] for n in SERVE_KERNELS],
                                  clients=8, adapter_path=adapter_dir, phase=13)
        del params
    finally:
        shutil.rmtree(adapter_dir, ignore_errors=True)
    gc_cuda()

    cfg, params = cls_model()
    cls_launches = phase_cls_train(cfg, params, kernel_counters)
    gc_cuda()
    phase_cls_end_to_end(cfg, params, kernel_counters)
    del cfg, params
    gc_cuda()

    cfg, params = llama_vlm()
    slice_launches = {"caption_llama": phase_caption(cfg, params, kernel_counters),
                      "generation_eval": phase_generation_eval(cfg, params, kernel_counters)}
    del cfg, params
    gc_cuda()
    slice_launches.update(phase_zero_shot_tsne(kernel_counters))
    gc_cuda()

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        rows = results[name]
        main_row = next((r for r in rows if r["case"].startswith(MAIN_CASE.get(name, ""))))
        by_path = ({"stage0": stage0_launches[name], "stage0_files": files_launches[name]}
                   if name in STAGE0_KERNELS else {})
        if name in STAGE1_KERNELS:
            by_path["train"] = train_launches[name]
        if name in serve_launches:
            by_path["serve"] = serve_launches[name]
        if name in STAGE2_KERNELS:
            by_path["stage2"] = stage2_launches[name]
        if name in STAGE2_QLORA_KERNELS:
            by_path["stage2_qlora"] = qlora_launches[name]
        if name in qlora_serve:
            by_path["serve_qwen3_adapter"] = qlora_serve[name]
        if name in CLS_KERNELS:
            by_path["cls"] = cls_launches[name]
        for path, counted in slice_launches.items():
            if name in counted:
                by_path[path] = counted[name]
        main_path = next(p for p in ("serve", "train", "stage0") if p in by_path)
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": by_path[main_path], "launches_by_path": by_path,
                        "launches_per_stage2_micro_step": stage2_step[name],
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
