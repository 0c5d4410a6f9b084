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
   Tensor parallelism's per-rank shapes (phase 21, 2 model ranks): K1/K4/K5 on a rank's
   heads, Qwen3's [2,1855,16|4,128] (causal, padded questions and answers) and
   Gemma3's [4,1087,2|1,256] (window 512, the one KV head replicated); K6/K7 on a rank's
   vocab slice with about half the supervised labels -1 (outside the slice: no column
   matches, the nll is the lse), Qwen3's [2048,4096] x [75968,4096] and Gemma3's
   [2048,1152] x [131072,1152]; K3 on a rank's 16|4 heads of 128.
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
   must rise during the run. Then one short leg at ``--num_beams 24`` (2 requests,
   batch 2, 16 new tokens: 96 query rows on Gemma3-1B's one KV head, two row groups of
   K3): every request answered, K1-K3 launched, and the two requests' kernel-path tokens
   equal to the plain path's (or else 4 teacher-forced steps at cosine >= 0.9997).
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
6b. head dim 1024: Gemma3-1B's widths (hidden 1152, 4|1 heads, window 512, vocab
   262,144) at head dim 1024 and 2 layers behind ViT-L/16-384 (2 of 24 layers), from the
   seed: 3 stage-1 train steps (``train/steps.py``, batch 2 at 1087 tokens; K1/K4 on the
   cluster kernels, K5 too, K6/K7), each held against the plain path at
   the same params (loss within 1e-3 relative, projector gradients at cosine >= 0.999),
   then a 3-beam decode of 16 tokens (K1, K3 at head dim 1024 on its cluster route) and
   its prefill and 16 teacher-forced steps held by ``hold_logits`` against the plain path.
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
   full-width VLM of phase 3 (its decoder cut to 6 of 26 layers for run time) from
   seeded random weights, fp32 masters and bf16
   compute, per-layer remat, batch 1, accumulation 8, lr 1e-5, per-module clip 1.0,
   2 epochs of 16 in-memory samples (questions of 8-128 tokens, answers of 32-512:
   buckets up to 575 + 128 + 512 = 1215 tokens), validation on 2 samples with 3-beam
   sampling and 16 new tokens. The last epoch's train-state file is written (~13 GB;
   its bytes and seconds printed; ``best`` and ``epoch_0`` take the same path and are
   skipped for the script's wall). Every loss finite; the tower moved in
   epoch 0 and not in epoch 1; the LLM, its tied table and the projector moved in
   both; checkpoint-epoch_1/ and the examples written; K1, K2, K3, K4, K5 and K8
   launched. Micro-steps 6-7 are profiled (the card's kernel time by span, forward and
   backward apart); images/s and ms a micro-step from steps 1-5.
10. end to end (stage 2), batch 1 at the longest bucket: the loss and the gradient of
   every trainable leaf (tower, projector, LLM with its tied table) through the kernel
   path against the plain path: loss within 1e-3 relative, cosine >= 0.999 per leaf,
   the key-projection biases by their noise (at most 3x plain's), and the decoder's q/k
   RMSNorm scales, whose bf16 gradient is mostly rounding at random weights, by their
   distance to the plain path's fp32 gradient: at most 1.5x plain bf16's. Then (b) the
   same micro-step on the kernel path under --remat dots against --remat full: the loss
   bit-equal, every gradient leaf at cosine >= 0.99999; peak memory above the model and
   ms of the micro-step for each.
11. stage-2 QLoRA train: phase 10's model is freed; the full-width ViT-L/16-384 +
   projector 1024 -> 10240 -> 4096 + Qwen3-8B (hidden 4096, 32/8 heads of 128, vocab
   151,936, untied head; 9 of its 36 layers, cut for run time) from seeded
   random weights, the decoder built and
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
   may use; /dev/shm's free bytes); 256 seeded 1024 x 1024 CXR-like
   gray JPEGs (stored as RGB, 4 caption classes) written to a temp dir; (a) the feed
   alone: images/s of ``epoch_batches`` (batch 16, onto the card) over 64 of them at
   512 px on 8 threads, augmentation off and on, and on the process feeder at every CPU,
   augmentation on, the workers at OMP_NUM_THREADS 1 and at OpenMP's default, each
   beside the demand (stage 0: 63-104 images/s); the rows at N = 4, augmentation off on
   the feeder, 384 px and 2048 px sources were cut for the script's wall (readings for
   A8's bench); (b) Stage0Trainer.train()
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

20. data parallel: (a) the world: ``torch.cuda.device_count()``, ``nvidia-smi -L`` and the
   compute mode; 2 NCCL ranks on 2 cards or more, 2 gloo ranks sharing one card (said
   so), 1 NCCL rank where the card admits one process only (Exclusive_Process; the
   2-rank checks are then not run, and not reported as passed). The ranks of phases
   20-23 (and 22's where its world is the same) are started once: ``cli/launch.py``
   spawns them with ``--entry chip_smoke:legs_rank``, and each phase hands them its legs
   in turn (``_launch_legs``), every attribute a leg patched put back after it; the
   launch ends after phase 23. (b) the ranks run ``dp_stage1_rank``, each running
   ``cli/train_stage1.main`` with phase 5's full-width model, its decoder cut to 8 of
   26 layers (run time), built in the rank from the seed (the snapshot and tokenizer loaders replaced: no transformers on the card's
   host) over 64 + 8 seeded 1024 px CXR-like JPEG files with captions of 32-512 stub
   tokens: per-rank batch 4 (global 8), 8 steps, fused CE, validation on 8, steps 6-7
   profiled on rank 0. Every rank logs the same 8 finite losses; the trained projectors
   hash equal; projector_final.bin written once; K1-K7 launched on every rank; then,
   in this process, one step of the 1-process trainer at batch 8 on the same first 8
   samples: the first loss within 1e-3 relative, every projector gradient leaf (the
   all-reduced one) at cosine >= 0.999, the projector's update (all its leaves) at
   cosine >= 0.999 (each leaf's printed too: Adam's first update is about lr x
   sign(gradient), so a near-zero gradient element flips on bf16 rounding). Images/s per
   rank and the span ``grad_allreduce`` (kernel time from rank 0's trace, the host time
   of the all-reduce per rank). (c) the same launcher runs ``cli/train_stage0.main``
   with --local_negatives on the so400m dual tower cut to 2 layers a tower (run time)
   from the seed, over 64 + 16 JPEG files, 2 ranks x 8 rows, 4 steps: every loss
   finite and the same on every rank, the trained leaves bit-equal across the ranks,
   K1/K2/K4/K5/K8 launched on every rank. A rank that fails fails the phase.
21. tensor parallel: (a) the world, as in phase 20: 2 model ranks share one card over
   gloo (said so: a sharing figure, not a scaling one), one NCCL rank a card on 2 cards
   or more; where the card admits one process the phase prints that it did not run and
   why, and reports no pass. (b) ``cli/launch.py`` runs ``cli/train_stage2.main``
   (``--entry chip_smoke:tp_stage2_rank``) at --mesh_data 1 --mesh_model 2 with phase
   11's model (Qwen3-8B cut to 6 of 36 layers for run time) and recipe: each rank builds each whole layer from the seed, quantizes it
   and keeps its slice (the shards of phase 11's model), LoRA B drawn at std 0.02;
   batch 2, accumulation 2, 4 micro-steps up to 1855 tokens, validation on 2 samples
   (3 beams, 16 new tokens), step 2 profiled. The ranks log bit-equal losses, every
   replicated trained leaf is bit-equal across them after training, the gathered PEFT
   adapter loads in this process whole, K1-K7 launch on every rank; then this process
   runs the 1-process trainer's first micro-step on the same samples: the loss within
   1e-3 relative, each gathered LoRA gradient at cosine >= 0.999, or, below that, at
   >= 0.99 with its group (every A, every B) at >= 0.999. Per rank: images/s, the host
   time of the model-axis all-reduces and their kernel time in rank 0's trace, and the
   collectives of a micro-step (forward, backward, recompute and the partial-gradient
   sum apart). (c) ``cli/train_stage1.main`` at phase 5's Gemma3-1B width with
   --mesh_model 2 (one KV head, replicated; the vocab-parallel K6/K7 over the tied
   table), 4 steps at batch 4, validation on 4: the same checks against the 1-process
   step, projector_final.bin written whole; the decoder cut to 6 of 26 layers (run time).
   (d) the same stage 1 at --mesh_data 1 --mesh_model 3 in a launch of 3 ranks of its
   own (started while (b) and (c) run; 3 gloo ranks sharing the card, said so, or one
   NCCL rank a card on 3 cards or more; not run where a card admits one process): the
   model axis divides only the decoder's MLP (6912 = 3 x 2304), so the tower, every
   attention block (4 query heads), the projector (10240) and the vocab (262,144) run
   whole on each rank, through K1/K2 in the tower, K1/K4/K5 on all heads in the decoder
   and the whole-vocab K6/K7. The checks of (c), held against (c)'s 1-process step;
   each rank's launches in the kernels line (``stage1_tp3_rank<r>``).
22. ZeRO-3 over the data axis (--fsdp), BASELINE config #4: (a) the world as in phase 21
   (2 gloo ranks sharing one card, said so: a sharing figure; one NCCL rank a card on 2
   cards or more, 4 on 4; where the card admits one process the phase prints that it
   did not run and why). (b) ``cli/launch.py`` runs ``cli/train_stage2.main``
   (``--entry chip_smoke:fsdp_stage2_rank``) with --fsdp --mesh_data N,
   --unfreeze_llm --unfreeze_projection_layer --train_ve_first_epoch, fp32 masters,
   bf16 compute, remat full, over the ViT-L/16-384 + projector 1024 -> 10240 -> 2560 +
   Gemma3-4B VLM (2560 wide, 8|4 heads of 256, vocab 262,208, window 1024 on 5 layers
   of 6, rope factor 8) at full width from the seed, cut to 2 of its 34 decoder layers
   (both sliding) and 2 of the tower's 24 when the ranks share a card (all on cards of
   their own; cut for the script's time); each rank builds the model in
   bf16 and its trainer keeps the rank's data shard of every large leaf before the fp32
   cast; batch 1 a rank, accumulation 2, 2 epochs of 2 micro-steps a rank at 1215
   tokens (the tower's freeze and the optimizer swap crossed; 4 micro-steps an epoch cut
   to 2 for the script's time), validation on 2 samples (3 beams, 16
   new tokens), the train state and exports written after the last epoch only. Every
   rank logs the same finite losses; the replicated trained leaves are bit-equal across
   the ranks; each rank's params + moments + accumulators are at most total / N + the
   replicated residue (both printed); the gathered checkpoint loads whole here (memory-
   mapped); K1/K2/K3/K4/K5/K8 launch on every rank; then this process runs the first
   micro-step on the whole model (the trainer's masters and loss, no optimizer) on the
   same global batch: the loss within 1e-3 relative, each gathered gradient leaf at
   cosine >= 0.999 (below it at >= 0.99 with its group at >= 0.999: phase 21's rule),
   the key-projection biases by their noise and the q/k RMSNorm scales by phase 10's
   distance rule. Per rank: images/s and tokens/s, ``max_memory_allocated``, the host
   time of the gathers and reduce-scatters and, from a profiled extra micro-step, their
   kernel time; the gathers of a micro-step by phase; the live gathered bytes of one
   micro-step under remat full and under 'dots' (which keeps every gathered weight).
   (Stage 0 with --fsdp runs in phase 23 (b), at --mesh_model 2 only: the kernels line
   holds no stage0_fsdp_rank0 path of --mesh_model 1.)
   Phase 2 adds Gemma3-4B's shapes: K1/K4/K5 at [1,1215,8|4,256] (window 1024 and
   none, the question's and the answer's padding masked) and K3 at its 8|4 heads of
   256 (one sample of 3 beams, P = 703, G = 16), each rerun held bit-equal.
23. tensor parallel towers: the world as in phase 21 (2 model ranks share one card over
   gloo, said so: a sharing figure; where the card admits one process the phase prints
   that it did not run and why). (a) ``cli/launch.py`` runs ``cli/train_stage0.main``
   (``--entry chip_smoke:tp_towers_stage0_rank``) at --mesh_data 1 --mesh_model 2 over
   the so400m dual tower at full width (14 of its 27 layers a tower, cut for the
   script's time; 8 of 16 heads of 72 a rank), built whole from the seed in each rank
   and sliced by the CLI
   (``sharding.model_shards``): batch 16 at 512 px, 3 steps of in-memory samples (the
   last profiled on rank 0: kernel time by span, ``tp_allreduce`` apart), no validation
   (run time), the final checkpoint.
   Every rank logs the same finite losses; each step's model-axis collectives are the
   count read off the code (``tp_towers_predicted``, forward / backward / recompute /
   grads); every leaf the model axis leaves whole (logit_*, the
   LayerNorms, the MAP head's attention, ...) hashes equal on the two ranks after every
   step; the final checkpoint holds every trained leaf whole (the MAP head's MLP among
   them); K1/K2/K4/K5/K8 launch
   on every rank; then this process runs the first step on the whole model: the loss
   within 1e-3 relative, each gathered gradient leaf at cosine >= 0.999 or, below it,
   by its distance to the one-process fp32 plain-path gradient (computed only then), the
   key-projection biases by their noise (``hold_gradients``, the rule of every phase
   that holds gradients). (b) stage 0 at 2 x 2 (4 ranks: one NCCL rank a
   card on 4 cards or more, else 4 gloo ranks sharing the cards, said so; not run where
   a card admits one process) with --fsdp --no-local_negatives on phase 20 (c)'s cut
   towers, 2 steps of 8 a data rank: the same checks within each replica, data shards
   held, the final checkpoint whole, and the first loss within 1e-3 of one process on
   the whole global batch (the global negatives gathered over the data axis only). (c) ``cli/cls_train.main`` at
   --mesh_model 2 over the ViT-L/16-384 tower (12 of its 24 layers, cut for the
   script's time; 8 of 16 heads of 64 a rank) and the 4-class head from the seed, batch
   32, 1EpochUnfreeze, 2 epochs of 2 steps: the same checks (``tp_towers_predicted``'s
   collectives a step, the tower trained in epoch 0 and frozen in epoch 1), an evaluation of the initial classifier before training whose logits sit
   at cosine >= 0.999 to one process's, every evaluation over each data rank's rows
   once (its AUROC beside one process's), and the first loss within 1e-3.
   Phase 2 adds the towers' per-rank shapes: K1/K4/K5 at so400m's [16,1024,8,72] and
   the cls tower's [32,576,8,64], K1 at the text tower's [16,64,8,72].
24. budget (after phase 23): ``parallel/budget.py`` against the card. The ``ptt``
   operators' declared buffers (K1 with its fp32 O, K4, K5 at [8,576,16,64]; K2 at
   [4608,1024]; K8 at [576,1024] with its partial sums), each rounded to 512 B, equal
   the peak of ``memory_allocated`` over one real launch; the host microseconds of a K1
   launch through the operator and through its CUDA implementation called directly
   (1000 launches each, at the cls tower's shape and a tiny one); the bytes a fresh
   process holds beyond its allocator's (CUDA context, cuBLAS, the kernel library,
   Triton, a 1-rank NCCL communicator), beside the constant the budget's limit is built
   from. Phase 22's config (Gemma3-4B at 2 of 34 layers, the tower at 2 of 24; batch
   1, 1215 tokens, accumulation 2, fp32 masters, full remat) at world 1: the fake-CUDA
   trace's peak equals the meta trace's, and is within 10% of ``max_memory_allocated``
   over the same applying micro-step run for real (the trainer's own program,
   ``trainer_stage2.build_stage2``; reset after the build), the gap printed by category
   (the real run under the same tracker). The trace at phase 22's world against the
   trainer itself, phase 22's rank 0 over its applying micro-step: the collectives
   equal by kind and phase, the peak within 10% of its ``max_memory_allocated`` (reset
   just before it). With 2 cards or more, the trace's rank-0 peak at
   world 2 within 10% of rank 0's over 2 NCCL ranks. BASELINE config #4 at its full 34
   layers (``projectiontrainer-torch-budget``, seven processes at once): peak, fits and
   collectives at 4 x 1 and 8 x 1, batch 2 and 4, 4 x 2, batch 2 and 4 a data rank, and
   1 x 8 (``--model_axis 8``: Gemma3-4B's 4 KV heads replicated, each rank's query head
   reading its own), batch 4, its collectives printed beside 8 x 1's.
   Phase 2 adds head dims the kernels do not take, zero-padded to the next one: K1/K4/K5
   at D = 80 ([16,1024,16,80]) and 96 ([8,576,16,96]) through autograd (launches
   counted), K3 at D = 96, at the other rows' tolerances, with the pad's copy time.
   And the widths and rows the kernels took last (``check_wide_kernels``): K1/K4/K5 at
   head dim 512 ([4,1024,8|2,512], causal, window 512) and at 320 padded to 512
   ([8,576,8,320]); K3 at head dim 512, at 96 query rows a KV head (2 x 24 beams of
   Gemma3-1B) and 68 (8 x 17 beams of Llama-3.2-1B); K2 and K8 at [16384,1004],
   [4096,6144] and [2048,8192]; each rerun held bit-equal. Above those: K1/K4/K5 at head
   dim 1024 ([2,1024,4|1,1024], causal, window 512; the library call SDPA's efficient
   backend on k and v repeated to the query heads), 640 ([4,576,4,640]), 2048
   ([1,1024,4|1,2048], window 512: K4's and K5's 8-CTA clusters), 2112 and 4096
   ([1,512,4|1,2112] and [1,512,4|1,4096]: K4 and K5 on clusters of 9 and 16 CTAs, past
   the portable 8), 4160 and 8192 (the same shape past K1's reach: K4 and K5 in two passes
   over the output columns on 16 CTAs, K1 on the column blocks) and 8256 (K1, K4 and K5
   past their reach), each row naming its route (K1, K4 and K5 on the cluster kernels up
   to 4096, K4 and K5 "cluster passes" at 4160 and 8192, K1 "column blocks" there and K4
   and K5 at 8256), after a line of the clusters of 9-16 CTAs of K4
   and K5, and of their two-pass plans, the card holds at once at their plans' shared
   memory (``cluster_fits``); K3 at head
   dim 1024 (8 x 3 beams, P = 831, G = 32; a cluster of 4 CTAs; the library call SDPA's
   math backend on the GQA caches and its efficient backend on k and v repeated to the
   query heads) and at 2304 and 4096 (2 x 3 beams, P = 300, G = 16, window 100 and none:
   clusters of 5 and 8 CTAs of two 256-column blocks, the last of 2304's one); K2 and K8 at
   [2048,20480], [512,32768] and [1000,24577] (K8 on clusters of 5, 8 and 7 CTAs), each
   row of K3 and K8 naming its route too.

The second-to-last line is {"kernels": [...]} (name, route, source, replaces, launches
on the main path, launches_by_path (serve, serve_24_beams, train, head_dim_1024_train,
head_dim_1024_decode, stage0, stage0_files, stage2,
stage2_qlora, serve_qwen3_adapter, cls, caption_llama, generation_eval, zero_shot,
tsne, stage1_dp_rank0, stage0_dp_rank0, stage2_qlora_tp_rank0, stage1_tp_rank0,
stage1_tp3_rank0, stage1_tp3_rank1, stage1_tp3_rank2, stage2_fsdp_rank0, stage0_tp_rank0, stage0_fsdp_tp_rank0,
cls_tp_rank0), max_abs_err, ms, plain_ms, bound_ms, bound_by,
library_ms, the launches of one epoch-0 stage-2 micro-step at the longest bucket,
phase 9's, and of one phase-22 FSDP micro-step on rank 0); the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs no network and no model snapshot; imports nothing of JAX.
"""

from __future__ import annotations

import atexit
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
DOTS_COS = 0.99999    # remat dots against full remat: each gradient leaf's cosine
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


def _key_bias(path) -> bool:
    return path.endswith("k_proj/bias")


def hold_gradients(label, got, ref, fp32=None, *, below="distance", noise=_key_bias,
                   by_distance=None):
    """The per-leaf rule for two bf16 gradients of one loss on one batch, ``got`` (the
    path under test) against ``ref`` (the plain path or one process), each {path: tensor}:

    - the leaves ``noise`` names (zero in exact arithmetic, the key biases by default) are
      rounding on both sides: their largest norm at most KEY_BIAS_NOISE x ``ref``'s;
    - every other leaf at cosine >= COS_MIN. A leaf below it: with ``below="distance"``
      held by its distance to the fp32 gradient, at most ROUNDING_GAP x ``ref``'s; with
      ``below="group"`` (phase 21's rule) at >= TP_LEAF_COS_FLOOR where every group (the
      leaves of one name) is at >= COS_MIN; with ``below="fail"`` not at all;
    - the leaves ``by_distance`` names (mostly rounding at random weights) by their
      distance to the fp32 gradient alone.

    ``fp32(paths)`` gives the fp32 gradients at ``paths``. Sums run in fp64 on the card.
    Returns (the readings, each leaf's cosine); raises naming ``label``."""
    import torch

    if got.keys() != ref.keys():
        raise AssertionError(f"{label}: gradient leaves differ: {sorted(got)[:4]} vs "
                             f"{sorted(ref)[:4]}")

    def flat(x):
        return x.to(DEVICE, torch.float64).flatten()

    def cosine(s):  # from (a.b, a.a, b.b)
        return s[0] / max((s[1] * s[2]) ** 0.5, 1e-300)

    sums, far, noise_norm = {}, [], [0.0, 0.0]
    for p in sorted(ref):
        if by_distance is not None and by_distance(p):
            far.append(p)
            continue
        a, b = flat(got[p]), flat(ref[p])
        if noise(p):
            noise_norm = [max(noise_norm[0], float(a.norm())),
                          max(noise_norm[1], float(b.norm()))]
        else:
            sums[p] = [float(a @ b), float(a @ a), float(b @ b)]
        del a, b
    cos = {p: cosine(s) for p, s in sums.items()}
    groups = {}
    for p, s in sums.items():  # a group's cosine from its leaves' sums: no concatenation
        g = groups.setdefault(p.rsplit("/", 1)[-1], [0.0, 0.0, 0.0])
        for i in range(3):
            g[i] += s[i]
    group_cos = {k: cosine(g) for k, g in groups.items()}
    slow = {p: c for p, c in cos.items() if not c >= COS_MIN}
    worst = min(cos, key=cos.get, default=None)
    readings = {"grad_leaves": len(cos), "min_grad_cosine": cos.get(worst),
                "min_grad_cosine_leaf": worst,
                "lowest_grad_cosines": {p: cos[p] for p in sorted(cos, key=cos.get)[:5]},
                "leaves_below_cos_min": slow,
                "noise_grad_norm_max_got_ref": noise_norm}
    trees = {p.split("/", 1)[0] for p in cos}
    readings["min_grad_cosine_by_tree"] = {
        t: min(c for p, c in cos.items() if p.split("/", 1)[0] == t) for t in sorted(trees)}
    if below == "group":
        readings["group_grad_cosine"] = group_cos
        if slow and not (min(slow.values()) >= TP_LEAF_COS_FLOOR
                         and min(group_cos.values()) >= COS_MIN):
            raise AssertionError(f"{label}: gradient cosines {slow}, by group {group_cos}")
    elif below == "distance":
        far += sorted(slow)
    elif slow:
        raise AssertionError(f"{label}: gradient cosines {slow} < {COS_MIN}")
    gaps = {}
    if far:
        ref32 = fp32(far)
        for p in far:
            f = flat(ref32[p])
            gaps[p] = (float((flat(got[p]) - f).norm())
                       / max(float((flat(ref[p]) - f).norm()), 1e-30))
    worst_gap = max(gaps, key=gaps.get, default=None)
    readings.update({"leaves_held_by_distance": len(gaps),
                     "distance_gap_max": gaps.get(worst_gap), "distance_gap_max_leaf": worst_gap,
                     "distance_gap_quantiles_50_90_100": [
                         float(np.quantile(list(gaps.values()), q)) for q in (0.5, 0.9, 1.0)]
                     if gaps else None})
    if gaps and not gaps[worst_gap] <= ROUNDING_GAP:
        raise AssertionError(f"{label}: {worst_gap}'s distance to fp32 is {gaps[worst_gap]:.4g} "
                             f"x the reference's > {ROUNDING_GAP}")
    if not noise_norm[0] <= KEY_BIAS_NOISE * noise_norm[1]:
        raise AssertionError(f"{label}: the gradient norm of the leaves zero in exact "
                             f"arithmetic {noise_norm[0]:.4g} > {KEY_BIAS_NOISE} x the "
                             f"reference's {noise_norm[1]:.4g}")
    return readings, cos


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


def bound_decode_attn(b, nb, hq, hkv, d, slots, live_keys):
    """K3: one query row a beam over [prefix; generated]: the live slots of both caches
    read once (``slots``: the live prefix slots over the batch, the prefix slots inside
    the window a batch row, whose mask is read, and the generated slots inside it a beam),
    q read, out written; 2 products over the live keys of all rows."""
    prefix, window_prefix, gen = slots
    rows = b * nb
    nbytes = (2 * 2 * hkv * d * (prefix + rows * gen) + 2 * 2 * rows * hq * d
              + 4 * b * window_prefix)
    return bound(4 * hq * live_keys * d, nbytes)


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


def sdpa_library(q, k, v, *, scale, causal=False, mask=None, backends=None):
    """F.scaled_dot_product_attention on [B, T, H, D] tensors (a yardstick only: the
    port never calls it) -> (fn, name of the backend that ran): the fused backends
    are tried in turn, the math backend last (``backends``: these names only)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.MATH):
        if backends is not None and backend.name not in backends:
            continue
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
    """The autograd backward of that call (dq, dk, dv together) -> (fn, backend); the
    math backend's where the fused one that took the forward refuses the backward."""
    import torch

    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    for backends in (None, ("MATH",)):
        fwd, name = sdpa_library(*leaves, **kw, backends=backends)
        out = fwd()
        fn = (lambda out=out: torch.autograd.grad(out, leaves, do.transpose(1, 2),
                                                  retain_graph=True))
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return fn, name
    raise AssertionError("no scaled_dot_product_attention backend took this backward")


def plan_route(kernel, d) -> dict:
    """The route and source of a kernel at head dim or row width d (the plans of
    ``ops/flash_attention.py``, ``ops/decode_attention.py:decode_plan`` and
    ``ops/fused_layernorm.py:bwd_plan``), for the kernels line's widest rows; {} for the
    other kernels."""
    from projectiontrainer_tpu_torch.ops import decode_attention as DA
    from projectiontrainer_tpu_torch.ops import flash_attention as FA
    from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN

    if kernel == "decode_attn":
        return {"plan_route": DA.decode_plan(1, 1, 1, 1, 1, 0, 1, None, d=d)["route"],
                "plan_source": KERNELS[kernel][1]}
    if kernel == "layernorm_bwd":
        return {"plan_route": FLN.bwd_plan(1, d, FLN.H100_SMS)["route"],
                "plan_source": KERNELS[kernel][1]}
    sources = {"cluster": f"{PKG}/csrc/flash_attn_cluster.cu",
               "cluster passes": f"{PKG}/csrc/flash_attn_cluster.cu",
               "column blocks": f"{PKG}/csrc/flash_attn_wide.cu"}
    plan = {"flash_attn_fwd": FA.forward_plan, "flash_attn_bwd_dkv": FA.dkv_plan,
            "flash_attn_bwd_dq": FA.dq_plan}.get(kernel)
    if plan is None:
        return {}
    route = plan(d).get("route", "wgmma")
    return {"plan_route": route, "plan_source": sources.get(route)}


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


BF16_HOST_MAX = 1 << 26  # above this many values, inputs are drawn on the card


def _bf16(rng, shape, scale=1.0):
    """Seeded standard-normal bf16 on the card: drawn by numpy, or for more than
    BF16_HOST_MAX values by a card generator seeded from ``rng`` (numpy takes seconds to
    draw a vocab table)."""
    import torch

    if int(np.prod(shape)) > BF16_HOST_MAX:
        gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 62)))
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)
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
               library=None, **extra):
        row = {"kernel": kernel, "case": case, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
               "library_ms": library_ms, "library": library, **extra}
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
    check_tp_kernels(rng, record)
    check_tp_tower_kernels(rng, record)
    check_gemma3_4b_kernels(rng, record)
    check_padded_head_dims(rng, record)
    check_wide_kernels(rng, record)
    emit({"phase": 2, "readings": READINGS})
    return results


def check_decode(rng, record, b, nb, p_len, g, steps, *, hq=4, hkv=1, d=256,
                 windows=(512, None), label="", pmask=None, repeat_kv_library=False):
    """K3 at batch b, nb beams, GQA hq/hkv at head dim d (Gemma3-1B's 4/1 at 256 by
    default), a prefix of p_len slots with ragged left padding (or the [b, p_len] mask
    ``pmask``) and g generated slots, at
    each step t of `steps` and each window of `windows`; record(kernel, case, err, ms,
    plain_ms, bound, library_ms, library). ``repeat_kv_library``: the library call gets k
    and v repeated to the query heads (SDPA's efficient backend takes them with the
    explicit mask), the GQA call's time beside it (``library_gqa_ms``)."""
    import torch

    from projectiontrainer_tpu_torch.kernels.check_decode_attn import library_call, live_slots
    from projectiontrainer_tpu_torch.ops import decode_attention as DA
    from projectiontrainer_tpu_torch.ops import flash_attention as FA

    qd = _bf16(rng, (b * nb, hq, d))
    kp, vp = _bf16(rng, (b, hkv, p_len, d)), _bf16(rng, (b, hkv, p_len, d))
    kg, vg = _bf16(rng, (b * nb, hkv, g, d)), _bf16(rng, (b * nb, hkv, g, d))
    if pmask is None:
        pmask, _ = _left_pad_mask(rng, b, p_len, 224)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    extra = {}
    if not DA.takes_head_dim(d):  # padded on the card: the copies' time beside the row
        width = DA.padded_width(d)
        extra["pad_ms"] = cuda_ms(lambda: [FA.pad_head_dim(x, width)
                                           for x in (qd, kp, vp, kg, vg)])
    for t in steps:
        for window in windows:
            kw = dict(prefix_mask=pmask, t=t, prefix_len=p_len, scale=d ** -0.5,
                      window=window)
            launched = DA.launches.value
            got = DA.decode_attention(qd, kp, vp, kg, vg, **kw)
            if DA.launches.value != launched + 1:
                raise AssertionError(f"decode d={d}: the call did not launch K3 once")
            ref = DA.decode_attention_reference(*(x.float() for x in (qd, kp, vp, kg, vg)),
                                                **kw)
            case = f"{label}B={b} nb={nb} P={p_len} G={g} t={t} window={window}"
            for _ in range(2):
                if not torch.equal(got, DA.decode_attention(qd, kp, vp, kg, vg, **kw)):
                    raise AssertionError(f"decode {case}: a rerun gave other bits")
            plan = DA.decode_plan(b, nb, hkv, p_len, g, t, p_len, window, sms,
                                  n_rep=hq // hkv, d=DA.padded_width(d))
            if not plan["ctas"] > b * hkv:
                raise AssertionError(f"decode {case}: {plan['ctas']} CTAs for {b * hkv} "
                                     "(batch, KV head) pairs")
            lib, backend, live = library_call(qd, kp, vp, kg, vg, **kw)
            note, more = "", dict(extra)
            if repeat_kv_library and hq != hkv:
                more["library_gqa_ms"] = cuda_ms(lib)
                note = f", k and v repeated to the query heads (GQA caches: SDPA {backend})"
                lib, backend, _ = library_call(qd, kp, vp, kg, vg, **kw, repeat_kv=True)
            groups = f", {plan['groups']} row groups" if plan["groups"] > 1 else ""
            record("decode_attn", f"{case} ({plan['ctas']} CTAs{groups})",
                   compare(f"decode {case}", got, ref),
                   cuda_ms(lambda: DA.decode_attention(qd, kp, vp, kg, vg, **kw)),
                   cuda_ms(lambda: DA.decode_attention_reference(qd, kp, vp, kg, vg, **kw)),
                   bound_decode_attn(b, nb, hq, hkv, d, live_slots(
                       pmask, t=t, prefix_len=p_len, window=window, g=g), live),
                   cuda_ms(lib), f"SDPA {backend} over concatenated caches, explicit mask{note}",
                   **more)


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


def check_attention_layer(rng, record, case, b, t, hq, hkv, d, mask, rerun=False,
                          repeat_kv_library=False, **kw):
    """K1 (when ``mask`` is given: the forward of the same layer), K4 and K5 at one
    decoder or tower shape against their plain versions, each beside its bound and the
    library call, and with ``rerun`` a second launch of K1 (when it runs), K4 and K5 held
    bit-equal; record(kernel, case, err, ms, plain_ms, bound, library_ms, library).
    ``repeat_kv_library``: the library call gets k and v repeated to the query heads (no
    GQA), which SDPA's efficient backend takes with an explicit mask; its name says
    which backend ran, the math one where the efficient one refuses the shape; the GQA
    call's time beside it (``library_gqa_ms``)."""
    import torch

    from projectiontrainer_tpu_torch.ops import flash_attention as FA
    from projectiontrainer_tpu_torch.ops.attention import repeat_kv

    q, do = _bf16(rng, (b, t, hq, d)), _bf16(rng, (b, t, hq, d))
    k, v = _bf16(rng, (b, t, hkv, d)), _bf16(rng, (b, t, hkv, d))
    lib_kv, lib_note, gqa = (k, v), "", repeat_kv_library and hq != hkv
    if gqa:
        lib_kv, lib_note = (repeat_kv(k, hq // hkv), repeat_kv(v, hq // hkv)), \
            ", k and v repeated to the query heads"
    out, lse = FA.flash_attention(q, k, v, kv_mask=mask, **kw)
    seen = (attention_mask(t, causal=kw["causal"], window=kw["window"], kv_mask=mask)
            if mask is not None or kw["causal"] else None)
    pairs = None if seen is None else live_pairs(seen)
    if mask is not None:  # K1 at this shape: the forward of the same layer
        ref, ref_lse = FA.flash_attention_reference(q.float(), k.float(), v.float(),
                                                    kv_mask=mask, **kw)
        err = compare(f"flash {case} out", out, ref)
        live = mask.bool()[:, None, :].expand_as(lse)
        compare(f"flash {case} lse", lse[live], ref_lse[live])
        del ref, ref_lse
        if rerun:
            again, again_lse = FA.flash_attention(q, k, v, kv_mask=mask, **kw)
            if not (torch.equal(out, again) and torch.equal(lse[live], again_lse[live])):
                raise AssertionError(f"flash {case}: a rerun of K1 gave other bits")
            del again, again_lse
        lib, backend = sdpa_library(q, *lib_kv, scale=kw["scale"], mask=seen)
        note, more = lib_note, {}
        if gqa:
            lib_gqa, backend_gqa = sdpa_library(q, k, v, scale=kw["scale"], mask=seen)
            more["library_gqa_ms"] = cuda_ms(lib_gqa)
            note += f" (GQA caches: SDPA {backend_gqa})"
        record("flash_attn_fwd", case, err,
               cuda_ms(lambda: FA.flash_attention(q, k, v, kv_mask=mask, **kw)),
               cuda_ms(lambda: FA.flash_attention_reference(q, k, v, kv_mask=mask, **kw)),
               bound_flash_fwd(b, t, hq, hkv, d, pairs), cuda_ms(lib),
               f"SDPA {backend}, explicit mask{note}", **more)
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
    lib, backend = sdpa_library_bwd(q, *lib_kv, do, scale=kw["scale"], mask=seen)
    more = {}
    if gqa:
        lib_gqa, backend_gqa = sdpa_library_bwd(q, k, v, do, scale=kw["scale"], mask=seen)
        more["library_gqa_ms"] = cuda_ms(lib_gqa)
        lib_note += f" (GQA caches: SDPA {backend_gqa})"
    library = (cuda_ms(lib), f"SDPA {backend} backward (dq, dk, dv together)"
               + (", explicit mask" if seen is not None else "") + lib_note)
    record("flash_attn_bwd_dkv", case, err_kv, cuda_ms(lambda: FA.launch_bwd_dkv(*args, **kw)),
           plain, bound_flash_bwd_dkv(b, t, hq, hkv, d, pairs), *library, **more)
    record("flash_attn_bwd_dq", case, err_q, cuda_ms(lambda: FA.launch_bwd_dq(*args, **kw)),
           plain, bound_flash_bwd_dq(b, t, hq, hkv, d, pairs), *library, **more)


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


def check_tp_kernels(rng, record):
    """The per-rank shapes of tensor parallelism over 2 model ranks (phase 21): K1/K4/K5
    on a rank's heads of Qwen3-8B ([2,1855,16|4,128], causal, padded questions and
    answers: phase 21's batch of 2) and of Gemma3-1B ([4,1087,2|1,256], window 512, the
    one KV head replicated: stage 1 at batch 4), K6/K7 on a rank's vocab slice with
    about half the labels -1 (Qwen3's [2048,4096] x [75968,4096]; Gemma3's [2048,1152] x
    [131072,1152]) and K3 on a rank's 16|4 heads of 128 (phase 21's validation, 3 beams);
    record(kernel, case, err, ms, plain_ms, bound, library_ms, library)."""
    import torch

    b, t = 2, 575 + 256 + 1024
    mask = torch.zeros((b, t), dtype=torch.int32, device="cuda")
    q_lens, a_lens = rng.integers(8, 257, size=b), rng.integers(32, 1025, size=b)
    q_lens[0], a_lens[0] = 256, 1024
    for i in range(b):
        mask[i, :575 + q_lens[i]] = 1
        mask[i, 575 + 256:575 + 256 + a_lens[i]] = 1
    check_attention_layer(
        rng, record, "TP rank: Qwen3 decoder [2,1855,16|4,128] causal, padded questions and "
        "answers", b, t, 16, 4, 128, mask, scale=128 ** -0.5, causal=True, window=None)
    b, t = 4, 1087
    mask = torch.ones((b, t), dtype=torch.int32, device="cuda")
    for i, n in enumerate(rng.integers(16, 513, size=b)):
        mask[i, 575 + n:] = 0
    check_attention_layer(
        rng, record, "TP rank: Gemma3 decoder [4,1087,2|1,256] causal window=512, right-padded "
        "captions", b, t, 2, 1, 256, mask, scale=256 ** -0.5, causal=True, window=512)
    check_fused_ce(rng, record, n=2048, vocab=151_936 // 2, d=4096, label="TP rank: Qwen3 ",
                   out_of_slice=0.5)
    check_fused_ce(rng, record, n=2048, vocab=262_144 // 2, d=1152, label="TP rank: Gemma3 ",
                   out_of_slice=0.5)
    check_decode(rng, record, 2, 3, 575 + 256, 16, (15,), hq=16, hkv=4, d=128,
                 windows=(None,), label="TP rank: Qwen3 ")


def check_tp_tower_kernels(rng, record):
    """The towers' per-rank shapes over 2 model ranks (phase 23): K1/K4/K5 on a rank's 8
    of so400m's 16 heads of 72 ([16,1024,8,72]: stage 0's vision tower at batch 16) and
    of ViT-L's 16 heads of 64 ([32,576,8,64]: the cls probe at batch 32), K1 alone on the
    so400m text tower's ([16,64,8,72]: frozen, forward only); non-causal, unmasked, each
    rerun held bit-equal; record(kernel, case, err, ms, plain_ms, bound, library_ms,
    library)."""
    for case, b, t, h, d in (("TP rank: so400m tower [16,1024,8,72]", 16, 1024, 8, 72),
                             ("TP rank: cls tower [32,576,8,64]", 32, 576, 8, 64)):
        kw = dict(scale=d ** -0.5, causal=False, window=None)
        check_flash_forward(rng, record, case, b, t, h, h, d, None, **kw)
        check_attention_layer(rng, record, case + " non-causal", b, t, h, h, d, None,
                              rerun=True, **kw)
    check_flash_forward(rng, record, "TP rank: so400m text tower [16,64,8,72]", 16, 64, 8, 8,
                        72, None, scale=72 ** -0.5, causal=False, window=None)


def check_gemma3_4b_kernels(rng, record):
    """Gemma3-4B's shapes (phase 22, BASELINE config #4): K1/K4/K5 over the decoder's
    longest bucket of phase 9's recipe at batch 1 ([1,1215,8|4,256]: 575 visual + 128
    question + 512 answer tokens, causal, the question's and the answer's padding masked)
    with the 4B's window of 1024 and without (its full layers), and K3 at its 8|4 heads of
    256 (one validation sample of 3 beams, a prefix of 575 + 128 slots, 16 generated, the
    window and none); each rerun held bit-equal; record(kernel, case, err, ms, plain_ms,
    bound, library_ms, library)."""
    import torch

    mask = torch.zeros((1, 1215), dtype=torch.int32, device="cuda")
    mask[0, :575 + 40] = 1             # visual tokens, a question of 40 tokens
    mask[0, 575 + 128:575 + 128 + 300] = 1  # an answer of 300 tokens
    for window in (1024, None):
        check_attention_layer(
            rng, record, f"Gemma3-4B decoder [1,1215,8|4,256] causal window={window}, padded "
            "question and answer", 1, 1215, 8, 4, 256, mask, rerun=True, scale=256 ** -0.5,
            causal=True, window=window)
    check_decode(rng, record, 1, 3, 575 + 128, 16, (15,), hq=8, hkv=4, d=256,
                 windows=(1024, None), label="Gemma3-4B ")


def check_padded_head_dims(rng, record, shapes=((16, 1024, 16, 80), (8, 576, 16, 96)),
                           decode=True):
    """Head dims the kernels do not take, zero-padded on the card to the next width they
    take (``ops/flash_attention.py:flash_attention_padded``; ``decode_attention_padded``):
    K1/K4/K5 at each [b, t, h, d] of ``shapes``, non-causal (by default D = 80
    ([16,1024,16,80], a SigLIP tower of 1280 in 16 heads; padded to 128) and D = 96
    ([8,576,16,96], a tower of 1536; padded to 128)), and with ``decode`` K3 at D = 96
    (padded to 128). Each against its plain version at the caller's D, at the other
    rows' tolerances, its launches counted, a rerun through autograd held bit-equal;
    ``ms`` is the padded call's (pad, kernel, slice), ``pad_ms`` the pad's copies alone,
    the bound and SDPA's time at the caller's D; record(kernel, case, err, ms, plain_ms,
    bound, library_ms, library, **extra)."""
    import torch

    from projectiontrainer_tpu_torch.ops import flash_attention as FA

    for b, t, h, d in shapes:
        width = FA.padded_head_dim(d)
        case = f"padded head dim [{b},{t},{h},{d}] -> {width} non-causal"
        kw = dict(scale=d ** -0.5, causal=False, window=None)
        q, k, v, do = (_bf16(rng, (b, t, h, d)) for _ in range(4))
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        counts = (FA.launches.value, FA.bwd_dkv_launches.value, FA.bwd_dq_launches.value)
        out, lse = FA.flash_attention(*leaves, **kw)
        dq, dk, dv = torch.autograd.grad(out, leaves, do)
        if (FA.launches.value, FA.bwd_dkv_launches.value, FA.bwd_dq_launches.value) != tuple(
                c + 1 for c in counts):
            raise AssertionError(f"flash {case}: the padded path did not launch K1, K4, K5 once")
        if out.shape != q.shape or dq.shape != q.shape or dk.shape != k.shape:
            raise AssertionError(f"flash {case}: shapes {out.shape} {dq.shape} {dk.shape}")
        again = FA.flash_attention(*leaves, **kw)[0]
        if not all(torch.equal(x, y) for x, y in zip(
                (out, dq, dk, dv), (again, *torch.autograd.grad(again, leaves, do)))):
            raise AssertionError(f"flash {case}: a rerun gave other bits")
        del again
        ref, ref_lse = FA.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
        err = compare(f"flash {case} out", out, ref)
        compare(f"flash {case} lse", lse, ref_lse)
        rq, rk, rv = FA.flash_attention_bwd_reference(q.float(), k.float(), v.float(), None,
                                                      ref, ref_lse, do.float(), **kw)
        err_kv = max(compare_rel(f"flash {case} dk", dk, rk),
                     compare_rel(f"flash {case} dv", dv, rv))
        err_q = compare_rel(f"flash {case} dq", dq, rq)
        del ref, ref_lse, rq, rk, rv, out, dq, dk, dv
        pad = [FA.pad_head_dim(x, width) for x in (q, k, v, do)]
        pout, plse, pout32 = FA._launch(*pad[:3], out_f32=True, kv_mask=None, **kw)
        prep = FA.prepare_bwd(*pad[:3], None, pout32, plse, pad[3])
        args = (*pad[:3], prep[0], prep[1], plse, prep[2])
        pad_fwd = cuda_ms(lambda: [FA.pad_head_dim(x, width) for x in (q, k, v)])
        pad_bwd = cuda_ms(lambda: [FA.pad_head_dim(x, width) for x in (q, k, v, do)])
        lib, backend = sdpa_library(q, k, v, scale=kw["scale"])
        record("flash_attn_fwd", case, err, cuda_ms(lambda: FA.flash_attention(q, k, v, **kw)),
               cuda_ms(lambda: FA.flash_attention_reference(q, k, v, **kw)),
               bound_flash_fwd(b, t, h, h, d), cuda_ms(lib), f"SDPA {backend}",
               pad_ms=pad_fwd, kernel_ms_at_width=cuda_ms(
                   lambda: FA._launch(*pad[:3], kv_mask=None, **kw)))
        ref_out, lse2 = FA.flash_attention_reference(q, k, v, **kw)
        plain = cuda_ms(lambda: FA.flash_attention_bwd_reference(q, k, v, None, ref_out, lse2,
                                                                 do, **kw))
        lib, backend = sdpa_library_bwd(q, k, v, do, scale=kw["scale"])
        library = (cuda_ms(lib), f"SDPA {backend} backward (dq, dk, dv together)")
        record("flash_attn_bwd_dkv", case, err_kv, cuda_ms(lambda: FA.launch_bwd_dkv(*args, **kw)),
               plain, bound_flash_bwd_dkv(b, t, h, h, d), *library, pad_ms=pad_bwd)
        record("flash_attn_bwd_dq", case, err_q, cuda_ms(lambda: FA.launch_bwd_dq(*args, **kw)),
               plain, bound_flash_bwd_dq(b, t, h, h, d), *library, pad_ms=pad_bwd)
        del pad, pout, plse, pout32, prep, args, ref_out, lse2
    if decode:
        check_decode(rng, record, 8, 3, 831, 32, (31,), hq=4, hkv=1, d=96, windows=(None,),
                     label="padded head dim 96 -> 128 ")


def check_wide_kernels(rng, record):
    """The widths and rows the kernels took last: K1/K4/K5 at head dim 512
    ([4,1024,8|2,512], causal, window 512; each warpgroup keeps half of O, dQ, dK and dV)
    and at 320 padded to 512 ([8,576,8,320], non-causal); K3 at head dim 512 (Gemma3-1B's
    served batch, 4|1 heads: 8 x 3 beams, P = 831, G = 32), at 96 query rows a KV head
    (Gemma3-1B's 4|1 heads, B = 2 x 24 beams: two row groups) and at 68 (Llama-3.2-1B's
    32|8 heads, B = 8 x 17 beams); K2 and K8 at rows of 1004 (not a 16-byte multiple:
    K8's row warps copy them by cp.async), 6144 and 8192 (K8's column sums through
    device memory). Above the widest of those (K1, K4, K5 and K3 on the cluster kernels,
    widths past their reach on the column blocks, K8's rows on a cluster, K2's column
    chunks): K1/K4/K5 at head dim 1024 ([2,1024,4|1,1024], causal, window 512; the
    library call SDPA's efficient backend with k and v repeated to the query heads and
    the window as an explicit mask, or the math one where it refuses) and 640
    ([4,576,4,640], non-causal), and at 2048 ([1,1024,4|1,2048], causal, window 512: K4's
    and K5's widest portable cluster, 8 CTAs), 2112 ([1,512,4|1,2112], causal: K4 and K5
    on clusters of 9 CTAs, K1 of 5), 4096 ([1,512,4|1,4096], causal: K4 and K5 on 16 CTAs,
    K1 on 8), 4160 and 8192 (the same shape: K4 and K5 in two passes on 16 CTAs, K1 past
    its reach on the column blocks) and 8256 (the same shape: K4 and K5 past their reach on
    the column blocks, as K1), the library call as at 1024 (and SDPA math on the GQA
    caches beside it), after a line of the clusters of 9-16 CTAs and of the two-pass
    plans the card holds at once (``cluster_fits``); K3
    at head dim 1024 (Gemma3-1B's 4|1 heads, 8 x 3 beams, P = 831, G = 32; a cluster of
    4 CTAs; the library call SDPA's
    efficient backend on k and v repeated to the query heads, its math backend on the GQA
    caches beside it) and at 2304 and 4096 (2 x 3 beams, P = 300, G = 16, window 100 and
    none: clusters of 5 and 8 CTAs of two 256-column blocks, 2304's last of one); K2
    and K8 at [2048,20480], [512,32768] and [1000,24577] (rows that are not 16-byte
    multiples; K8 on clusters of 5, 8 and 7 CTAs). Each against its plain version at
    phase 2's tolerances, a rerun held bit-equal, timed beside its bound and the library
    call; each flash, K3 and K8 row names its route (``plan_route``); record(kernel, case,
    err, ms, plain_ms, bound, library_ms, library)."""
    import torch

    from projectiontrainer_tpu_torch.kernels.check_flash_attn import cluster_fits

    plain_record = record

    def record(*args, **kw):  # these rows also go to the kernels line
        plain_record(*args, widest=True, **kw)

    def at_width(d):  # ... with the route each kernel takes at head dim or width d
        return lambda kernel, *args, **kw: record(kernel, *args, **kw,
                                                  **plan_route(kernel, d))

    mask = torch.ones((4, 1024), dtype=torch.int32, device="cuda")
    check_attention_layer(rng, record, "head dim 512 [4,1024,8|2,512] causal window=512", 4,
                          1024, 8, 2, 512, mask, rerun=True, scale=512 ** -0.5, causal=True,
                          window=512)
    check_padded_head_dims(rng, record, shapes=((8, 576, 8, 320),), decode=False)
    check_decode(rng, record, 8, 3, 831, 32, (31,), hq=4, hkv=1, d=512, windows=(None,),
                 label="head dim 512 ")
    check_decode(rng, record, 2, 24, 831, 32, (31,), hq=4, hkv=1, d=256, windows=(512, None),
                 label="96 rows a KV head ")
    check_decode(rng, record, 8, 17, 831, 32, (31,), hq=32, hkv=8, d=64, windows=(None,),
                 label="68 rows a KV head (Llama) ")
    for n, d, ragged in ((16384, 1004, True), (4096, 6144, True), (2048, 8192, True),
                         (2048, 20480, False), (512, 32768, False), (1000, 24577, False)):
        x = _bf16(rng, (n, d))
        p = {"scale": _bf16(rng, (d,), 0.5) + 1, "bias": _bf16(rng, (d,), 0.1)}
        check_layernorm_fwd(rng, record, x, p, f"rows [{n},{d}]")
        check_layernorm_bwd(rng, at_width(d), x, p, cases=((n, ragged),))
        del x, p
    mask = torch.ones((2, 1024), dtype=torch.int32, device="cuda")
    check_attention_layer(rng, at_width(1024), "head dim 1024 [2,1024,4|1,1024] causal "
                          "window=512", 2, 1024, 4, 1, 1024, mask, rerun=True,
                          repeat_kv_library=True, scale=1024 ** -0.5, causal=True, window=512)
    mask = torch.ones((4, 576), dtype=torch.int32, device="cuda")
    check_attention_layer(rng, at_width(640), "head dim 640 [4,576,4,640] non-causal", 4, 576,
                          4, 4, 640, mask, rerun=True, scale=640 ** -0.5, causal=False,
                          window=None)
    mask = torch.ones((1, 1024), dtype=torch.int32, device="cuda")
    check_attention_layer(rng, at_width(2048), "head dim 2048 [1,1024,4|1,2048] causal "
                          "window=512", 1, 1024, 4, 1, 2048, mask, rerun=True,
                          repeat_kv_library=True, scale=2048 ** -0.5, causal=True, window=512)
    fits = cluster_fits()
    emit({"phase": 2, **fits})
    if not fits["ok"]:
        raise AssertionError(f"cluster_fit: a cluster the card cannot place: {fits}")
    for d in (2112, 4096, 4160, 8192, 8256):
        check_attention_layer(rng, at_width(d), f"head dim {d} [1,512,4|1,{d}] causal", 1,
                              512, 4, 1, d, mask[:, :512], rerun=True, repeat_kv_library=True,
                              scale=d ** -0.5, causal=True, window=None)
    check_decode(rng, at_width(1024), 8, 3, 831, 32, (31,), hq=4, hkv=1, d=1024,
                 windows=(None,), label="head dim 1024 ", repeat_kv_library=True)
    for d in (2304, 4096):
        check_decode(rng, at_width(d), 2, 3, 300, 16, (15,), hq=4, hkv=1, d=d,
                     windows=(100, None), label=f"head dim {d} ", repeat_kv_library=True)


def check_layernorm_fwd(rng, record, x, p, case):
    """K2 over the rows of x against the plain forward, a rerun held bit-equal, timed
    beside its bound and ``F.layer_norm``; record(kernel, case, err, ms, plain_ms,
    bound, library_ms, library)."""
    import torch
    import torch.nn.functional as F

    from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN

    n, d = x.shape
    got = FLN.layernorm(p, x)
    ref = FLN.layernorm_reference({k: v.float() for k, v in p.items()}, x.float())
    err = compare(f"layernorm {case}", got, ref)
    del ref
    if not torch.equal(got, FLN.layernorm(p, x)):
        raise AssertionError(f"layernorm {case}: a rerun of K2 gave other bits")
    record("layernorm_fwd", case, err, cuda_ms(lambda: FLN.layernorm(p, x)),
           cuda_ms(lambda: FLN.layernorm_reference(p, x)), bound_layernorm_fwd(n, d),
           cuda_ms(lambda: F.layer_norm(x, (d,), p["scale"], p["bias"], 1e-6)), "F.layer_norm")


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
        counts = sorted({c for _, c in FLN.bwd_bands(n, FLN.band_count(plan))})
        ring = {"streamed": f"streamed in chunks of {plan.get('chunk')} columns",
                "cluster": f"clusters of {plan.get('cluster')} CTAs, {plan.get('slots')} ring "
                           "slots of a row"}.get(plan["route"],
                                                 f"{plan['stages']} stages of {plan['rows']} rows")
        case = (f"[{n},{d}] {plan['ctas']} CTAs, bands of {counts} rows, {ring}"
                + (" (ragged)" if ragged else ""))
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


def check_fused_ce(rng, record, n=2048, vocab=262_144, d=1152, label="", out_of_slice=0.0):
    """K6/K7 against their plain versions and beside the library call (F.linear +
    F.cross_entropy on bf16 logits, and its autograd backward to the hidden states);
    record(kernel, case, err, ms, plain_ms, bound, library_ms, library). The default
    shape is stage 1's: 4 x 512 caption positions at Gemma3's vocab. ``out_of_slice``:
    the share of labels that are -1, as a model rank's vocab slice sees the labels of
    the other ranks' slices under tensor parallelism (no column matches; the library
    call ignores them, ``ignore_index=-1``)."""
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
    outside = ~ignored & (rng.random(n) < out_of_slice)
    safe = torch.tensor(np.where(ignored, 0, np.where(outside, -1, labels)), dtype=torch.int32,
                        device="cuda")
    g = np.where(ignored, 0.0, rng.uniform(0.5, 1.5, size=n) / (~ignored).sum())
    g = torch.tensor(g, dtype=torch.float32, device="cuda").to(torch.bfloat16).float()
    case = f"{label}[{n},{d}] x [{vocab},{d}] scale {scale:.3g}, 25% ignored, g per row"
    if out_of_slice:
        case += (f", {outside.sum() / (~ignored).sum():.0%} of the supervised labels -1 "
                 "(outside the rank's slice)")
    lse, nll = CE.fused_ce_fwd(h, table, safe)
    rlse, rnll = CE.fused_ce_reference(h.float(), table.float(), safe)
    err = max(compare(f"{label}fused ce lse", lse, rlse, atol=CE_ATOL, rtol=0),
              compare(f"{label}fused ce nll", nll[valid], rnll[valid], atol=CE_ATOL, rtol=0))
    if out_of_slice and not torch.equal(nll[safe < 0], lse[safe < 0]):
        raise AssertionError(f"{label}fused ce: a -1 label picked a column")
    long_labels = safe.long()
    record("fused_ce_fwd", case, err, cuda_ms(lambda: CE.fused_ce_fwd(h, table, safe)),
           cuda_ms(lambda: CE.fused_ce_reference(h, table, safe)), bound_fused_ce_fwd(n, vocab, d),
           cuda_ms(lambda: F.cross_entropy(F.linear(h, table), long_labels, reduction="none",
                                           ignore_index=-1)),
           "F.linear + F.cross_entropy(reduction='none'), bf16 logits")
    dh = CE.fused_ce_bwd(h, table, safe, lse, g)
    rdh = CE.fused_ce_bwd_reference(h.float(), table.float(), safe, rlse, g)
    # the softmax part g * sum_v p_v W_v on its own: the one-hot term -g * W[label]
    # is exact in both, and would otherwise set the bound's scale
    onehot = (g * (safe >= 0))[:, None] * table[safe.long().clamp(min=0)].float()
    err = max(compare_rel(f"{label}fused ce dh", dh, rdh),
              compare_rel(f"{label}fused ce dh softmax part", dh + onehot, rdh + onehot))
    if bool(dh[~valid].ne(0).any()):
        raise AssertionError(f"{label}fused ce dh: an ignored position got a gradient")
    hg = h.detach().requires_grad_(True)
    lib_nll = F.cross_entropy(F.linear(hg, table), long_labels, reduction="none",
                              ignore_index=-1)
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


def full_width_config(layers=26):
    """Phase 3's VLM config: ViT-L/16-384, projector 1024 -> 10240 -> 1152, Gemma3-1B
    (``layers`` of its 26)."""
    from projectiontrainer_tpu_torch.models import decoder as dec
    from projectiontrainer_tpu_torch.models import projector as proj
    from projectiontrainer_tpu_torch.models import siglip, vlm

    return vlm.VLMConfig(vision=siglip.vit_l_16_384(),
                         projector=proj.ProjectorConfig(vision_dim=1024, llm_dim=1152),
                         llm=dec.gemma3_config(num_layers=layers))


def full_width_model(layers=26):
    """Phase 3's VLM from the seed: ViT-L/16-384 (bf16), projector 1024 -> 10240 -> 1152
    (fp32), Gemma3-1B (bf16; ``layers`` of its 26: phases 20-21 cut it for run time)."""
    import torch

    from projectiontrainer_tpu_torch.models import vlm

    cfg = full_width_config(layers)
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


def phase_serve_wide_beams(cfg, params, counters, *, nb=24, new_tokens=16):
    """VQAService over phase 3's model at ``--num_beams nb`` (more query rows a KV head
    than one CTA of K3 holds: 2 x 24 beams x 4 heads on Gemma3-1B's one KV head), batch
    2, 2 requests at once, ``new_tokens`` new tokens; every request answered, K1-K3
    launched. Then the same two requests' tokens through the kernel path and the plain
    path (deterministic beam search): equal, or else 4 teacher-forced steps' logits at
    cosine >= 0.9997 on every row."""
    import logging

    import torch

    from projectiontrainer_tpu_torch.cli import infer_vqa_stage2 as vqa
    from projectiontrainer_tpu_torch.cli import serve
    from projectiontrainer_tpu_torch.generate import generate
    from projectiontrainer_tpu_torch.ops import decode_attention as DA

    size = cfg.vision.image_size
    args = serve.build_parser().parse_args([
        "--vision_model_name", "in-memory", "--llm_name", "in-memory", "--projector_path", "",
        "--img_size", str(size), "--batch_size", "2", "--num_beams", str(nb),
        "--repetition_penalty", "1.8", "--length_penalty", "1.2", "--max_q_len", "256",
        "--max_new_tokens", str(new_tokens), "--max_wait_ms", "200",
    ])
    tok = StubTokenizer()
    service = serve.VQAService(args, logging.getLogger("chip_smoke"), model=(cfg, params, tok))
    rng = np.random.default_rng(SEED + 18)
    pixels = np.clip(rng.standard_normal((2, size, size, 3), dtype=np.float32), -1, 1)
    q_tok = [rng.integers(2, cfg.llm.vocab_size, size=int(n)).tolist() for n in (40, 120)]
    answers, errors = [None, None], []

    def client(i):
        try:
            answers[i] = service.submit(serve.Request(pixels[i], q_tok[i]), timeout_s=600)
        except Exception as e:  # reported below: the phase fails
            errors.append(repr(e))

    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    wall = time.perf_counter() - t0
    launches = {c.name: c.value for c in counters}
    service.shutdown()
    if errors or not all(isinstance(a, str) for a in answers):
        raise AssertionError(f"serve {nb} beams: not every request answered {errors[:2]}")
    if not all(launches.values()):
        raise AssertionError(f"serve {nb} beams: a kernel of the path never launched: {launches}")

    gen_cfg = vqa.generation_config(args, tok)

    def prefix(c):
        return vqa.build_prefix(pixels, q_tok, c, params, tok, max_q_len=256)

    with torch.no_grad():
        tokens = [generate(params["llm"], c.llm, *prefix(c), gen_cfg)
                  for c in (cfg, plain_config(cfg))]
    equal = torch.equal(*tokens)
    logits = None
    if not equal:
        teacher = torch.tensor(rng.integers(2, cfg.llm.vocab_size, size=(4, 2 * nb)),
                               device=DEVICE)
        logits = hold_logits(f"serve {nb} beams", teacher_forced(cfg, params, prefix, nb, teacher),
                             teacher_forced(plain_config(cfg), params, prefix, nb, teacher),
                             min_cos=0.9997)
    n_rep = cfg.llm.num_heads // cfg.llm.num_kv_heads
    groups = DA.decode_plan(2, nb, cfg.llm.num_kv_heads, 1, 1, 0, 1, None, n_rep=n_rep,
                            d=cfg.llm.head_dim)["groups"]
    print(f"serve {nb} beams: 2 requests in {wall:.2f} s, kernel-path tokens "
          f"{'equal to' if equal else 'differ from'} the plain path's", flush=True)
    emit({"phase": 3, "leg": f"{nb} beams", "requests": 2, "wall_s": wall,
          "launches": launches, "batch_size": 2, "num_beams": nb, "max_new_tokens": new_tokens,
          "rows_per_kv_head": nb * n_rep, "k3_row_groups": groups,
          "tokens_equal_plain": equal, "logits": logits,
          "answers": answers})
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


def hold_logits(label, kernel_path, plain_path, min_cos=0.99) -> list:
    """Each step's logits of the kernel path against the plain path's: every row's
    cosine >= ``min_cos`` (the argmax agreement reported)."""
    import torch.nn.functional as F

    rows = []
    for i, (a, b) in enumerate(zip(kernel_path, plain_path)):
        if not bool(a.isfinite().all()):
            raise AssertionError(f"{label}: non-finite logits")
        cos = float(F.cosine_similarity(a.float(), b.float(), dim=-1).min())
        top1 = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        rows.append({"step": "prefill" if i == 0 else f"decode {i - 1}", "min_cosine": cos,
                     "top1_agreement": top1})
        if not cos >= min_cos:
            raise AssertionError(f"{label}: {rows[-1]['step']} cosine {cos:.5f} < {min_cos}")
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


# ---------------------------------------------------------------------------- phase 6b


HD_LAYERS = 2       # the head-dim-1024 leg: decoder and tower cut to 2 layers (run time)
HD_STEPS = 3        # its stage-1 steps, each held against the plain path's
HD_NEW_TOKENS = 16  # its 3-beam decode


def head_dim_1024_model():
    """Gemma3-1B's widths (hidden 1152, 4|1 heads, window 512, vocab 262,144) at head dim
    1024 and 2 layers (both sliding), behind the ViT-L/16-384 tower (2 of its 24 layers)
    and the projector 1024 -> 10240 -> 1152, from the seed (the tower and decoder bf16,
    the projector fp32)."""
    import torch

    from projectiontrainer_tpu_torch.models import decoder as dec
    from projectiontrainer_tpu_torch.models import projector as proj
    from projectiontrainer_tpu_torch.models import siglip, vlm

    cfg = vlm.VLMConfig(vision=dataclasses.replace(siglip.vit_l_16_384(), num_layers=HD_LAYERS),
                        projector=proj.ProjectorConfig(vision_dim=1024, llm_dim=1152),
                        llm=dec.gemma3_config(num_layers=HD_LAYERS, head_dim=1024))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = vlm.init(gen, cfg, device="cuda", tower_dtype=torch.bfloat16,
                      projector_dtype=torch.float32)
    return cfg, params


def phase_head_dim_1024(kernel_counters):
    """The head-dim-1024 leg through the entry points a user's run takes: the stage-1
    train step (``train/steps.py:make_train_step`` over ``stage1_loss``, fused CE,
    AdamW on the fp32 projector) for HD_STEPS steps of batch 2 at 575 + 512 tokens
    (K1/K4/K5 on the cluster kernels, K6/K7), each held against
    the plain path (plain
    attention and LayerNorm, chunked CE) at the same params, just before the step: its
    loss within 1e-3 relative and each projector gradient leaf at cosine >= 0.999; then a 3-beam
    decode of HD_NEW_TOKENS tokens (``generate/decode.py:generate``: K1's prefill, K3 at
    head dim 1024) and the prefill logits and HD_NEW_TOKENS teacher-forced 3-beam steps
    of both paths held by ``hold_logits``. The counts of the kernels each path
    launched."""
    import torch
    import torch.nn.functional as F

    from projectiontrainer_tpu_torch.cli import infer_vqa_stage2 as vqa
    from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths
    from projectiontrainer_tpu_torch.generate import decode as D
    from projectiontrainer_tpu_torch.train import masks, optim, steps

    cfg, params = head_dim_1024_model()
    plain = plain_config(cfg)
    batches = [{k: torch.tensor(np.stack([r[k] for r in rows]), device=DEVICE)
                for k in rows[0]}
               for rows in ([CaptionDataset(2, SEED + 30 + i, size=cfg.vision.image_size,
                                            vocab=cfg.llm.vocab_size)[j] for j in range(2)]
                            for i in range(HD_STEPS))]
    labels = masks.stage1_labels(params)
    tx, _ = optim.single_group_optimizer(labels, 1e-4, total_steps=HD_STEPS)
    step = steps.make_train_step(
        steps.stage1_loss(cfg, 0, logits_chunk=128, ce_impl="auto", compute_dtype=torch.bfloat16),
        tx, trainable_mask=masks.bool_mask(labels), watch_subtree="projector")
    plain_loss = steps.stage1_loss(plain, 0, logits_chunk=128, ce_impl="chunked",
                                   compute_dtype=torch.bfloat16)
    state = steps.init_state(params, tx)
    train_launches = {n: 0 for n in kernel_counters}
    plain_launches = dict(train_launches)

    def counted(fn, into):
        for counter in kernel_counters.values():
            counter.reset()
        out = fn()
        torch.cuda.synchronize()
        for n, k in kernel_counters.items():
            into[n] += k.value
        return out

    def plain_grads(batch):
        leaves = dict(leaves_with_paths(params["projector"]))
        for x in leaves.values():
            x.requires_grad_(True)
        loss, _ = plain_loss(params, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return float(loss.detach()), dict(zip(leaves, grads))

    t0 = time.perf_counter()
    rows = []
    for i, batch in enumerate(batches):
        loss_p, grads_p = counted(lambda: plain_grads(batch), plain_launches)
        state, loss_k, aux = counted(lambda: step(state, batch), train_launches)
        loss_k, grads_k = float(loss_k), aux["watched_grads"]
        cos = {p: float(F.cosine_similarity(grads_k[p].flatten().float(),
                                            grads_p[p].flatten().float(), dim=0))
               for p in grads_p}
        rows.append({"step": i, "loss_kernel": loss_k, "loss_plain": loss_p,
                     "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
                     "min_grad_cosine": min(cos.values())})
    train_s = time.perf_counter() - t0
    wanted = ("flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq", "fused_ce_fwd",
              "fused_ce_bwd")
    if not all(train_launches[n] for n in wanted) or any(plain_launches.values()):
        raise AssertionError(f"head dim 1024 train: kernel path {train_launches}, "
                             f"plain {plain_launches}")
    for r in rows:
        if not (np.isfinite(r["loss_kernel"]) and r["loss_rel_diff"] <= LOSS_REL
                and r["min_grad_cosine"] >= COS_MIN):
            raise AssertionError(f"head dim 1024 train: step {r}")

    rng = np.random.default_rng(SEED + 33)
    size, nb = cfg.vision.image_size, 3
    pixels = np.clip(rng.standard_normal((2, size, size, 3), dtype=np.float32), -1, 1)
    q_tok = [rng.integers(2, cfg.llm.vocab_size, size=int(n)).tolist() for n in (40, 90)]
    teacher = torch.tensor(rng.integers(2, cfg.llm.vocab_size, size=(HD_NEW_TOKENS, 2 * nb)),
                           device=DEVICE)

    def prefix(c):
        return vqa.build_prefix(pixels, q_tok, c, params, StubTokenizer(), max_q_len=128)

    for counter in kernel_counters.values():
        counter.reset()
    with torch.no_grad():
        embeds, mask = prefix(cfg)
        tokens = D.generate(params["llm"], cfg.llm, embeds, mask,
                            D.GenerationConfig(max_new_tokens=HD_NEW_TOKENS, num_beams=nb,
                                               eos_token_id=1, pad_token_id=0))
    torch.cuda.synchronize()
    decode_launches = {n: k.value for n, k in kernel_counters.items()}
    if not (decode_launches["flash_attn_fwd"] and decode_launches["decode_attn"]):
        raise AssertionError(f"head dim 1024 decode: kernels {decode_launches}")
    if tokens.shape != (2, HD_NEW_TOKENS):
        raise AssertionError(f"head dim 1024 decode: tokens of shape {tuple(tokens.shape)}")
    logits = hold_logits("head dim 1024 decode", teacher_forced(cfg, params, prefix, nb, teacher),
                         teacher_forced(plain, params, prefix, nb, teacher))
    emit({"phase": "6b", "config": "Gemma3-1B widths at head dim 1024, 2 layers (tower 2 of "
          "24)", "routes": {n: plan_route(n, 1024)["plan_route"]
                            for n in (*wanted[:3], "decode_attn")},
          "train_steps": rows, "train_s": train_s, "launches_train": train_launches,
          "launches_decode": decode_launches, "decode_logits": logits})
    del params
    return {"head_dim_1024_train": train_launches, "head_dim_1024_decode": decode_launches}


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
    if not all(launches_k[n] for n in STAGE0_KERNELS) or any(launches_p.values()):
        raise AssertionError(f"stage 0 end to end: kernel path {launches_k}, plain {launches_p}")
    if not rel <= LOSS_REL:
        raise AssertionError(f"stage 0 end to end: loss {loss_k} vs plain {loss_p}")
    names = [p for p, _ in train]
    versus, _ = hold_gradients("stage 0 end to end", dict(zip(names, grads_k)),
                               dict(zip(names, grads_p)), below="fail")
    emit({"phase": 8, "batch_size": 4, "loss_kernel": loss_k, "loss_plain": loss_p,
          "loss_rel_diff": rel, **versus, "launches_kernel_path": launches_k})


# ---------------------------------------------------------------------------- phase 9


STAGE2_LAYERS = 6   # Gemma3-1B cut from 26 layers in phases 9-10: one sliding period
                    # (run time)


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
        each save's name, bytes and seconds. Only the run's last one (``epoch_1``) is
        written: ``best`` and ``epoch_0`` go through the same code with the same bytes
        (the script's wall: ~24 s)."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.saves = []

        def _save(self, name, state, metadata=None):
            if name != "epoch_1":
                self.saves.append({"name": name, "skipped": True})
                return
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
          f"checkpoints {[(c['name'], round(c['bytes'] / 1e9, 2), round(c['seconds'], 1)) for c in saves if 'bytes' in c]} "
          f"(GB, s; {free_gb:.0f} GB free)", flush=True)
    emit({"phase": 9, "micro_steps": len(losses), "losses": losses, **stats,
          "train_result": result, "wall_s": wall, "leaf_max_change_by_epoch": moved,
          "launches": launches, "launches_one_epoch0_micro_step": one_step,
          "launches_one_epoch0_micro_step_tokens": 575 + longest,
          "batch_size": 1, "accumulation": 8, "peak_memory_gib": peak_gb,
          "kernel_ms_per_micro_step": split, "device_idle_share_steps_6_7": idle,
          "checkpoint_saves": saves, "language_model_bytes": llm_bytes, "disk_free_gb": free_gb,
          "timed_steps": "1-5 (0 warms up, 6-7 profiled)",
          "cut": f"Gemma3-1B cut to {STAGE2_LAYERS} of 26 layers (run time), "
                 "2 epochs of 16 random samples, 2 validation samples, 16 new tokens (a real "
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
    step_kernels = [n for n in STAGE2_KERNELS if n != "decode_attn"]
    if not all(launches_k[n] for n in step_kernels) or any(launches_p.values()):
        raise AssertionError(f"stage 2 end to end: kernel path {launches_k}, plain {launches_p}")
    if not rel <= LOSS_REL:
        raise AssertionError(f"stage 2 end to end: loss {loss_k} vs plain {loss_p}")
    names = [p for p, _ in train]
    # how much of plain bf16 is rounding: (its cosine to fp32, whether its distance to
    # fp32 exceeds the gradient's norm)
    plain_to_fp32 = {}
    for p, b, f in zip(names, grads_p, grads_f):
        if not _key_bias(p):
            b, f = b.float(), f.float()
            plain_to_fp32[p] = (cosine(b, f), float((b - f).norm()) > float(f.norm()))
    del b, f

    def rounding(p):
        return p.startswith("llm/") and p.endswith(ROUNDING_LEAVES)

    versus, cos = hold_gradients("stage 2 end to end", dict(zip(names, grads_k)),
                                 dict(zip(names, grads_p)),
                                 lambda paths: dict(zip(names, grads_f)), below="fail",
                                 by_distance=rounding)
    del grads_k, grads_p, grads_f
    lowest = sorted((p for p in names if rounding(p)), key=lambda p: plain_to_fp32[p][0])[:5]
    groups = ("vision", "projector", "llm")
    emit({"phase": 10, "batch_size": 1, "tokens": 575 + 128 + 512, "loss_kernel": loss_k,
          "loss_plain": loss_p, "loss_rel_diff": rel, **versus,
          "plain_bf16_cos_to_fp32_quantiles_0_10_50_90": [
              float(np.quantile([c for c, _ in plain_to_fp32.values()], q))
              for q in (0, 0.1, 0.5, 0.9)],
          "plain_bf16_error_above_fp32_norm_by_group": {
              g: sum(p.startswith(g + "/") and over for p, (_, over) in plain_to_fp32.items())
              for g in groups},
          "rounding_leaves_lowest_plain_cos_to_fp32": {p: plain_to_fp32[p][0] for p in lowest},
          "table_grad_cosine": cos.get("llm/embed_tokens/embedding"),
          "launches_kernel_path": launches_k})
    check_remat_dots(cfg, params, batch, train)


def check_remat_dots(cfg, params, batch, train):
    """Phase 10 (b): the same batch-1 micro-step on the kernel path (bf16 compute) under
    --remat dots against --remat full: the loss bit-equal, every gradient leaf at cosine
    >= DOTS_COS; the peak memory above the model and the micro-step's ms for each (the
    second of two runs of each)."""
    import torch
    import torch.nn.functional as F

    from projectiontrainer_tpu_torch.train import steps

    runs = {}
    for mode, remat in (("full", True), ("dots", "dots")):
        loss_fn = steps.stage2_loss(cfg, 0, logits_chunk=128, table_frozen=False,
                                    compute_dtype=torch.bfloat16, remat=remat)
        for _ in range(2):
            gc_cuda()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, _ = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, [x for _, x in train])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        runs[mode] = {"loss": loss.detach(), "grads": grads, "ms": ms, "peak_gib": peak}
        del loss, grads
    cos = {p: float(F.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0))
           for (p, _), a, b in zip(train, runs["dots"]["grads"], runs["full"]["grads"])
           if bool(b.ne(0).any())}
    bit_equal_grads = sum(torch.equal(a, b) for a, b in zip(runs["dots"]["grads"],
                                                            runs["full"]["grads"]))
    worst = min(cos, key=cos.get)
    row = {"loss_full": float(runs["full"]["loss"]), "loss_dots": float(runs["dots"]["loss"]),
           "loss_bit_equal": bool(torch.equal(runs["full"]["loss"], runs["dots"]["loss"])),
           "leaves": len(train), "grad_leaves_bit_equal": bit_equal_grads,
           "min_grad_cosine": cos[worst], "min_grad_cosine_leaf": worst,
           "micro_step_ms": {m: r["ms"] for m, r in runs.items()},
           "peak_gib_above_model": {m: r["peak_gib"] for m, r in runs.items()}}
    del runs
    gc_cuda()
    print(f"stage 2 remat dots vs full (batch 1, 1215 tokens): {row['micro_step_ms']} ms, "
          f"peak {row['peak_gib_above_model']} GiB above the model; loss bit-equal "
          f"{row['loss_bit_equal']}, min gradient cosine {cos[worst]:.7f}", flush=True)
    emit({"phase": 10, "remat_dots": row})
    if not row["loss_bit_equal"]:
        raise AssertionError(f"remat dots: loss {row['loss_dots']} vs full {row['loss_full']}")
    if not cos[worst] >= DOTS_COS:
        raise AssertionError(f"remat dots: gradient cosine {cos[worst]} of {worst} < {DOTS_COS}")


# ---------------------------------------------------------------------------- phase 11

# (question bucket, answer bucket) of each group of 4 phase-11 samples: the plan batches
# by bucket, so 32 samples make 8 full micro-steps; the first group is the longest
# bucket, 575 + 256 + 1024 = 1855 tokens
QLORA_LAYERS = 9    # Qwen3-8B cut from 36 layers in phases 11-13 (run time)
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


def qwen3_model(quant_method=None, shard=False, layers=36):
    """The stage-2 QLoRA VLM at full width from seeded random weights: SigLIP
    ViT-L/16-384 (bf16), projector 1024 -> 10240 -> 4096 (fp32), Qwen3-8B (36 layers,
    hidden 4096, MLP 12288, 32/8 heads of 128, vocab 151,936, untied head; bf16). The
    decoder is built one layer at a time and, with ``quant_method``, each layer is
    quantized before the next is drawn, so the dense 16 GB of projections is never
    resident whole. The same seed draws the same dense weights either way. ``shard``
    (a rank of phase 21): each whole layer, once quantized, is sliced to this model
    rank's shard, and so is the rest (``train/setup.py``): the shards of the same model.
    ``layers``: Qwen3-8B's 36, or fewer (phase 21 cuts it for run time)."""
    import torch

    from projectiontrainer_tpu_torch.models import decoder as dec
    from projectiontrainer_tpu_torch.models import projector as proj
    from projectiontrainer_tpu_torch.models import siglip, vlm
    from projectiontrainer_tpu_torch.ops import quant
    from projectiontrainer_tpu_torch.train import setup

    vision, llm_cfg = siglip.vit_l_16_384(), dec.qwen3_config(num_layers=layers)
    cfg = vlm.VLMConfig(vision=vision, llm=llm_cfg, projector=proj.ProjectorConfig(
        vision_dim=vision.hidden_size, llm_dim=llm_cfg.hidden_size))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = {"vision": siglip.init_vision(gen, cfg.vision, torch.bfloat16, DEVICE),
              "projector": proj.init(gen, cfg.projector, torch.float32, DEVICE)}
    llm = dec.init(gen, dataclasses.replace(cfg.llm, num_layers=0, layer_types=()),
                   torch.bfloat16, DEVICE)
    for i in range(cfg.llm.num_layers):
        layer = dec.init_layer(gen, cfg.llm, torch.bfloat16, DEVICE)
        if quant_method is not None:
            layer = quant.quantize_layer(layer, method=quant_method)
        llm["layers"].append(setup.shard_layer(layer, i, cfg.llm) if shard else layer)
    params["llm"] = llm
    return cfg, setup.shard_model(params, cfg) if shard else params


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
          "cut": f"Qwen3-8B cut to {QLORA_LAYERS} of 36 layers (run time), "
                 "8 micro-steps of 32 random samples, 2 validation samples, 16 new tokens (a "
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
    step_kernels = [n for n in STAGE2_QLORA_KERNELS if n != "decode_attn"]
    if not all(launches_k[n] for n in step_kernels) or any(launches_p.values()):
        raise AssertionError(f"QLoRA end to end: kernel path {launches_k}, plain {launches_p}")
    if not rel <= LOSS_REL:
        raise AssertionError(f"QLoRA end to end: loss {loss_k} vs plain {loss_p}")
    # each leaf against plain bf16; where the two bf16 paths differ by more than 0.001
    # (each is ~0.9995 from fp32 at random weights, the A gradients down to 0.998: a sum
    # over 1855 tokens of nearly cancelling terms), the distance rule of hold_gradients
    names = [p for p, _ in train]
    plain_to_fp32 = {p: cosine(b, f) for p, b, f in zip(names, grads_p, grads_f)}
    versus, cos = hold_gradients("QLoRA end to end", dict(zip(names, grads_k)),
                                 dict(zip(names, grads_p)),
                                 lambda paths: dict(zip(names, grads_f)))
    del grads_k, grads_p, grads_f
    for _, x in train:
        x.requires_grad_(False)

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
    emit({"phase": 12, "batch_size": 1, "tokens": 575 + 256 + 1024, "loss_kernel": loss_k,
          "loss_plain": loss_p, "loss_rel_diff": rel, **versus,
          "plain_bf16_cos_to_fp32_quantiles_0_10_50": [
              float(np.quantile(list(plain_to_fp32.values()), q)) for q in (0, 0.1, 0.5)],
          "held_by_distance_plain_cos_to_fp32": {
              p: plain_to_fp32[p] for p in sorted(versus["leaves_below_cos_min"],
                                                  key=cos.get)[:8]},
          "merged_vs_unmerged_row_cosine": row_cos, "merged_vs_unmerged_top1": top1,
          "launches_kernel_path": launches_k})
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
    from projectiontrainer_tpu_torch.train import steps

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
    if not all(launches_k[n] for n in CLS_KERNELS) or any(launches_p.values()):
        raise AssertionError(f"cls end to end: kernel path {launches_k}, plain {launches_p}")
    if not rel <= LOSS_REL:
        raise AssertionError(f"cls end to end: loss {loss_k} vs plain {loss_p}")
    names = [p for p, _ in train]
    to_fp32 = {"kernel": [], "plain": []}
    for p, a, b, f in zip(names, grads_k, grads_p, grads_f):
        if not _zero_sum(p):
            to_fp32["kernel"].append(cosine(a, f))
            to_fp32["plain"].append(cosine(b, f))
    versus, _ = hold_gradients("cls end to end", dict(zip(names, grads_k)),
                               dict(zip(names, grads_p)),
                               lambda paths: dict(zip(names, grads_f)), noise=_zero_sum)
    del grads_k, grads_p, grads_f
    emit({"phase": 15, "batch_size": 8, "loss_kernel": loss_k, "loss_plain": loss_p,
          "loss_rel_diff": rel, **versus,
          "cos_to_fp32_quantiles_0_10_50": {
              k: [float(np.quantile(v, q)) for q in (0, 0.1, 0.5)] for k, v in to_fp32.items()},
          "launches_kernel_path": launches_k})


# ---------------------------------------------------------------------------- phase 16

FEED_SOURCES = 256        # seeded 1024 x 1024 CXR-like JPEG files
FEED_ROW_IMAGES = 64      # images each feed-alone row reads (4 batches of 16; run time)
FEED_ROW_REPEATS = 1      # times each row is timed (one: run time)
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
        write_s = time.perf_counter() - t0
        rows_in = samples[:FEED_ROW_IMAGES]
        cpus = env["cpus"]
        ns = [cpus]  # N = 4, 384 px and 2048 px sources: readings of A8's bench (wall)
        rows = [feed_row(make, rows_in, size=512, augment=a, threads=8) for a in (False, True)]
        for n in ns:
            rows.append(feed_row(make, rows_in, size=512, augment=True, procs=n))
            rows.append(feed_row(make, rows_in, size=512, augment=True, procs=n, omp_threads=1))
            feeder.close_pools()
        aug_rows = [r for r in rows if r["augment"] and r["path"].startswith("procs")]
        best = max(aug_rows, key=lambda r: r["images_per_sec"])
        best_n = int(best["path"].split()[1])
        omp_faster = {n: max((r for r in aug_rows if r["path"] == f"procs {n}"),
                             key=lambda r: r["images_per_sec"])["omp_threads"] for n in ns}
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

        # (b) stage-0 training from the files, augmentation on, on the process feeder at
        # the best N (the feeder's OpenMP setting)
        for c in kernel_counters.values():
            c.reset()
        procs_run = train_from_files(cfg, params, make, samples, procs=best_n,
                                     out_dir=os.path.join(root, "procs"))
        launches = {name: c.value for name, c in kernel_counters.items()}
    finally:
        feeder.close_pools()
        shutil.rmtree(root, ignore_errors=True)
    if not all(launches[n] for n in STAGE0_KERNELS):
        raise AssertionError(f"stage 0 from files: a kernel of the path never launched: "
                             f"{launches}")
    ref, run = stage0_stats or {}, procs_run
    print(f"stage 0 from files ({run['feed']}): {run['images_per_sec']:.3f} images/s, "
          f"{run['step_time_ms']:.1f} ms/step, kernel time {run['kernel_ms']:.1f} ms/step "
          f"(device idle {run['device_idle_share']:.1%}); in memory (phase 7): "
          f"{ref.get('images_per_sec')} images/s, {ref.get('step_time_ms')} ms/step, "
          f"idle {ref.get('device_idle_share')}", flush=True)
    emit({"phase": 16, **procs_run, "launches": launches,
          "in_memory_phase7": ref, "timed_steps": "1-5 (0 warms up, 6-7 profiled)",
          "cut": "8 steps of 128 generated files, validation on 16 (a real run: the caption "
                 "corpus, many epochs)"})
    return launches


def train_from_files(cfg, params, make, samples, *, procs, out_dir):
    """Stage0Trainer.train() as phase 7 runs it, fed from 128 of the files with online
    augmentation on ``procs`` feeder workers, validated on 16 others;
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
    feed = f"{procs} feeder processes"
    if len(losses) != 8 or not np.isfinite(losses).all():
        raise AssertionError(f"stage 0 from files ({feed}): expected 8 finite losses, got "
                             f"{losses}")
    if not all(m > 0 for m in moved.values()):
        raise AssertionError(f"stage 0 from files ({feed}): a trainable leaf did not change: "
                             f"{moved}")
    if train_ds.n_invalid or val_ds.n_invalid:
        raise AssertionError(f"stage 0 from files ({feed}): {train_ds.n_invalid} + "
                             f"{val_ds.n_invalid} invalid samples")
    if [p.num_workers for p in pools] != [procs]:
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
            "num_loader_procs": procs, "omp_threads": pools[0].omp_threads,
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


# ---------------------------------------------------------------------------- phase 20

DP_RANKS = 2
DP_BATCH = 4          # per rank: a global batch of 8
DP_STEPS = 8
DP_STAGE0_BATCH = 8   # per rank
DP_STAGE0_STEPS = 4
DP_STAGE0_LAYERS = 2  # the so400m towers cut from 27 layers each: run time
DP_STAGE1_LAYERS = 6  # Gemma3-1B cut from 26 layers: one sliding period (layer 6 full)
DP_TIMEOUT_S = 420    # the launcher's run, kernels loaded and models built in each rank


def _dp_world(label="data parallel"):
    """(ranks, backend, why, sharing) for phases 20 and 21 on this machine: 2 NCCL ranks
    on 2 cards; 2 gloo ranks sharing one card; 1 NCCL rank where the card's compute mode
    admits one process only."""
    import torch

    n = torch.cuda.device_count()
    listed = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True,
                            timeout=60).stdout.strip()
    modes = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.split()
    print(f"{label}: torch.cuda.device_count() = {n}\n{listed}\ncompute modes {modes}",
          flush=True)
    if n >= DP_RANKS:
        return DP_RANKS, "nccl", f"{n} cards: one NCCL rank on each of 2", False
    if modes and modes[0] == "Exclusive_Process":
        return 1, "nccl", ("the card is in Exclusive_Process mode: two processes cannot "
                           "share it, so one NCCL rank runs and the 2-rank checks are left "
                           "to a machine that allows them"), False
    return DP_RANKS, "gloo", ("one card: 2 ranks share it over gloo (NCCL refuses two "
                              "ranks on one GPU)"), True


def _dp_captions(n, seed):
    """``n`` seeded captions of 32-512 stub tokens (a token a character)."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    return ["".join(rng.choice(letters, size=int(k))) for k in rng.integers(32, 513, size=n)]


def _dp_launch(entry, dump, flags, ranks, backend, timeout=None):
    """The launcher module spawns the ranks; returns its exit code and output."""
    cmd = [sys.executable, "-m", "projectiontrainer_tpu_torch.cli.launch",
           "--nproc_per_node", str(ranks), "--backend", backend, "--timeout", "300",
           "--feeder_procs", "0", "--log_dir", os.path.join(dump, "logs"),
           "--entry", f"chip_smoke:{entry}", "--", "--dump", dump, *flags]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + os.pathsep + env.get(
        "PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout or DP_TIMEOUT_S,
                          env=env)
    return proc.returncode, proc.stdout + proc.stderr, time.perf_counter() - t0


def _port_modules():
    """Every module of the port that a rank's entry may patch, imported (the CLIs, the
    trainers, what they build on); the kernels' check scripts and ``__main__`` left out."""
    import importlib
    import pkgutil

    import projectiontrainer_tpu_torch as pkg

    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if ".check_" not in info.name and not info.name.endswith("__main__"):
            importlib.import_module(info.name)
    return [m for n, m in sorted(sys.modules.items())
            if m is not None and (n == pkg.__name__ or n.startswith(pkg.__name__ + "."))]


def _attribute_state(modules):
    """(object, a copy of its ``__dict__``) for each module and each class defined in one:
    what a leg's patches change, to put back (:func:`_put_back`)."""
    import inspect

    state = []
    for m in modules:
        state.append((m, dict(vars(m))))
        for v in list(vars(m).values()):
            if inspect.isclass(v) and v.__module__ == m.__name__:
                state.append((v, dict(vars(v))))
    return state


def _put_back(state) -> None:
    missing = object()
    for obj, saved in state:
        now = vars(obj)
        for k in [k for k in now if k not in saved]:
            delattr(obj, k)
        for k, v in saved.items():
            if now.get(k, missing) is not v:
                setattr(obj, k, v)


def _run_legs(legs, state):
    """Run [entry name, its argv] legs in turn in this rank, putting back every
    attribute a leg's entry set on the port's modules and classes (``state``, from
    :func:`_attribute_state`) after it and emptying the card's cache; returns each leg's
    wall."""
    import gc

    import torch

    walls = []
    for name, leg_argv in legs:
        t0 = time.perf_counter()
        try:
            globals()[name](leg_argv)
        finally:
            _put_back(state)
            gc.collect()
            torch.cuda.empty_cache()
        walls.append(time.perf_counter() - t0)
    return walls


def legs_rank(argv):
    """A rank that serves the legs of phases 20-23 that share its world, so they share
    their rank processes (one start-up, one CUDA context, one process group, one load
    of the kernels): it waits for ``<--dump>/job<n>.json`` (a JSON list of [entry name,
    its argv], or ``"exit"``), runs the job's legs in turn (:func:`_run_legs`), writes
    ``job<n>.done<rank>.json`` (each leg's wall) and waits for job n + 1."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--dump", required=True)
    args, _ = parser.parse_known_args(argv)
    state = _attribute_state(_port_modules())
    rank = os.environ["RANK"]
    n = 0
    while True:
        path = os.path.join(args.dump, f"job{n}.json")
        while not os.path.exists(path):
            time.sleep(0.05)
        with open(path) as f:
            job = json.load(f)
        if job == "exit":
            return
        walls = _run_legs(job, state)
        tmp = os.path.join(args.dump, f"job{n}.done{rank}.tmp")
        with open(tmp, "w") as f:
            json.dump(walls, f)
        os.replace(tmp, os.path.join(args.dump, f"job{n}.done{rank}.json"))
        n += 1


_SERVERS: dict = {}  # (ranks, backend) -> the launch that serves legs (legs_rank)


def _legs_server(ranks, backend):
    """The running launch of ``ranks`` rank processes over ``backend`` that serves legs,
    started at first use (the launcher's output goes to a file beside its jobs)."""
    key = (ranks, backend)
    server = _SERVERS.get(key)
    if server is not None and server["proc"].poll() is None:
        return server
    root = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    cmd = [sys.executable, "-m", "projectiontrainer_tpu_torch.cli.launch",
           "--nproc_per_node", str(ranks), "--backend", backend, "--timeout", "300",
           "--feeder_procs", "0", "--log_dir", os.path.join(root, "logs"),
           "--entry", "chip_smoke:legs_rank", "--", "--dump", root]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + os.pathsep + env.get(
        "PYTHONPATH", "")
    log = open(os.path.join(root, "launch.log"), "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env)
    server = _SERVERS[key] = {"proc": proc, "root": root, "log": log, "jobs": 0,
                              "ranks": ranks}
    return server


def stop_legs_servers(key=None):
    """Ask every leg server (or the one of ``key`` = (ranks, backend)) to exit, wait for
    it, and remove its files."""
    for k, server in list(_SERVERS.items()):
        if key is not None and k != key:
            continue
        if server["proc"].poll() is None:
            with open(os.path.join(server["root"], f"job{server['jobs']}.json"), "w") as f:
                json.dump("exit", f)
            try:
                server["proc"].wait(timeout=120)
            except subprocess.TimeoutExpired:
                server["proc"].kill()
                server["proc"].wait()
        server["log"].close()
        shutil.rmtree(server["root"], ignore_errors=True)
        del _SERVERS[k]


atexit.register(lambda: [s["proc"].kill() for s in _SERVERS.values() if s["proc"].poll() is None])


def _launch_legs(legs, ranks, backend, timeout):
    """Run ``legs`` ([(entry, dump directory, flags)]) on the leg server of ``ranks``
    ranks over ``backend`` (:func:`_legs_server`), in turn -> (each leg's wall on rank 0,
    the job's wall); raises with the launcher's output if a rank fails or the job
    outlasts ``timeout``."""
    server = _legs_server(ranks, backend)
    n = server["jobs"]
    server["jobs"] += 1
    spec = [[entry, ["--dump", d, *flags]] for entry, d, flags in legs]
    tmp = os.path.join(server["root"], f"job{n}.tmp")
    with open(tmp, "w") as f:
        json.dump(spec, f)
    os.replace(tmp, os.path.join(server["root"], f"job{n}.json"))
    t0 = time.perf_counter()
    done = [os.path.join(server["root"], f"job{n}.done{r}.json") for r in range(ranks)]
    while not all(os.path.exists(p) for p in done):
        if server["proc"].poll() is not None or time.perf_counter() - t0 > timeout:
            if server["proc"].poll() is None:
                server["proc"].kill()
            server["proc"].wait()
            server["log"].flush()
            with open(os.path.join(server["root"], "launch.log")) as f:
                logs = f.read()
            _SERVERS.pop((ranks, backend), None)
            raise AssertionError(f"the ranks' job {[e for e, _, _ in legs]} failed (exit "
                                 f"{server['proc'].returncode}):\n{logs[-8000:]}")
        time.sleep(0.1)
    with open(done[0]) as f:
        walls = json.load(f)
    return walls, time.perf_counter() - t0


def _rank_entry(argv):
    """(the dump directory, the CLI's flags, this rank) for a rank of phase 20."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--dump", required=True)
    args, rest = parser.parse_known_args(argv)
    return args.dump, rest, int(os.environ["RANK"])


def _record_steps(steps_mod, record):
    """Wrap ``steps.make_train_step`` so the rank records each step's loss (the global
    one) and the host time of its gradient all-reduce."""
    from projectiontrainer_tpu_torch.parallel import distributed

    make, reduce = steps_mod.make_train_step, distributed.all_reduce_grads

    def timed_reduce(grads):
        t0 = time.perf_counter()
        reduce(grads)
        record["allreduce_host_ms"].append((time.perf_counter() - t0) * 1e3)

    def recording(*a, **kw):
        step = make(*a, **kw)

        def wrapped(state, batch, rng=None):
            out = step(state, batch, rng)
            record["losses"].append(float(out[1]))
            if record.get("after_first") is None and "projector" in state["params"]:
                record["after_first"] = {p: x.detach().cpu().clone()
                                         for p, x in _projector_leaves(state["params"])}
                record["first_grads"] = {p: g.detach().cpu().clone()
                                         for p, g in out[2]["watched_grads"].items()}
            return out

        return wrapped

    steps_mod.make_train_step = recording
    distributed.all_reduce_grads = timed_reduce


def _sha(leaves) -> str:
    """sha256 of the leaves' bytes, in path order: replicas bit-equal or not."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for _, x in sorted(leaves, key=lambda px: px[0]):
        h.update(x.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def dp_stage1_rank(argv):
    """A rank of phase 20 (b): ``cli/train_stage1.main`` over the JPEG files, the model
    of phase 5 built in the rank from the seed (``setup.build_vlm`` and
    ``setup.load_tokenizer`` replaced: no snapshot, no transformers); dumps the rank's
    losses, launches, projector hash and first update to ``<dump>/rank<r>.pt``."""
    import torch

    from projectiontrainer_tpu_torch.cli import train_stage1
    from projectiontrainer_tpu_torch.train import setup, steps

    dump, flags, rank = _rank_entry(argv)
    built = {}

    def build_vlm(*_, device, **__):
        built["cfg"], built["params"] = full_width_model(DP_STAGE1_LAYERS)
        return built["cfg"], built["params"]

    setup.build_vlm = build_vlm
    setup.load_tokenizer = lambda _: FileTokenizer()
    record = {"losses": [], "allreduce_host_ms": [], "after_first": None, "first_grads": None}
    _record_steps(steps, record)
    kernel_counters = counters()
    for c in kernel_counters.values():
        c.reset()
    result = train_stage1.main(flags)
    torch.cuda.synchronize()
    torch.save({"rank": rank, "losses": record["losses"], "result": result,
                "launches": {n: c.value for n, c in kernel_counters.items()},
                "allreduce_host_ms": record["allreduce_host_ms"],
                "projector_sha256": _sha(_projector_leaves(built["params"])),
                "after_first": record["after_first"] if rank == 0 else None,
                "first_grads": record["first_grads"] if rank == 0 else None},
               os.path.join(dump, f"rank{rank}.pt"))
    return result


def _stage0_dp_model():
    import torch

    from projectiontrainer_tpu_torch.models import siglip

    cfg = siglip.SiglipConfig(
        vision=dataclasses.replace(siglip.so400m_16_512(), num_layers=DP_STAGE0_LAYERS),
        text=dataclasses.replace(siglip.so400m_text(), num_layers=DP_STAGE0_LAYERS))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return cfg, siglip.init(gen, cfg, device="cuda", vision_dtype=torch.float32,
                            text_dtype=torch.bfloat16)


def dp_stage0_rank(argv):
    """A rank of phase 20 (c): ``cli/train_stage0.main`` with --local_negatives over the
    JPEG files, the so400m dual tower cut to DP_STAGE0_LAYERS layers built in the rank
    from the seed; dumps the losses, launches and the trained leaves' hash."""
    import torch

    from projectiontrainer_tpu_torch.cli import train_stage0
    from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
    from projectiontrainer_tpu_torch.train import common, setup, steps

    dump, flags, rank = _rank_entry(argv)
    built = {}

    def load_siglip(*_, **__):
        built["cfg"], built["params"] = _stage0_dp_model()
        return built["cfg"], built["params"]

    place = common.place_params

    def placing(*a, **kw):
        built["plan"] = place(*a, **kw)
        return built["plan"]

    train_stage0.hf_import.load_siglip = load_siglip
    setup.load_tokenizer = lambda _: FileTokenizer()
    common.place_params = placing
    record = {"losses": [], "allreduce_host_ms": []}
    _record_steps(steps, record)
    kernel_counters = counters()
    for c in kernel_counters.values():
        c.reset()
    result = train_stage0.main(flags)
    torch.cuda.synchronize()
    # the trained leaves each rank holds whole (under --fsdp the data shards differ)
    shards = built["plan"].data_sharded
    trained = [(p, x) for p, x in unique_leaves_with_paths(built["params"])
               if not p.startswith("text/") and p not in shards]
    torch.save({"rank": rank, "losses": record["losses"], "result": result,
                "launches": {n: c.value for n, c in kernel_counters.items()},
                "allreduce_host_ms": record["allreduce_host_ms"],
                "data_sharded": len([p for p, _ in unique_leaves_with_paths(built["params"])
                                     if p in shards]),
                "trained_sha256": _sha(trained)}, os.path.join(dump, f"rank{rank}.pt"))
    return result


def _dp_one_process_step(root, samples, flags_cfg):
    """One train step of the 1-process trainer (global batch 8, the same optimizer) on
    the first global batch of the 2-rank run: (loss, projector gradient, projector
    after, projector before)."""
    import torch

    from projectiontrainer_tpu_torch.core.config import Stage1Config
    from projectiontrainer_tpu_torch.data import datasets, pipeline
    from projectiontrainer_tpu_torch.train.trainer_stage1 import Stage1Trainer

    cfg, params = full_width_model(DP_STAGE1_LAYERS)
    before = {p: x.detach().cpu().clone() for p, x in _projector_leaves(params)}
    ds = datasets.Stage1PairDataset(samples, image_root=root, tokenizer=FileTokenizer(),
                                    image_size=cfg.vision.image_size, max_length=512)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_one_")
    try:
        tcfg = Stage1Config(**{**flags_cfg, "output_dir": out_dir,
                               "batch_size": DP_BATCH * DP_RANKS})
        trainer = Stage1Trainer(tcfg, vlm_cfg=cfg, params=params, tokenizer=FileTokenizer(),
                                train_dataset=ds, val_dataset=None)
        # the 2-rank run's first global batch: rank r's first DP_BATCH samples of its
        # round-robin shard
        order = np.concatenate([
            pipeline.host_shard_indices(len(ds), epoch=0, seed=tcfg.seed, process_index=r,
                                        process_count=DP_RANKS)[:DP_BATCH]
            for r in range(DP_RANKS)])
        rows = [ds[int(i)] for i in order]
        batch = {k: torch.tensor(np.stack([r[k] for r in rows]), device=DEVICE)
                 for k in rows[0]}
        _, loss, aux = trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        grads = {p: g.detach().cpu().clone() for p, g in aux["watched_grads"].items()}
        after = {p: x.detach().cpu().clone() for p, x in _projector_leaves(params)}
        del trainer
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return float(loss), grads, after, before


def phase_data_parallel():
    """Phase 20: stage-1 training at full width across ranks through the launcher, then
    stage 0 across ranks; see the module's docstring."""
    import torch
    import torch.nn.functional as F

    ranks, backend, why, sharing = _dp_world()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    label = ("ranks sharing one card, not a scaling figure" if sharing
             else f"{ranks} rank(s), one card each")
    print(f"data parallel: {ranks} rank(s) over {backend}: {why} ({smi})", flush=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        n_train = DP_BATCH * ranks * DP_STEPS
        images = write_cxr_sources(root, n_train + 8, 1024, SEED + 2000)
        samples = [{"image": s["image"], "normal_caption": c}
                   for s, c in zip(images, _dp_captions(len(images), SEED + 2001))]
        for name, part in (("train.json", samples[:n_train]), ("val.json", samples[n_train:])):
            with open(os.path.join(root, name), "w") as f:
                json.dump(part, f)
        flags_cfg = dict(image_root=root, train_json=os.path.join(root, "train.json"),
                         val_json=os.path.join(root, "val.json"), batch_size=DP_BATCH,
                         num_epochs=1, logging_steps=1, num_workers=4, learning_rate=1e-4,
                         save_every_n_epochs=0, disable_wandb=True, seed=SEED, img_size=384,
                         max_caption_len=512, profile_start_step=6, profile_num_steps=2,
                         watch_gradients=True)
        out = os.path.join(root, "stage1")
        flags = [f"--{k}={v}" for k, v in flags_cfg.items() if not isinstance(v, bool)]
        flags += ["--disable_wandb", "--watch_gradients", "--output_dir", out,
                  "--vision_model_name", "seeded",
                  "--llm_name", "seeded", "--profile_dir", os.path.join(out, "profile"),
                  "--mesh_data", "-1"]
        # (c)'s inputs: stage 0 across ranks, the so400m towers cut to DP_STAGE0_LAYERS
        n0 = DP_STAGE0_BATCH * ranks * DP_STAGE0_STEPS
        feed = write_cxr_sources(root, n0 + 16, 1024, SEED + 3000)
        with open(os.path.join(root, "stage0.json"), "w") as f:
            json.dump(feed, f)
        out0 = os.path.join(root, "stage0")
        flags0 = ["--image_root", root, "--train_json", os.path.join(root, "stage0.json"),
                  "--output_dir", out0, "--model_name", "seeded", "--img_size", "512",
                  "--batch_size", str(DP_STAGE0_BATCH), "--num_epochs", "1",
                  "--val_split", str(16 / (n0 + 16)), "--max_text_len", "64",
                  "--logging_steps", "1", "--num_workers", "4", "--disable_wandb",
                  "--seed", str(SEED), "--min_save_epoch", "0", "--local_negatives",
                  "--mesh_data", "-1"]
        dump1, dump0 = (os.path.join(root, d) for d in ("dump_stage1", "dump_stage0"))
        for d in (dump1, dump0):
            os.makedirs(d)
        gc_cuda()
        # both legs on the ranks that phases 21-23 reuse (legs_rank)
        (wall, wall0), _ = _launch_legs([("dp_stage1_rank", dump1, flags),
                                         ("dp_stage0_rank", dump0, flags0)],
                                        ranks, backend, 2 * DP_TIMEOUT_S)
        dumps = [torch.load(os.path.join(dump1, f"rank{r}.pt"), weights_only=False)
                 for r in range(ranks)]
        with open(os.path.join(out, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        split = {k[len("profile/"):]: v for r in rows for k, v in r.items()
                 if k.startswith("profile/")}
        for d in dumps:
            if len(d["losses"]) != DP_STEPS or not np.isfinite(d["losses"]).all():
                raise AssertionError(f"data parallel: rank {d['rank']} losses {d['losses']}")
            if not all(d["launches"][n] for n in STAGE1_KERNELS):
                raise AssertionError(f"data parallel: rank {d['rank']} never launched a kernel "
                                     f"of the path: {d['launches']}")
        if any(d["losses"] != dumps[0]["losses"] for d in dumps):
            raise AssertionError(f"data parallel: the ranks logged different losses: "
                                 f"{[d['losses'] for d in dumps]}")
        if len({d["projector_sha256"] for d in dumps}) != 1:
            raise AssertionError("data parallel: the trained projectors differ across ranks")
        if not os.path.exists(os.path.join(out, "projector_final.bin")):
            raise AssertionError("data parallel: projector_final.bin was not written")
        checks = {"ranks": ranks, "backend": backend, "losses_equal_across_ranks": True,
                  "projector_bit_equal_across_ranks": True}
        if ranks > 1:
            gc_cuda()
            loss_one, grads_one, after_one, before = _dp_one_process_step(
                root, samples[:n_train], flags_cfg)

            def cosine(a, b):  # in fp64: an fp32 sum over 11M products reads ~1e-3 off
                return float(F.cosine_similarity(a.flatten().double(), b.flatten().double(),
                                                 dim=0))

            def update(after):
                return torch.cat([(after[p] - before[p]).flatten() for p in sorted(before)])

            rel = abs(dumps[0]["losses"][0] - loss_one) / abs(loss_one)
            grad_cos = {p: cosine(dumps[0]["first_grads"][p], grads_one[p]) for p in grads_one}
            update_cos = cosine(update(dumps[0]["after_first"]), update(after_one))
            # a reading, not a check: Adam's first update is about lr * sign(gradient),
            # so an element whose gradient is near 0 flips on bf16 rounding (fc2's bias:
            # one element of 1152 costs 0.0017)
            leaf_cos = {p: cosine(dumps[0]["after_first"][p] - before[p],
                                  after_one[p] - before[p]) for p in before}
            checks.update(first_loss_ranks=dumps[0]["losses"][0],
                          first_loss_one_process=loss_one, first_loss_rel_diff=rel,
                          grad_cosine=grad_cos,
                          update_cosine=update_cos, update_cosine_by_leaf=leaf_cos)
            if not rel <= LOSS_REL:
                raise AssertionError(f"data parallel: first loss {dumps[0]['losses'][0]} vs one "
                                     f"process {loss_one}")
            if not min(grad_cos.values()) >= COS_MIN:
                raise AssertionError(f"data parallel: projector gradient cosine {grad_cos}")
            if not update_cos >= COS_MIN:
                raise AssertionError(f"data parallel: projector update cosine {update_cos} "
                                     f"(by leaf {leaf_cos})")
        rates = [d["result"].get("images_per_sec") for d in dumps]
        reduce_ms = [float(np.median(d["allreduce_host_ms"])) if d["allreduce_host_ms"]
                     else None for d in dumps]
        print(f"data parallel stage 1 ({label}; {smi}): images/s per rank {rates}; "
              f"grad_allreduce span {split.get('grad_allreduce_fwd_ms')} ms of kernel time a "
              f"step (rank 0's trace), host time of the all-reduce (median) {reduce_ms} ms",
              flush=True)
        emit({"phase": 20, "part": "stage1", "world": {"ranks": ranks, "backend": backend,
                                                       "why": why, "sharing_one_card": sharing},
              "label": label, "nvidia_smi": smi, "launch_wall_s": wall,
              "losses": dumps[0]["losses"], "images_per_sec_per_rank": rates,
              "step_time_ms_per_rank": [d["result"].get("step_time_ms") for d in dumps],
              "grad_allreduce_kernel_ms_per_step": split.get("grad_allreduce_fwd_ms"),
              "grad_allreduce_host_ms_median": reduce_ms,
              "kernel_ms_per_step": split,
              "launches_per_rank": [d["launches"] for d in dumps], **checks,
              "cut": f"{DP_STEPS} steps of random weights, {n_train} + 8 seeded JPEG files, "
                     f"Gemma3-1B cut to {DP_STAGE1_LAYERS} of 26 layers (run time)"})

        # (c) stage 0 across ranks, the so400m towers cut to DP_STAGE0_LAYERS layers
        dumps0 = [torch.load(os.path.join(dump0, f"rank{r}.pt"), weights_only=False)
                  for r in range(ranks)]
        for d in dumps0:
            if len(d["losses"]) != DP_STAGE0_STEPS or not np.isfinite(d["losses"]).all():
                raise AssertionError(f"data parallel stage 0: rank {d['rank']} losses "
                                     f"{d['losses']}")
            if not all(d["launches"][n] for n in STAGE0_KERNELS):
                raise AssertionError(f"data parallel stage 0: rank {d['rank']} never launched "
                                     f"a kernel of the path: {d['launches']}")
        if any(d["losses"] != dumps0[0]["losses"] for d in dumps0):
            raise AssertionError(f"data parallel stage 0: the ranks logged different losses: "
                                 f"{[d['losses'] for d in dumps0]}")
        if len({d["trained_sha256"] for d in dumps0}) != 1:
            raise AssertionError("data parallel stage 0: the replicas differ after the run")
        rates0 = [d["result"].get("images_per_sec") for d in dumps0]
        print(f"data parallel stage 0 ({label}; {smi}): images/s per rank {rates0}", flush=True)
        emit({"phase": 20, "part": "stage0", "label": label, "nvidia_smi": smi,
              "launch_wall_s": wall0, "losses": dumps0[0]["losses"],
              "images_per_sec_per_rank": rates0,
              "launches_per_rank": [d["launches"] for d in dumps0],
              "replicas_bit_equal": True,
              "cut": f"so400m towers cut to {DP_STAGE0_LAYERS} of 27 layers each (run time), "
                     f"{DP_STAGE0_STEPS} steps at {DP_STAGE0_BATCH} a rank"})
        return {"stage1_dp": dumps[0]["launches"], "stage0_dp": dumps0[0]["launches"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------- phase 21

TP_RANKS = 2
TP_BATCH = 2               # per replica
TP_GROUPS = QLORA_GROUPS[:4]  # 4 micro-steps; the first at 575 + 256 + 1024 = 1855 tokens
TP_STAGE1_BATCH = 4
TP_STAGE1_STEPS = 4
TP_QWEN3_LAYERS = 6        # Qwen3-8B cut from 36 layers: run time
TP_GEMMA_LAYERS = 6        # Gemma3-1B cut from 26 layers: one sliding period (layer 6 full)
TP_TIMEOUT_S = 600         # each launch: kernels loaded and models built in each rank
TP_LORA_B_STD = 0.02       # B drawn off zero (as phase 12): the A gradients are nonzero too
TP_LEAF_COS_FLOOR = 0.99   # a LoRA leaf below COS_MIN: a missed model-axis sum reads ~0.7
TP3_RANKS = 3              # (d): stage 1 at 1 x 3, where the model axis divides only the MLP


def tp_lora(cfg, shard):
    """The QLoRA recipe's adapters (r 16, alpha 32) from the seed, B at std
    TP_LORA_B_STD; with ``shard``, this model rank's shards of the same draw."""
    import torch

    from projectiontrainer_tpu_torch.parallel import sharding
    from projectiontrainer_tpu_torch.train import lora

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    full = lora.init(gen, cfg.llm, lora.LoraConfig(r=16, alpha=32, dropout=0.05),
                     device=DEVICE)
    for layer in full["layers"]:
        for p in layer.values():
            p["b"].normal_(0.0, TP_LORA_B_STD, generator=gen)
    if not shard:
        return full
    return sharding.shard_params(full, sharding.plan_for(full, cfg, prefix="lora"),
                                 prefix="lora")


def tp_vqa_data(cfg):
    """(train, val): phase 11's samples, TP_BATCH of each of the TP_GROUPS buckets, and
    its 2 validation samples."""
    size, vocab = cfg.vision.image_size, cfg.llm.vocab_size
    train = VQASamples(TP_BATCH * len(TP_GROUPS), SEED + 12, size=size, vocab=vocab,
                       lengths=qlora_lengths(SEED + 12, TP_GROUPS, per=TP_BATCH))
    val = VQASamples(2, SEED + 13, size=size, vocab=vocab, lengths=([40, 60], [200, 240]))
    return train, val


def tp_stage2_flags(root, out):
    """The stage-2 CLI flags of phase 21 (b): phase 11's recipe at batch TP_BATCH,
    accumulation 2, one epoch; validation with 3 sampled beams of 16 tokens; step 2
    profiled."""
    return ["--image_root", root, "--train_json", os.path.join(root, "train.json"),
            "--val_json", os.path.join(root, "val.json"), "--output_dir", out,
            "--vision_model_name", "seeded", "--llm_name", "seeded", "--img_size", "384",
            "--batch_size", str(TP_BATCH), "--gradient_accumulation_steps", "2",
            "--num_epochs", "1", "--learning_rate", "1e-5", "--warmup_ratio", "0.05",
            "--max_q_len", "256", "--max_a_len", "1024", "--enable_qlora",
            "--quant_method", "nf4-mirror", "--lora_r", "16", "--lora_alpha", "32",
            "--lora_dropout", "0.05", "--remat", "full", "--mixed_precision", "bf16",
            "--eval_max_new_tokens", "16", "--eval_num_beams", "3", "--logging_steps", "1",
            "--num_workers", "2", "--disable_wandb", "--seed", str(SEED),
            "--profile_dir", os.path.join(out, "profile"), "--profile_start_step", "2",
            "--profile_num_steps", "1"]


def tp_stage1_flags(root, out):
    """The stage-1 CLI flags of phase 21 (c): phase 5's recipe, TP_STAGE1_STEPS steps at
    batch TP_STAGE1_BATCH, validation on 4 samples; step 2 profiled."""
    return ["--image_root", root, "--train_json", os.path.join(root, "s1train.json"),
            "--val_json", os.path.join(root, "s1val.json"), "--output_dir", out,
            "--vision_model_name", "seeded", "--llm_name", "seeded", "--img_size", "384",
            "--batch_size", str(TP_STAGE1_BATCH), "--num_epochs", "1", "--learning_rate",
            "1e-4", "--max_caption_len", "512", "--save_every_n_epochs", "0",
            "--logging_steps", "1", "--num_workers", "2", "--disable_wandb", "--seed",
            str(SEED), "--profile_dir", os.path.join(out, "profile"), "--profile_start_step",
            "2", "--profile_num_steps", "1"]


def _tp3_world():
    """(ranks, backend, why, sharing) for phase 21 (d)'s 1 x 3 mesh: one NCCL rank a card
    on 3 cards or more; else 3 gloo ranks sharing the cards (a rank on card LOCAL_RANK
    modulo the cards); none where a card admits one process only."""
    import torch

    n = torch.cuda.device_count()
    if n >= TP3_RANKS:
        return TP3_RANKS, "nccl", f"{n} cards: one NCCL rank on each of {TP3_RANKS}", False
    modes = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.split()
    if "Exclusive_Process" in modes:
        return 0, "nccl", (f"{n} card(s) in Exclusive_Process mode: {TP3_RANKS} ranks need "
                           f"{TP3_RANKS} cards"), False
    return TP3_RANKS, "gloo", (f"{n} card(s): {TP3_RANKS} gloo ranks share them (NCCL refuses "
                               "two ranks on one GPU)"), True


def _tp_whole(path, g, cfg):
    """A gradient at ``path`` whole: its model rank's shard gathered over the model axis
    (every model rank enters), or itself."""
    from projectiontrainer_tpu_torch.parallel import distributed, sharding

    dim = sharding.sharded_dim(path, sharding.rules_for(cfg)[0])
    if dim is None or distributed.model_size() == 1:
        return g
    return distributed.all_gather_dim(g, dim, distributed.MODEL_AXIS)


def _tp_record(record, cfg_of):
    """Wrap the train step, the optimizer's update and the model-axis all-reduce: each
    micro-step's loss, the collectives of the first micro-step by phase and their host
    time, and the first micro-step's LoRA and projector gradients whole (after the
    model-axis sum of the partial ones)."""
    import torch

    from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp
    from projectiontrainer_tpu_torch.train import optim, steps

    make, update, reduce = steps.make_train_step, optim.MaskedAdamW.update, tp.all_reduce

    def recording(*a, **kw):
        step = make(*a, **kw)

        def wrapped(state, batch, rng=None):
            before = dict(tp.COUNTS)
            record["in_first"] = record["counts_first"] is None
            out = step(state, batch, rng)
            record["losses"].append(float(out[1]))
            if record["in_first"]:
                record["counts_first"] = {k: tp.COUNTS[k] - before[k] for k in before}
            record["in_first"] = False
            return out

        return wrapped

    def capturing(self, grads, state, params):
        if record["first_grads"] is None:
            record["first_grads"] = {
                p: _tp_whole(p, g, cfg_of()).float().cpu() for p, g in grads.items()
                if p.startswith(("lora/", "projector/"))}
        return update(self, grads, state, params)

    def timed(x, phase, op=None):
        t0 = time.perf_counter()
        out = reduce(x, phase, op)
        ms = (time.perf_counter() - t0) * 1e3
        record["allreduce_host_ms"].append(ms)
        if record.get("in_first"):
            record["allreduce_host_ms_first"].append(ms)
        return out

    steps.make_train_step = recording
    optim.MaskedAdamW.update = capturing
    tp.all_reduce = timed


def _tp_new_record():
    return {"losses": [], "counts_first": None, "first_grads": None, "allreduce_host_ms": [],
            "allreduce_host_ms_first": [], "in_first": False}


def _tp_dump(dump, rank, record, result, kernel_counters, cfg, params, trained_prefix):
    """Write a rank's record: losses, launches, collectives, host times, the hash of the
    trained leaves the rules replicate, the first gradients (rank 0)."""
    import torch

    from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
    from projectiontrainer_tpu_torch.parallel import sharding
    from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp

    torch.cuda.synchronize()
    plan = sharding.plan_for(params, cfg)
    replicated = [(p, x) for p, x in unique_leaves_with_paths(params)
                  if p.startswith(trained_prefix) and p not in plan.dims]
    torch.save({"rank": rank, "losses": record["losses"], "result": result,
                "launches": {n: c.value for n, c in kernel_counters.items()},
                "counts_first": record["counts_first"], "counts_total": dict(tp.COUNTS),
                "allreduce_host_ms": record["allreduce_host_ms"],
                "allreduce_host_ms_first": record["allreduce_host_ms_first"],
                "replicated_leaves": len(replicated), "replicated_sha256": _sha(replicated),
                "first_grads": record["first_grads"] if rank == 0 else None},
               os.path.join(dump, f"rank{rank}.pt"))


def tp_stage2_rank(argv):
    """A rank of phase 21 (b): ``cli/train_stage2.main`` with --mesh_model 2 over phase
    11's model, each whole layer built from the seed, quantized and sliced to the rank's
    shard (``setup.build_vlm``, ``setup.load_tokenizer`` and the dataset's ``from_json``
    replaced: no snapshot, no transformers, in-memory samples)."""
    from projectiontrainer_tpu_torch.cli import train_stage2
    from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp
    from projectiontrainer_tpu_torch.train import setup

    dump, flags, rank = _rank_entry(argv)
    built, data = {}, {}

    def build_vlm(*_, device, **__):
        cfg, params = qwen3_model("nf4-mirror", shard=True, layers=TP_QWEN3_LAYERS)
        params["lora"] = tp_lora(cfg, shard=True)
        built["cfg"], built["params"] = cfg, params
        data["train"], data["val"] = tp_vqa_data(cfg)
        return cfg, params

    setup.build_vlm = build_vlm
    setup.load_tokenizer = lambda _: StubTokenizer()
    train_stage2.datasets.Stage2VQADataset.from_json = staticmethod(
        lambda path, **_: data["train" if path.endswith("train.json") else "val"])
    record = _tp_new_record()
    _tp_record(record, lambda: built["cfg"])
    kernel_counters = counters()
    for c in kernel_counters.values():
        c.reset()
    tp.reset_counts()
    result = train_stage2.main(flags)
    _tp_dump(dump, rank, record, result, kernel_counters, built["cfg"], built["params"],
             "lora/")
    return result


def tp_stage1_rank(argv):
    """A rank of phase 21 (c): ``cli/train_stage1.main`` with --mesh_model 2 over phase
    5's model (Gemma3-1B: one KV head, the tied table) sliced to the rank's shards, on
    in-memory captions (the manifest reader and the dataset replaced)."""
    from projectiontrainer_tpu_torch.cli import train_stage1
    from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp
    from projectiontrainer_tpu_torch.train import setup

    dump, flags, rank = _rank_entry(argv)
    built = {}

    def build_vlm(*_, device, **__):
        cfg, params = full_width_model(TP_GEMMA_LAYERS)
        layers = params["llm"]["layers"]
        for i, layer in enumerate(layers):
            layers[i] = setup.shard_layer(layer, i, cfg.llm)
        built["cfg"], built["params"] = cfg, setup.shard_model(params, cfg)
        return cfg, built["params"]

    setup.build_vlm = build_vlm
    setup.load_tokenizer = lambda _: StubTokenizer()
    _tp_stage1_data(train_stage1.datasets)
    record = _tp_new_record()
    _tp_record(record, lambda: built["cfg"])
    kernel_counters = counters()
    for c in kernel_counters.values():
        c.reset()
    tp.reset_counts()
    result = train_stage1.main(flags)
    _tp_dump(dump, rank, record, result, kernel_counters, built["cfg"], built["params"],
             "projector/")
    return result


def _tp_stage1_data(datasets_mod):
    """Stage 1's manifests and dataset as in-memory captions: TP_STAGE1_BATCH x
    TP_STAGE1_STEPS training samples and 4 validation ones."""
    n = {"s1train.json": TP_STAGE1_BATCH * TP_STAGE1_STEPS, "s1val.json": 4}
    datasets_mod.load_manifest = lambda path: [{"i": i} for i in range(
        n[os.path.basename(path)])]
    datasets_mod.Stage1PairDataset = lambda samples, **_: CaptionDataset(
        len(samples), SEED + 30 + len(samples), size=384, vocab=262_144)


def _tp_check(label, dumps, kernels):
    """The checks every rank's record must pass: finite losses, bit-equal across the
    ranks; the replicated trained leaves bit-equal; each kernel of the path launched."""
    for d in dumps:
        if not d["losses"] or not np.isfinite(d["losses"]).all():
            raise AssertionError(f"tensor parallel {label}: rank {d['rank']} losses "
                                 f"{d['losses']}")
        if not all(d["launches"][n] for n in kernels):
            raise AssertionError(f"tensor parallel {label}: rank {d['rank']} never launched "
                                 f"a kernel of the path: {d['launches']}")
    if any(d["losses"] != dumps[0]["losses"] for d in dumps):
        raise AssertionError(f"tensor parallel {label}: the ranks logged different losses: "
                             f"{[d['losses'] for d in dumps]}")
    if len({d["replicated_sha256"] for d in dumps}) != 1 or not dumps[0]["replicated_leaves"]:
        raise AssertionError(f"tensor parallel {label}: the replicated trained leaves differ "
                             "across the ranks")


def _tp_against_one_process(label, first_loss, grads_tp, loss_one, grads_one):
    """The first micro-step of the ranks against one process: the loss within LOSS_REL,
    the gradients by ``hold_gradients``'s group rule; returns the readings."""
    rel = abs(first_loss - loss_one) / abs(loss_one)
    if not rel <= LOSS_REL:
        raise AssertionError(f"tensor parallel {label}: first loss {first_loss} vs one "
                             f"process {loss_one}")
    versus, _ = hold_gradients(f"tensor parallel {label}", grads_tp, grads_one, below="group")
    return {"first_loss_ranks": first_loss, "first_loss_one_process": loss_one,
            "first_loss_rel_diff": rel, **versus}


def _tp_one_process_stage2(root):
    """Phase 21 (b)'s first micro-step in one process (the trainer of phase 11 on the
    whole model): (loss, the LoRA gradients)."""
    import torch

    from projectiontrainer_tpu_torch.core.config import Stage2Config, from_args, parser_for
    from projectiontrainer_tpu_torch.train.trainer_stage2 import Stage2Trainer

    cfg, params = qwen3_model("nf4-mirror", layers=TP_QWEN3_LAYERS)
    params["lora"] = tp_lora(cfg, shard=False)
    train, val = tp_vqa_data(cfg)
    out = tempfile.mkdtemp(prefix="chip_smoke_tp_one_")
    record = _tp_new_record()
    try:
        tcfg = from_args(Stage2Config, parser_for(Stage2Config, "").parse_args(
            tp_stage2_flags(root, out)[:-6]))
        tcfg.device = DEVICE
        trainer = Stage2Trainer(tcfg, vlm_cfg=cfg, params=params, tokenizer=StubTokenizer(),
                                train_dataset=train, val_dataset=None)
        batch = next(iter(trainer._feed(train, trainer._train_plans[0])))
        _tp_record(record, lambda: cfg)
        _, loss, _ = trainer._steps[False][0](trainer.state, batch, 0)
        torch.cuda.synchronize()
        del trainer
    finally:
        _tp_unrecord()
        shutil.rmtree(out, ignore_errors=True)
    return float(loss), record["first_grads"]


def _tp_one_process_stage1(root):
    """Phase 21 (c)'s first step in one process: (loss, the projector gradients)."""
    import torch

    from projectiontrainer_tpu_torch.core.config import Stage1Config, from_args, parser_for
    from projectiontrainer_tpu_torch.data import datasets
    from projectiontrainer_tpu_torch.train import common
    from projectiontrainer_tpu_torch.train.trainer_stage1 import Stage1Trainer

    cfg, params = full_width_model(TP_GEMMA_LAYERS)
    out = tempfile.mkdtemp(prefix="chip_smoke_tp_one_s1_")
    saved = datasets.load_manifest, datasets.Stage1PairDataset
    _tp_stage1_data(datasets)
    record = _tp_new_record()
    try:
        tcfg = from_args(Stage1Config, parser_for(Stage1Config, "").parse_args(
            tp_stage1_flags(root, out)[:-6]))
        tcfg.device = DEVICE
        train = datasets.Stage1PairDataset(datasets.load_manifest("s1train.json"))
        trainer = Stage1Trainer(tcfg, vlm_cfg=cfg, params=params, tokenizer=StubTokenizer(),
                                train_dataset=train, val_dataset=None)
        batch = next(iter(common.feed(train, tcfg, epoch=0)))
        _tp_record(record, lambda: cfg)
        _, loss, _ = trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        del trainer
    finally:
        _tp_unrecord()
        datasets.load_manifest, datasets.Stage1PairDataset = saved
        shutil.rmtree(out, ignore_errors=True)
    return float(loss), record["first_grads"]


_TP_ORIGINALS = {}


def _tp_unrecord():
    """Undo ``_tp_record`` in this process."""
    from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp
    from projectiontrainer_tpu_torch.train import optim, steps

    optim.MaskedAdamW.update = _TP_ORIGINALS["update"]
    tp.all_reduce = _TP_ORIGINALS["all_reduce"]
    steps.make_train_step = _TP_ORIGINALS["make_train_step"]


def _tp_split(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {k[len("profile/"):]: v for r in rows for k, v in r.items()
            if k.startswith("profile/")}


def _tp_report(label, dumps, split, wall, smi, world, extra):
    reduce_kernel = {k: v for k, v in split.items() if "tp_allreduce" in k}
    row = {"phase": 21, "part": label, "world": world, "nvidia_smi": smi,
           "launch_wall_s": wall, "losses": dumps[0]["losses"],
           "images_per_sec_per_rank": [d["result"].get("images_per_sec") for d in dumps],
           "step_time_ms_per_rank": [d["result"].get("step_time_ms") for d in dumps],
           "model_axis_collectives_first_micro_step": dumps[0]["counts_first"],
           "model_axis_collectives_whole_run": dumps[0]["counts_total"],
           "tp_allreduce_host_ms_median_per_rank": [
               float(np.median(d["allreduce_host_ms"])) for d in dumps],
           "tp_allreduce_host_ms_first_micro_step_per_rank": [
               float(np.sum(d["allreduce_host_ms_first"])) for d in dumps],
           "tp_allreduce_kernel_ms_step2_rank0": reduce_kernel,
           "kernel_ms_step2_rank0": split, "launches_per_rank": [d["launches"] for d in dumps],
           "replicated_leaves_bit_equal": dumps[0]["replicated_leaves"], **extra}
    print(f"tensor parallel {label} ({world['why']}; {smi}): images/s per rank "
          f"{row['images_per_sec_per_rank']}; model-axis collectives in the first micro-step "
          f"{row['model_axis_collectives_first_micro_step']}; tp_allreduce host ms "
          f"{row['tp_allreduce_host_ms_first_micro_step_per_rank']} in it (median "
          f"{row['tp_allreduce_host_ms_median_per_rank']} a call); kernel ms in step 2 "
          f"{reduce_kernel}", flush=True)
    emit(row)


def phase_tensor_parallel():
    """Phase 21: stage-2 QLoRA over Qwen3-8B and stage 1 over Gemma3-1B with
    --mesh_model 2, and stage 1 over Gemma3-1B with --mesh_model 3, through the
    launcher; see the module's docstring."""
    import torch

    from projectiontrainer_tpu_torch.checkpoint import export
    from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp
    from projectiontrainer_tpu_torch.train import optim, steps

    _TP_ORIGINALS.update(update=optim.MaskedAdamW.update, all_reduce=tp.all_reduce,
                         make_train_step=steps.make_train_step)
    ranks, backend, why, sharing = _dp_world("tensor parallel")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    world = {"ranks": ranks, "backend": backend, "why": why, "sharing_one_card": sharing}
    if ranks < TP_RANKS:
        print(f"tensor parallel: NOT RUN: {why}", flush=True)
        emit({"phase": 21, "ran": False, "why": why, "nvidia_smi": smi})
        return {}
    print(f"tensor parallel: {ranks} model ranks over {backend}: {why} ({smi})", flush=True)
    ranks3, backend3, why3, sharing3 = _tp3_world()
    world3 = {"ranks": ranks3, "backend": backend3, "why": why3, "sharing_one_card": sharing3}
    if ranks3:
        _legs_server(ranks3, backend3)  # (d)'s ranks start while (b) and (c) run
    root = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        # (b) stage-2 QLoRA over Qwen3-8B, 1 x 2, and (c) stage 1 over Gemma3-1B, 1 x 2,
        # in one launch: the ranks start once (legs_rank)
        out = os.path.join(root, "stage2")
        flags = tp_stage2_flags(root, out) + ["--mesh_data", "1", "--mesh_model", "2"]
        out1 = os.path.join(root, "stage1")
        flags1 = tp_stage1_flags(root, out1) + ["--mesh_data", "1", "--mesh_model", "2"]
        dump2, dump1 = (os.path.join(root, d) for d in ("dump_stage2", "dump_stage1"))
        for d in (dump2, dump1):
            os.makedirs(d)
        gc_cuda()
        (wall, wall1), _ = _launch_legs([("tp_stage2_rank", dump2, flags),
                                         ("tp_stage1_rank", dump1, flags1)],
                                        ranks, backend, 2 * TP_TIMEOUT_S)
        dumps = [torch.load(os.path.join(dump2, f"rank{r}.pt"), weights_only=False)
                 for r in range(ranks)]
        _tp_check("stage 2", dumps, STAGE2_QLORA_KERNELS)
        if len(dumps[0]["losses"]) != len(TP_GROUPS):
            raise AssertionError(f"tensor parallel stage 2: {dumps[0]['losses']}")
        lm = os.path.join(out, "checkpoint-epoch_0", "language_model")
        lora_loaded, lcfg = export.load_adapter(lm)
        q_b = lora_loaded["layers"][0]["q_proj"]["b"]
        if tuple(q_b.shape) != (4096, 16) or lcfg.r != 16:
            raise AssertionError(f"tensor parallel: the adapter's q_proj B is {q_b.shape}")
        examples = os.listdir(os.path.join(out, "validation_examples"))
        split = _tp_split(out)
        grads_tp = dumps[0]["first_grads"]
        gc_cuda()
        loss_one, grads_one = _tp_one_process_stage2(root)
        versus = _tp_against_one_process("stage 2", dumps[0]["losses"][0], grads_tp, loss_one,
                                         grads_one)
        del grads_tp, grads_one
        gc_cuda()
        _tp_report("stage2_qlora", dumps, split, wall, smi, world, {
            "adapter_loads_in_one_process": True, "validation_examples": examples, **versus,
            "cut": f"Qwen3-8B cut to {TP_QWEN3_LAYERS} of 36 layers (run time), "
                   f"{len(TP_GROUPS)} micro-steps of {TP_BATCH} samples (accumulation 2) up "
                   "to 1855 tokens, 2 validation samples with 3 beams of 16 tokens (a real "
                   "run: 4 x 2 ranks, the VQA corpus, 3 epochs, accumulation 8)"})
        launches = {"stage2_qlora_tp_rank0": dumps[0]["launches"]}

        # (c) stage 1 over Gemma3-1B, 1 x 2
        out, wall = out1, wall1
        dumps = [torch.load(os.path.join(dump1, f"rank{r}.pt"), weights_only=False)
                 for r in range(ranks)]
        _tp_check("stage 1", dumps, STAGE1_KERNELS)
        if len(dumps[0]["losses"]) != TP_STAGE1_STEPS:
            raise AssertionError(f"tensor parallel stage 1: {dumps[0]['losses']}")
        if not os.path.exists(os.path.join(out, "projector_final.bin")):
            raise AssertionError("tensor parallel stage 1: projector_final.bin not written")
        exported = torch.load(os.path.join(out, "projector_final.bin"), weights_only=True)
        if tuple(exported["model.0.weight"].shape) != (10240, 1024):
            raise AssertionError(f"tensor parallel stage 1: exported fc1 "
                                 f"{exported['model.0.weight'].shape}")
        split = _tp_split(out)
        grads_tp = dumps[0]["first_grads"]
        gc_cuda()
        loss_one, grads_one = _tp_one_process_stage1(root)
        versus = _tp_against_one_process("stage 1", dumps[0]["losses"][0], grads_tp, loss_one,
                                         grads_one)
        gc_cuda()
        cut = (f"Gemma3-1B cut to {TP_GEMMA_LAYERS} of 26 layers (run time), "
               f"{TP_STAGE1_STEPS} steps at batch {TP_STAGE1_BATCH}, 4 validation samples (a "
               "real run: the caption corpus, many epochs)")
        _tp_report("stage1", dumps, split, wall, smi, world, {
            "projector_exported_whole": True, **versus, "cut": cut})
        launches["stage1_tp_rank0"] = dumps[0]["launches"]

        # (d) stage 1 over Gemma3-1B at 1 x 3: the model axis divides the decoder's MLP
        # (6912 = 3 x 2304) alone; the tower, the attention, the projector and the vocab
        # run whole on every rank (held against (c)'s one-process step)
        if not ranks3:
            print(f"tensor parallel stage 1 at 1 x 3: NOT RUN: {why3}", flush=True)
            emit({"phase": 21, "part": "stage1_1x3", "ran": False, "why": why3,
                  "nvidia_smi": smi})
            return launches
        out = os.path.join(root, "stage1_1x3")
        dump3 = os.path.join(root, "dump_stage1_1x3")
        os.makedirs(dump3)
        flags3 = tp_stage1_flags(root, out) + ["--mesh_data", "1", "--mesh_model",
                                               str(ranks3)]
        (wall,), _ = _launch_legs([("tp_stage1_rank", dump3, flags3)], ranks3, backend3,
                                  TP_TIMEOUT_S)
        stop_legs_servers((ranks3, backend3))
        dumps = [torch.load(os.path.join(dump3, f"rank{r}.pt"), weights_only=False)
                 for r in range(ranks3)]
        _tp_check("stage 1 at 1 x 3", dumps, STAGE1_KERNELS)
        if len(dumps[0]["losses"]) != TP_STAGE1_STEPS:
            raise AssertionError(f"tensor parallel stage 1 at 1 x 3: {dumps[0]['losses']}")
        exported = torch.load(os.path.join(out, "projector_final.bin"), weights_only=True)
        if tuple(exported["model.0.weight"].shape) != (10240, 1024):
            raise AssertionError(f"tensor parallel stage 1 at 1 x 3: exported fc1 "
                                 f"{exported['model.0.weight'].shape}")
        versus = _tp_against_one_process("stage 1 at 1 x 3", dumps[0]["losses"][0],
                                         dumps[0]["first_grads"], loss_one, grads_one)
        del grads_one
        gc_cuda()
        from projectiontrainer_tpu_torch.parallel import sharding

        whole = sharding.check_config(full_width_config(TP_GEMMA_LAYERS), ranks3)
        _tp_report("stage1_1x3", dumps, _tp_split(out), wall, smi, world3, {
            "projector_exported_whole": True, "whole_units": whole, **versus, "cut": cut})
        for r, d in enumerate(dumps):
            launches[f"stage1_tp3_rank{r}"] = d["launches"]
        return launches
    finally:
        stop_legs_servers((ranks3, backend3))
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------- phase 22

FSDP_LAYERS_SHARING = 2   # Gemma3-4B's 34 layers cut to 2 (both sliding) when the
                          # ranks share one card (run time: the script's 1200 s)
FSDP_TOWER_LAYERS_SHARING = 2  # and the ViT-L tower's 24 layers
FSDP_SAMPLES = 4          # an epoch: 2 micro-steps of batch 1 on each of 2 ranks (cut
                          # from 4 for run time: the script's 1200 s)
FSDP_TIMEOUT_S = 900      # the launch: kernels loaded, the model built in each rank
FSDP_DISK_BYTES = 40e9    # beyond this phase 22's files go to /dev/shm first


def fsdp_config(layers):
    """BASELINE config #4's VLM (ViT-L/16-384, projector 1024 -> 10240 -> 2560, Gemma3-4B)
    at full width with ``layers`` decoder layers; below the full 34 (ranks sharing one
    card) the tower is cut to FSDP_TOWER_LAYERS_SHARING of its 24 layers too."""
    from projectiontrainer_tpu_torch.models import vlm

    cfg = vlm.full_joint_4b_config(num_layers=layers)
    if layers < 34:
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
            cfg.vision, num_layers=FSDP_TOWER_LAYERS_SHARING))
    return cfg


def fsdp_model(layers):
    """``fsdp_config(layers)``'s VLM from the seed: the towers bf16 (the decoder drawn
    layer after layer), the projector fp32."""
    import torch

    from projectiontrainer_tpu_torch.models import vlm

    cfg = fsdp_config(layers)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return cfg, vlm.init(gen, cfg, device="cuda", tower_dtype=torch.bfloat16,
                         projector_dtype=torch.float32)


def _fsdp_scratch_root(layers):
    """A temp directory with room for phase 22's files (the gathered train state, the
    exported decoder and the dumped first gradients: ~24 bytes a parameter, ~100 GB at
    the full 34 layers): under the default temp dir, or, for more than FSDP_DISK_BYTES,
    under the memory-backed /dev/shm first (a disk may cap the bytes written to it)."""
    import torch

    from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
    from projectiontrainer_tpu_torch.models import vlm

    shapes = vlm.init(torch.Generator(), fsdp_config(layers), device="meta")
    need = 24 * sum(x.numel() for _, x in unique_leaves_with_paths(shapes))
    order = (tempfile.gettempdir(), "/dev/shm")
    for d in (order if need <= FSDP_DISK_BYTES else order[::-1]):
        if os.path.isdir(d) and shutil.disk_usage(d).free > need:
            return tempfile.mkdtemp(prefix="chip_smoke_fsdp_", dir=d)
    raise AssertionError(f"fsdp: no directory with {need / 1e9:.0f} GB free")


def fsdp_vqa_data(cfg):
    """(train, val): FSDP_SAMPLES samples at the longest bucket of phase 9's recipe (128
    question and 512 answer tokens: 1215 with the 575 visual ones) and 2 validation
    samples."""
    size, vocab = cfg.vision.image_size, cfg.llm.vocab_size
    n = FSDP_SAMPLES
    train = VQASamples(n, SEED + 22, size=size, vocab=vocab, lengths=([128] * n, [512] * n))
    val = VQASamples(2, SEED + 23, size=size, vocab=vocab, lengths=([40, 60], [200, 240]))
    return train, val


def fsdp_stage2_flags(root, out):
    """The stage-2 CLI flags of phase 22 (b): BASELINE config #4's full-joint recipe with
    --fsdp, batch 1 a rank, accumulation 2, 2 epochs (the tower's freeze crossed),
    validation with 3 sampled beams of 16 tokens."""
    return ["--image_root", root, "--train_json", os.path.join(root, "train.json"),
            "--val_json", os.path.join(root, "val.json"), "--output_dir", out,
            "--vision_model_name", "seeded", "--llm_name", "seeded", "--img_size", "384",
            "--batch_size", "1", "--gradient_accumulation_steps", "2", "--num_epochs", "2",
            "--learning_rate", "1e-5", "--warmup_ratio", "0.05", "--max_q_len", "128",
            "--max_a_len", "512", "--unfreeze_llm", "--unfreeze_projection_layer",
            "--train_ve_first_epoch", "--master_dtype", "fp32", "--remat", "full",
            "--mixed_precision", "bf16", "--eval_max_new_tokens", "16",
            "--eval_num_beams", "3", "--logging_steps", "1", "--num_workers", "2",
            "--disable_wandb", "--seed", str(SEED), "--fsdp"]


def _fsdp_first_batch(trainer):
    """The first micro-step's batch of the trainer's epoch-0 plan (this rank's rows)."""
    return next(iter(trainer._feed(trainer.train_dataset, trainer._train_plans[0])))


def _fsdp_micro_step(trainer, batch, remat):
    """The loss and gradient of every trainable leaf (the epoch-0 step's: tower included)
    under ``remat``, the shards gathered as the train step gathers them; no update.
    Returns (peak live gathered bytes, the card's peak bytes above the start)."""
    import torch

    from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
    from projectiontrainer_tpu_torch.parallel import fsdp
    from projectiontrainer_tpu_torch.train import steps

    loss_fn = steps.stage2_loss(trainer.vlm_cfg, trainer.pad_id, logits_chunk=128,
                                table_frozen=False, compute_dtype=trainer.compute_dtype,
                                remat=remat)
    train = [x for _, x in unique_leaves_with_paths(trainer.state["params"])
             if x.is_floating_point()]
    for x in train:
        x.requires_grad_(True)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fsdp.track(True)
    with fsdp.active(trainer.plan):
        loss, _ = loss_fn(trainer.state["params"], batch, None)
        grads = torch.autograd.grad(loss, train, allow_unused=True)
    torch.cuda.synchronize()
    del loss, grads
    live = fsdp.LIVE["peak"]
    fsdp.track(False)
    return live, torch.cuda.max_memory_allocated() - start


def fsdp_stage2_rank(argv):
    """A rank of phase 22 (b): ``cli/train_stage2.main`` with --fsdp over BASELINE config
    #4's model from the seed (``setup.build_vlm``, ``setup.load_tokenizer`` and the
    dataset's ``from_json`` replaced: no snapshot, no transformers, in-memory samples);
    the train state and the exports are written after the last epoch only, no best
    checkpoint (run time: each is the whole state). The first micro-step's live
    gathered bytes and peak memory are recorded (remat full), the second is profiled on
    every rank (the collectives' kernel time); after the run one more micro-step under
    'dots' (the gathered weights it keeps), then the rank dumps its record."""
    import argparse

    import torch

    from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
    from projectiontrainer_tpu_torch.cli import train_stage2
    from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
    from projectiontrainer_tpu_torch.parallel import distributed, fsdp
    from projectiontrainer_tpu_torch.train import optim, setup, steps
    from projectiontrainer_tpu_torch.train.trainer_stage2 import Stage2Trainer
    from projectiontrainer_tpu_torch.utils import timing

    parser = argparse.ArgumentParser()
    parser.add_argument("--layers", type=int, required=True)
    own, rest = parser.parse_known_args(argv)
    dump, flags, rank = _rank_entry(rest)
    built, data = {}, {}

    def build_vlm(*_, device, **__):
        cfg, params = fsdp_model(own.layers)
        built["cfg"] = cfg
        data["train"], data["val"] = fsdp_vqa_data(cfg)
        return cfg, params

    setup.build_vlm = build_vlm
    setup.load_tokenizer = lambda _: StubTokenizer()
    train_stage2.datasets.Stage2VQADataset.from_json = staticmethod(
        lambda path, **_: data["train" if path.endswith("train.json") else "val"])
    save_checkpoint, init = Stage2Trainer.save_checkpoint, Stage2Trainer.__init__

    def last_epoch_only(self, epoch):
        if epoch == self.cfg.num_epochs - 1:
            save_checkpoint(self, epoch)

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        built["trainer"] = self

    Stage2Trainer.save_checkpoint = last_epoch_only
    Stage2Trainer.__init__ = keep
    CheckpointManager.save_best = lambda self, *a, **kw: False

    record = {"losses": [], "counts_first": None, "bytes_first": None, "first_grads": None,
              "launches_first": None, "gather_host_ms": [], "reduce_scatter_host_ms": [],
              "live_first": None, "peak_first": None, "split": None,
              "collectives_apply": None, "peak_before_apply": 0, "peak_apply": None}
    kernel_counters = counters()
    make, update = steps.make_train_step, optim.MaskedAdamW.update
    gather, scatter = fsdp._all_gather, fsdp._reduce_scatter

    def recording(*a, **kw):
        step = make(*a, **kw)

        def wrapped(state, batch, rng=None):
            first, profiled = not record["losses"], len(record["losses"]) == 1
            if first:
                counts, nbytes = dict(fsdp.COUNTS), dict(fsdp.BYTES)
                launched = {n: c.value for n, c in kernel_counters.items()}
                torch.cuda.synchronize()
                start = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fsdp.track(True)
            if profiled:  # the applying micro-step (accumulation 2)
                distributed.reset_collectives()
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                # its peak, from what the trainer holds before it (phase 24's budget)
                torch.cuda.synchronize()
                record["peak_before_apply"] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            out = step(state, batch, rng)
            if profiled:
                record["collectives_apply"] = distributed.collective_inventory()
                torch.cuda.synchronize()
                record["peak_apply"] = torch.cuda.max_memory_allocated()
            record["losses"].append(float(out[1]))  # a host sync
            if first:
                record["counts_first"] = {k: fsdp.COUNTS[k] - counts[k] for k in counts}
                record["bytes_first"] = {k: fsdp.BYTES[k] - nbytes[k] for k in nbytes}
                record["launches_first"] = {n: c.value - launched[n]
                                            for n, c in kernel_counters.items()}
                record["live_first"] = fsdp.LIVE["peak"]
                record["peak_first"] = torch.cuda.max_memory_allocated() - start
                fsdp.track(False)
            if profiled:
                torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                record["split"] = timing.span_times(prof.events(), device=True)
            return out

        return wrapped

    def capturing(self, grads, state, params):
        if record["first_grads"] is None:  # the first micro-step's gradients, whole
            plan, whole = built["trainer"].plan, {}
            for p, g in grads.items():  # a collective every rank enters, leaf by leaf
                g = plan.gather(p, g)
                if rank == 0:
                    whole[p] = g.float().cpu()
            record["first_grads"] = whole
        return update(self, grads, state, params)

    def timed(fn, key):
        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            record[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    steps.make_train_step = recording
    optim.MaskedAdamW.update = capturing
    fsdp._all_gather = timed(gather, "gather_host_ms")
    fsdp._reduce_scatter = timed(scatter, "reduce_scatter_host_ms")
    for c in kernel_counters.values():
        c.reset()
    fsdp.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    result = train_stage2.main(flags)
    torch.cuda.synchronize()
    peak = max(torch.cuda.max_memory_allocated(), record["peak_before_apply"])
    launches = {n: c.value for n, c in kernel_counters.items()}
    counts_run = dict(fsdp.COUNTS)
    trainer = built["trainer"]
    plan, params = trainer.plan, trainer.state["params"]
    leaves = dict(unique_leaves_with_paths(params))
    slots = [x for v in trainer.state["opt_state"].values() if isinstance(v, dict)
             for x in v.values()]
    local = sum(x.numel() * x.element_size() for x in list(leaves.values()) + slots)
    data_n = plan.data
    whole = sum(x.numel() * x.element_size() * (data_n if p in plan.data_sharded else 1)
                for v in [leaves] + [v for v in trainer.state["opt_state"].values()
                                     if isinstance(v, dict)] for p, x in v.items())
    residue = sum(x.numel() * x.element_size()
                  for v in [leaves] + [v for v in trainer.state["opt_state"].values()
                                       if isinstance(v, dict)]
                  for p, x in v.items() if p not in plan.data_sharded)
    replicated = [(p, x) for p, x in leaves.items() if p not in plan.data_sharded]
    # remat 'dots' against the run's full remat: one more micro-step on the first batch
    live, above = _fsdp_micro_step(trainer, _fsdp_first_batch(trainer), "dots")
    remat = {"full": {"live_gathered_peak_bytes": record["live_first"],
                      "peak_bytes_above_state": record["peak_first"]},
             "dots": {"live_gathered_peak_bytes": live, "peak_bytes_above_state": above}}
    torch.save({"rank": rank, "losses": record["losses"], "result": result,
                "launches": launches, "launches_first": record["launches_first"],
                "counts_first": record["counts_first"], "bytes_first": record["bytes_first"],
                "counts_run": counts_run, "gather_host_ms": record["gather_host_ms"],
                "collectives_apply": record["collectives_apply"],
                "peak_apply": record["peak_apply"],
                "reduce_scatter_host_ms": record["reduce_scatter_host_ms"],
                "peak_memory_bytes": peak, "state_bytes_local": local,
                "state_bytes_whole": whole, "state_bytes_residue": residue,
                "data_sharded_leaves": len([p for p in leaves if p in plan.data_sharded]),
                "leaves": len(leaves), "replicated_sha256": _sha(replicated),
                "replicated_leaves": len(replicated), "remat": remat,
                "span_kernel_ms_micro_step_2": record["split"],
                "whole_shapes": {p: _whole_shape(plan, p, x) for p, x in leaves.items()},
                "first_grads": record["first_grads"] if rank == 0 else None},
               os.path.join(dump, f"rank{rank}.pt"))
    return result


def _whole_shape(plan, path, x) -> tuple:
    """The shape of the leaf ``x`` at ``path`` whole over the data axis."""
    shape = list(x.shape)
    if path in plan.data_sharded:
        shape[plan.data_dims[path]] *= plan.data
    return tuple(shape)


def _fsdp_one_process(layers, ranks, kernel_counters):
    """The first micro-step in this process on the whole model (the trainer's masters:
    fp32 tower, projector and decoder, bf16 compute, the loss of ``steps.stage2_loss``;
    no optimizer, whose state is what --fsdp shards) on the ranks' first global batch:
    (loss, every gradient in bf16 compute, the q/k RMSNorm scales' gradients through
    the plain path in fp32)."""
    import torch

    from projectiontrainer_tpu_torch.core import dtypes
    from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
    from projectiontrainer_tpu_torch.data import bucketing
    from projectiontrainer_tpu_torch.data import pipeline as pipe
    from projectiontrainer_tpu_torch.train import steps

    cfg, params = fsdp_model(layers)
    for k in ("vision", "llm"):
        params[k] = dtypes.cast_compute_params(params[k], torch.float32)
    train, _ = fsdp_vqa_data(cfg)
    q_lens, a_lens = train.token_lengths()
    plan = bucketing.global_bucket_plan(
        q_lens, a_lens, batch_size=ranks, epoch=0, seed=SEED,
        q_buckets=bucketing.buckets_covering(128, bucketing.DEFAULT_Q_BUCKETS),
        a_buckets=bucketing.buckets_covering(512, bucketing.DEFAULT_A_BUCKETS))
    batch = next(iter(pipe.planned_epoch_batches(train, plan, pad_id=0, device=DEVICE,
                                                 num_workers=2)))
    leaves = list(unique_leaves_with_paths(params))
    for _, x in leaves:
        x.requires_grad_(True)
    for c in kernel_counters.values():
        c.reset()
    loss_fn = steps.stage2_loss(cfg, 0, logits_chunk=128, table_frozen=False,
                                compute_dtype=torch.bfloat16, remat=True)
    loss, _ = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, [x for _, x in leaves])
    grads = {p: g.float().cpu() for (p, _), g in zip(leaves, grads)}
    loss = float(loss.detach())
    launched = {n: c.value for n, c in kernel_counters.items()}
    rounding = [(p, x) for p, x in leaves if p.startswith("llm/") and p.endswith(ROUNDING_LEAVES)]
    for p, x in leaves:
        x.requires_grad_(any(x is y for _, y in rounding))
    plain = steps.stage2_loss(plain_config(cfg), 0, logits_chunk=128, table_frozen=False,
                              compute_dtype=None, remat=True)
    f_loss, _ = plain(params, batch)
    fp32 = torch.autograd.grad(f_loss, [x for _, x in rounding])
    fp32 = {p: g.float().cpu() for (p, _), g in zip(rounding, fp32)}
    del params, leaves, rounding, f_loss
    gc_cuda()
    return loss, grads, fp32, launched


def _fsdp_against_one_process(first_loss, grads_r, loss_one, grads_one, fp32):
    """The ranks' first micro-step against one process: the loss within LOSS_REL; the
    gradients by ``hold_gradients``'s group rule, the q/k RMSNorm scales (``fp32`` holds
    their plain fp32 gradients) by their distance (phase 10's rule)."""
    rel = abs(first_loss - loss_one) / abs(loss_one)
    if not rel <= LOSS_REL:
        raise AssertionError(f"fsdp: first loss {first_loss} vs one process {loss_one}")
    versus, cos = hold_gradients("fsdp", grads_r, grads_one, lambda paths: fp32,
                                 below="group", by_distance=fp32.__contains__)
    return {"first_loss_ranks": first_loss, "first_loss_one_process": loss_one,
            "first_loss_rel_diff": rel, **versus,
            "table_grad_cosine": cos.get("llm/embed_tokens/embedding")}


def _fsdp_world():
    """(ranks, backend, why, sharing, decoder layers): one NCCL rank a card on 2 cards or
    more (4 on 4, at the full 34 layers); 2 gloo ranks sharing one card at
    FSDP_LAYERS_SHARING layers; 1 where the card admits one process."""
    import torch

    ranks, backend, why, sharing = _dp_world("fsdp")
    n = torch.cuda.device_count()
    if backend == "nccl" and n >= 4:
        ranks, why = 4, f"{n} cards: one NCCL rank on each of 4"
    return ranks, backend, why, sharing, FSDP_LAYERS_SHARING if sharing else 34


def phase_fsdp():
    """Phase 22: --fsdp over BASELINE config #4 (Gemma3-4B full-joint stage 2) through
    the launcher; see the module's docstring."""
    import torch

    ranks, backend, why, sharing, layers = _fsdp_world()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    world = {"ranks": ranks, "backend": backend, "why": why, "sharing_one_card": sharing}
    if ranks < 2:
        print(f"fsdp: NOT RUN: {why}", flush=True)
        emit({"phase": 22, "ran": False, "why": why, "nvidia_smi": smi})
        return {}
    label = ("ranks sharing one card, a sharing figure, not a scaling one" if sharing
             else f"{ranks} ranks, one card each")
    cut = (f"Gemma3-4B's 34 decoder layers cut to {layers} (sliding only), the ViT-L "
           f"tower's 24 to "
           f"{FSDP_TOWER_LAYERS_SHARING}" if layers < 34
           else "the full 34 decoder layers and 24 tower layers")
    print(f"fsdp: {ranks} data ranks over {backend}: {why}; {cut} ({smi})", flush=True)
    root = _fsdp_scratch_root(layers)
    kernel_counters = counters()
    try:
        # (b) stage-2 full-joint over BASELINE config #4
        out = os.path.join(root, "stage2")
        flags = fsdp_stage2_flags(root, out) + ["--mesh_data", str(ranks)]
        gc_cuda()
        (wall,), _ = _launch_legs(
            [("fsdp_stage2_rank", root, ["--layers", str(layers)] + flags)], ranks, backend,
            FSDP_TIMEOUT_S)
        dumps = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                 for r in range(ranks)]
        n_steps = 2 * FSDP_SAMPLES // ranks
        for d in dumps:
            if len(d["losses"]) != n_steps or not np.isfinite(d["losses"]).all():
                raise AssertionError(f"fsdp: rank {d['rank']} losses {d['losses']}")
            if not all(d["launches"][n] for n in STAGE2_KERNELS):
                raise AssertionError(f"fsdp: rank {d['rank']} never launched a kernel of the "
                                     f"path: {d['launches']}")
            bound = ((d["state_bytes_whole"] - d["state_bytes_residue"]) / ranks
                     + d["state_bytes_residue"])
            if not d["state_bytes_local"] <= bound + 1:
                raise AssertionError(f"fsdp: rank {d['rank']} holds {d['state_bytes_local']} "
                                     f"bytes of state > {bound}")
        if any(d["losses"] != dumps[0]["losses"] for d in dumps):
            raise AssertionError(f"fsdp: the ranks logged different losses: "
                                 f"{[d['losses'] for d in dumps]}")
        if len({d["replicated_sha256"] for d in dumps}) != 1 or not dumps[0]["replicated_leaves"]:
            raise AssertionError("fsdp: the replicated trained leaves differ across the ranks")
        # the gathered train state loads whole here (memory-mapped)
        saved = torch.load(os.path.join(out, "checkpoints", "epoch_1.pt"), map_location="cpu",
                           weights_only=True, mmap=True)
        shapes = dumps[0]["whole_shapes"]
        if not saved["params"] or any(tuple(x.shape) != shapes[p]
                                      for p, x in saved["params"].items()):
            raise AssertionError("fsdp: the checkpoint does not hold whole leaves")
        for slot in ("mu", "nu", "acc"):
            if any(tuple(x.shape) != shapes[p] for p, x in saved["opt_state"][slot].items()):
                raise AssertionError(f"fsdp: the checkpoint's {slot} is not whole")
        ckpt_bytes = os.path.getsize(os.path.join(out, "checkpoints", "epoch_1.pt"))
        probe = saved["params"]["llm/layers/0/mlp/down_proj/weight"]
        if not bool(torch.isfinite(probe).all()):
            raise AssertionError("fsdp: the checkpoint's down_proj is not finite")
        del saved, probe
        exported = sorted(os.listdir(os.path.join(out, "checkpoint-epoch_1")))
        examples = sorted(os.listdir(os.path.join(out, "validation_examples")))
        grads_r = dumps[0]["first_grads"]
        gc_cuda()
        loss_one, grads_one, fp32, launched_one = _fsdp_one_process(layers, ranks,
                                                                    kernel_counters)
        versus = _fsdp_against_one_process(dumps[0]["losses"][0], grads_r, loss_one,
                                           grads_one, fp32)
        del grads_r, grads_one, fp32
        for d in dumps:
            d.pop("first_grads", None)
        gc_cuda()
        per_rank = [{
            "images_per_sec": d["result"].get("images_per_sec"),
            "tokens_per_sec": d["result"].get("tokens_per_sec"),
            "micro_step_ms": d["result"].get("step_time_ms"),
            "max_memory_allocated_gib": d["peak_memory_bytes"] / 2 ** 30,
            "state_gib_local_whole_residue": [d["state_bytes_local"] / 2 ** 30,
                                              d["state_bytes_whole"] / 2 ** 30,
                                              d["state_bytes_residue"] / 2 ** 30],
            "fsdp_gather_host_ms_first_micro_step": float(np.sum(
                d["gather_host_ms"][:d["counts_first"]["forward"]
                                    + d["counts_first"]["recompute"]])),
            "fsdp_gather_host_ms_run": float(np.sum(d["gather_host_ms"])),
            "fsdp_reduce_scatter_host_ms_run": float(np.sum(d["reduce_scatter_host_ms"])),
            "fsdp_kernel_ms_micro_step_2": {
                k: v for k, v in d["span_kernel_ms_micro_step_2"].items() if "fsdp" in k},
            "kernel_ms_micro_step_2": d["span_kernel_ms_micro_step_2"]["total_ms"],
            "collectives_first_micro_step": d["counts_first"],
            "gathered_bytes_first_micro_step": d["bytes_first"],
            "remat_full_vs_dots": d["remat"]} for d in dumps]
        for r, row in enumerate(per_rank):
            print(f"fsdp rank {r} ({label}; {smi}): {row['images_per_sec']} images/s, "
                  f"{row['tokens_per_sec']} tokens/s, {row['micro_step_ms']} ms a micro-step; "
                  f"max_memory_allocated {row['max_memory_allocated_gib']:.2f} GiB; state "
                  f"(local, whole, replicated residue) GiB {row['state_gib_local_whole_residue']}; "
                  f"fsdp_gather host ms {row['fsdp_gather_host_ms_run']:.0f} (run), "
                  f"fsdp_reduce_scatter host ms {row['fsdp_reduce_scatter_host_ms_run']:.0f} "
                  f"(run); kernel ms of micro-step 2 {row['kernel_ms_micro_step_2']:.1f}, of its "
                  f"collectives {row['fsdp_kernel_ms_micro_step_2']}; gathers of a micro-step "
                  f"{row['collectives_first_micro_step']}; remat {row['remat_full_vs_dots']}",
                  flush=True)
        emit({"phase": 22, "part": "stage2_full_joint_4b", "world": world, "label": label,
              "nvidia_smi": smi, "launch_wall_s": wall, "decoder_layers": layers,
              "losses": dumps[0]["losses"], "per_rank": per_rank,
              "data_sharded_leaves": dumps[0]["data_sharded_leaves"],
              "leaves": dumps[0]["leaves"], "replicated_leaves_bit_equal":
              dumps[0]["replicated_leaves"], "checkpoint_bytes": ckpt_bytes,
              "checkpoint_loads_whole": True, "exported": exported,
              "validation_examples": examples,
              "kernel_ms_micro_step_2_rank0": dumps[0]["span_kernel_ms_micro_step_2"],
              "launches_per_rank": [d["launches"] for d in dumps],
              "launches_first_micro_step_rank0": dumps[0]["launches_first"],
              "launches_one_process_micro_step": launched_one, **versus,
              "cut": f"{cut}; 2 epochs of {FSDP_SAMPLES} random samples at 1215 tokens, "
                     "2 validation samples with 3 beams of 16 tokens, the train state and "
                     "exports saved after the last epoch only (a real run: the VQA "
                     "corpus, 5 epochs, a checkpoint each epoch and the best)"})
        launches = {"stage2_fsdp_rank0": dumps[0]["launches"],
                    "stage2_fsdp_micro_step": dumps[0]["launches_first"],
                    "collectives_apply_micro_step": dumps[0]["collectives_apply"],
                    "peak_apply_micro_step": dumps[0]["peak_apply"],
                    "world": (ranks, layers, backend)}

        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------- phase 23

TT_RANKS = 2               # the model axis of phase 23
TT_STAGE0_LAYERS = 14      # (a): so400m's layers a tower, 14 of 27 (the script's time)
TT_CLS_LAYERS = 12         # (c): ViT-L's layers, 12 of 24 (the script's time)
TT_STAGE0_BATCH = 16       # a replica's rows, at 512 px (phase 7's batch)
TT_STAGE0_STEPS = 3       # (run time; the script's 1200 s)
TT_FSDP_BATCH = 8          # (b): a data rank's rows
TT_FSDP_STEPS = 2
TT_CLS_BATCH = 32          # (c): run_cls_experiments.sh's batch, at 384 px
TT_CLS_STEPS = 2           # an epoch: 2 steps of 32 (run time; a real epoch is the corpus)
TT_TIMEOUT_S = 420         # each launch: kernels loaded, the model built in each rank


def tt_stage0_config(layers=None):
    """Phase 7's so400m dual tower config, ``layers`` layers a tower (None: all 27)."""
    from projectiontrainer_tpu_torch.models import siglip

    vision, text = siglip.so400m_16_512(), siglip.so400m_text()
    if layers is not None:
        vision, text = (dataclasses.replace(t, num_layers=layers) for t in (vision, text))
    return siglip.SiglipConfig(vision=vision, text=text)


def tp_towers_stage0_model(layers=None):
    """The dual tower of ``tt_stage0_config(layers)``, whole, from the seed (the weights
    of ``stage0_model`` and ``_stage0_dp_model``: fp32 vision, bf16 text)."""
    import torch

    from projectiontrainer_tpu_torch.models import siglip

    cfg = tt_stage0_config(layers)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    return cfg, siglip.init(gen, cfg, device=DEVICE, vision_dtype=torch.float32,
                            text_dtype=torch.bfloat16)


def tt_cls_vision_config():
    """The probe's tower: XraySigLIP's ViT-L/16-384 at full width, TT_CLS_LAYERS of its
    24 layers."""
    from projectiontrainer_tpu_torch.models import siglip

    return dataclasses.replace(siglip.vit_l_16_384(), num_layers=TT_CLS_LAYERS)


def tp_towers_predicted(n_vision, n_text=None, *, tower_trains=True):
    """The model-axis collectives of one train step, read off the code: every encoder
    layer all-reduces after out_proj and fc2 in the forward (``tp.row_linear``) and after
    the gradients of its two column-parallel blocks' input in the backward
    (``tp.copy_to_model``); the MAP head's MLP (stage 0 runs it) once each way, the
    frozen text tower's layers and vocab-sharded lookup in the forward only; the step
    sums the partial gradients once and the grad norm's squares once (``grads``; with the
    tower frozen there is no partial gradient to sum, only the norm's)."""
    stage0 = n_text is not None
    fwd = 2 * n_vision + (2 + 2 * n_text if stage0 else 0)
    bwd = 2 * n_vision + stage0 if tower_trains else 0
    return {"forward": fwd, "backward": bwd, "recompute": 0,
            "grads": 2 if tower_trains else 1}


class TowerSamples(ContrastiveSamples):
    """Phase 7's in-memory stage-0 samples with the dataset's ``class_names``."""

    class_names = ["pneumonia", "edema", "cardiomegaly", "no finding"]


def _tt_stage0_samples(n, cfg):
    """``n`` in-memory stage-0 samples for ``cfg``, seeded by ``n`` (the training and
    validation sets differ)."""
    return TowerSamples(n, SEED + 40 + n, size=cfg.vision.image_size, vocab=cfg.text.vocab_size,
                        text_len=cfg.text.max_position_embeddings)


def _tt_stage0_data(datasets_mod, n_train, cfg):
    """The stage-0 CLI's manifest, split and dataset as in-memory samples; no validation
    set (run time: the zero-shot validation's checkpoint and HF export would cost ~25 s;
    ``tests/test_torch_tp_towers.py`` holds it under the model axis)."""
    datasets_mod.load_manifest = lambda path: [{"i": i} for i in range(n_train)]
    datasets_mod.train_val_split = lambda s, *_, **__: (s, [])
    datasets_mod.ContrastiveDataset = lambda s, **_: _tt_stage0_samples(len(s), cfg)


def _tt_cls_data(datasets_mod, n_train, n_val, size, n_classes):
    datasets_mod.load_manifest = lambda path: [{"i": i} for i in range(n_train + n_val)]
    datasets_mod.stratified_split = lambda s, **_: (s[:n_train], s[n_train:])
    datasets_mod.ClassificationDataset = lambda s, **_: ClsSamples(
        len(s), SEED + 50 + len(s), size=size, n_classes=n_classes)


def tp_cls_vision():
    """The probe's tower (``tt_cls_vision_config``, with its MAP head) from the seed,
    fp32; the CLI builds the classifier's head around it from ``--seed``."""
    import torch

    from projectiontrainer_tpu_torch.models import siglip

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    cfg = tt_cls_vision_config()
    return cfg, siglip.init_vision(gen, cfg, torch.float32, DEVICE, head=True)


def _tt_record(record, cfg_of, plan_of):
    """Wrap the train step and the optimizer's update: each step's loss, its model-axis
    collectives and the hash of every leaf the model axis leaves whole after it; the
    first step's gradients whole (after the model-axis sum of the partial ones)."""
    from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
    from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp
    from projectiontrainer_tpu_torch.train import optim, steps

    make, update = steps.make_train_step, optim.MaskedAdamW.update

    def recording(*a, **kw):
        step = make(*a, **kw)

        def wrapped(state, batch, rng=None):
            before = dict(tp.COUNTS)
            out = step(state, batch, rng)
            record["losses"].append(float(out[1]))
            record["counts_by_step"].append({k: tp.COUNTS[k] - before[k] for k in before})
            sharded = plan_of().sharded
            record["whole_sha_by_step"].append(_sha(
                [(p, x) for p, x in unique_leaves_with_paths(state["params"])
                 if p not in sharded]))
            return out

        return wrapped

    def capturing(self, grads, state, params):
        if record["first_grads"] is None and record.get("want_grads"):
            record["first_grads"] = {p: _tp_whole(p, g, cfg_of()).float().cpu()
                                     for p, g in grads.items()}
        return update(self, grads, state, params)

    steps.make_train_step = recording
    optim.MaskedAdamW.update = capturing
    return make, update


def _tt_new_record(want_grads=False):
    return {"losses": [], "counts_by_step": [], "whole_sha_by_step": [], "first_grads": None,
            "want_grads": want_grads}


def _tt_flags(argv):
    """(this rank's options of phase 23: ``--layers`` a tower, None for all, and
    ``--train_samples``; the CLI's flags)."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--layers", type=int, default=None)
    parser.add_argument("--train_samples", type=int, required=True)
    parser.add_argument("--first_grads", action="store_true")  # (a): held against one process
    return parser.parse_known_args(argv)


def tp_towers_stage0_rank(argv):
    """A rank of phase 23 (a) and (b): ``cli/train_stage0.main`` with --mesh_model 2
    over the so400m dual tower built whole from the seed in the rank (``--layers`` a
    tower) and sliced by the CLI (``sharding.model_shards``), on in-memory samples (the
    manifest reader, the split and the dataset replaced)."""
    import torch

    from projectiontrainer_tpu_torch.cli import train_stage0
    from projectiontrainer_tpu_torch.parallel import distributed
    from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp
    from projectiontrainer_tpu_torch.train import common, setup

    dump, rest, rank = _rank_entry(argv)
    opts, flags = _tt_flags(rest)
    built = {}

    def load_siglip(*_, **__):
        built["cfg"], params = tp_towers_stage0_model(opts.layers)
        return built["cfg"], params

    place = common.place_params

    def placing(params, *a, **kw):
        built["params"] = params
        built["plan"] = place(params, *a, **kw)
        return built["plan"]

    train_stage0.hf_import.load_siglip = load_siglip
    setup.load_tokenizer = lambda _: StubTokenizer()
    common.place_params = placing
    _tt_stage0_data(train_stage0.datasets, opts.train_samples, tt_stage0_config(opts.layers))
    record = _tt_new_record(want_grads=opts.first_grads)  # (a) compares gradients
    _tt_record(record, lambda: built["cfg"], lambda: built["plan"])
    kernel_counters = counters()
    for c in kernel_counters.values():
        c.reset()
    tp.reset_counts()
    t0 = time.perf_counter()
    result = train_stage0.main(flags)
    torch.cuda.synchronize()
    torch.save({"rank": rank, "data_rank": distributed.data_rank(), "losses": record["losses"],
                "result": result, "wall_s": time.perf_counter() - t0,
                "launches": {n: c.value for n, c in kernel_counters.items()},
                "counts_by_step": record["counts_by_step"], "counts_total": dict(tp.COUNTS),
                "whole_sha_by_step": record["whole_sha_by_step"],
                "sharded_leaves": len(built["plan"].sharded),
                "data_sharded_leaves": len(built["plan"].data_sharded),
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "first_grads": record["first_grads"] if rank == 0 else None},
               os.path.join(dump, f"rank{rank}.pt"))
    return result


def tp_towers_cls_rank(argv):
    """A rank of phase 23 (c): ``cli/cls_train.main`` with --mesh_model 2 over the ViT-L
    tower from the seed (``tp_cls_vision``; the CLI builds the head and slices the
    classifier), on in-memory samples; the classifier's initial evaluation is run first,
    and every evaluation's gathered logits recorded."""
    import torch

    from projectiontrainer_tpu_torch.cli import cls_train
    from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp
    from projectiontrainer_tpu_torch.train import common, trainer_cls

    dump, flags, rank = _rank_entry(argv)
    built = {}
    cls_train.hf_import.load_siglip_vision = lambda *_, **__: tp_cls_vision()
    n_classes = len(CLS_CLASSES.split(","))
    _tt_cls_data(cls_train.datasets, TT_CLS_BATCH * TT_CLS_STEPS, TT_CLS_BATCH,
                 tt_cls_vision_config().image_size, n_classes)
    place = common.place_params

    def placing(params, model_cfg, *a, **kw):
        built["cfg"] = model_cfg
        built["plan"] = place(params, model_cfg, *a, **kw)
        return built["plan"]

    common.place_params = placing
    evaluations = []
    metrics = trainer_cls.classification_metrics

    def capture(logits, targets, **kw):
        evaluations.append((np.asarray(logits), np.asarray(targets)))
        return metrics(logits, targets, **kw)

    trainer_cls.classification_metrics = capture
    train = trainer_cls.ClsTrainer.train

    def train_after_a_first_evaluation(self):
        self.evaluate()
        return train(self)

    trainer_cls.ClsTrainer.train = train_after_a_first_evaluation
    record = _tt_new_record()
    _tt_record(record, lambda: built["cfg"], lambda: built["plan"])
    kernel_counters = counters()
    for c in kernel_counters.values():
        c.reset()
    tp.reset_counts()
    t0 = time.perf_counter()
    result = cls_train.main(flags)
    torch.cuda.synchronize()
    torch.save({"rank": rank, "losses": record["losses"], "result": result,
                "wall_s": time.perf_counter() - t0,
                "launches": {n: c.value for n, c in kernel_counters.items()},
                "counts_by_step": record["counts_by_step"], "counts_total": dict(tp.COUNTS),
                "whole_sha_by_step": record["whole_sha_by_step"],
                "sharded_leaves": len(built["plan"].sharded), "evaluations": evaluations,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30},
               os.path.join(dump, f"rank{rank}.pt"))
    return result


def _tt_check(label, dumps, kernels, steps, predicted, model=TT_RANKS):
    """Every rank: ``steps`` finite losses, bit-equal across the ranks; each step's
    model-axis collectives as predicted (``predicted(step)``); the leaves the model axis
    leaves whole hash equal across the model ranks of a replica after every step; each
    kernel of the path launched."""
    for d in dumps:
        if len(d["losses"]) != steps or not np.isfinite(d["losses"]).all():
            raise AssertionError(f"{label}: rank {d['rank']} losses {d['losses']}")
        if not all(d["launches"][n] for n in kernels):
            raise AssertionError(f"{label}: rank {d['rank']} never launched a kernel of the "
                                 f"path: {d['launches']}")
        want = [predicted(i) for i in range(steps)]
        if d["counts_by_step"] != want:
            raise AssertionError(f"{label}: rank {d['rank']} model-axis collectives "
                                 f"{d['counts_by_step']}, predicted {want}")
        first = dumps[d["rank"] - d["rank"] % model]
        if d["whole_sha_by_step"] != first["whole_sha_by_step"]:
            raise AssertionError(f"{label}: rank {d['rank']}'s whole leaves differ from rank "
                                 f"{first['rank']}'s after some step")
    if any(d["losses"] != dumps[0]["losses"] for d in dumps):
        raise AssertionError(f"{label}: the ranks logged different losses: "
                             f"{[d['losses'] for d in dumps]}")


def _tt_stage0_one_process(flags, layers, n_train, global_rows):
    """The first step of phase 23's stage-0 recipe in this process on the whole model
    over the ranks' ``n_train`` samples: (loss, every trainable gradient, a function of
    paths giving their fp32 plain-path gradients on the same batch), ``global_rows`` the
    rank-ordered indices of the first global batch."""
    import torch

    from projectiontrainer_tpu_torch.core.config import Stage0Config, from_args, parser_for
    from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths
    from projectiontrainer_tpu_torch.train import steps
    from projectiontrainer_tpu_torch.train.trainer_stage0 import Stage0Trainer

    cfg, params = tp_towers_stage0_model(layers)
    train = _tt_stage0_samples(n_train, cfg)
    out = tempfile.mkdtemp(prefix="chip_smoke_tt_one_")
    record = _tt_new_record(want_grads=True)
    originals = None
    try:
        tcfg = from_args(Stage0Config, parser_for(Stage0Config, "").parse_args(flags))
        tcfg.device, tcfg.output_dir = DEVICE, out
        tcfg.mesh_data, tcfg.mesh_model = 1, 1
        trainer = Stage0Trainer(tcfg, model_cfg=cfg, params=params, tokenizer=StubTokenizer(),
                                train_dataset=train, val_dataset=None)
        rows = [train[int(i)] for i in global_rows]
        batch = {k: torch.tensor(np.stack([r[k] for r in rows]), device=DEVICE)
                 for k in ("pixel_values", "input_ids", "valid")}
        batch["sample_weight"] = torch.ones((len(rows),), device=DEVICE)
        originals = _tt_record(record, lambda: cfg, lambda: trainer.plan)
        # the masters before the update: the fp32 pass below differentiates these
        masters = {p: x.detach().clone() for p, x in leaves_with_paths(params)
                   if x.is_floating_point()}
        _, loss, _ = trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        loss = float(loss)
        del trainer
    finally:
        if originals is not None:
            from projectiontrainer_tpu_torch.train import optim, steps as steps_mod

            steps_mod.make_train_step, optim.MaskedAdamW.update = originals
        shutil.rmtree(out, ignore_errors=True)
    grads = record["first_grads"]

    def fp32_of(paths):
        """The gradients at ``paths`` on the plain fp32 path (the masters as the step
        read them)."""
        whole = {p: x for p, x in leaves_with_paths(params)}
        with torch.no_grad():
            for p, x in masters.items():
                whole[p].copy_(x)
        for p, x in whole.items():
            if x.is_floating_point():
                x.requires_grad_(p in paths)
        loss32, _ = steps.stage0_loss(plain_config(cfg), compute_dtype=torch.float32)(
            params, batch)
        out_grads = torch.autograd.grad(loss32, [whole[p] for p in paths])
        return {p: g.detach().float().cpu() for p, g in zip(paths, out_grads)}

    return loss, grads, fp32_of


def _tt_whole_checkpoint(label, out, layers):
    """The final checkpoint the ranks wrote holds every trained leaf whole (memory-mapped:
    the shapes only), the MAP head's sharded MLP among them."""
    import torch

    from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
    from projectiontrainer_tpu_torch.models import siglip

    shapes = {p: tuple(x.shape) for p, x in unique_leaves_with_paths(
        siglip.init(torch.Generator(), tt_stage0_config(layers), device="meta"))}
    saved = torch.load(os.path.join(out, "checkpoints", "final.pt"), map_location="cpu",
                       weights_only=True, mmap=True)["params"]
    if (not saved or "vision/head/mlp/fc1/weight" not in saved
            or any(tuple(x.shape) != shapes[p] for p, x in saved.items())):
        raise AssertionError(f"{label}: the final checkpoint does not hold whole leaves")


def _tt_stage0_flags(root, out, cfg, *, batch, data, fsdp):
    """The stage-0 CLI's flags of phase 23: one epoch, no validation, the final
    checkpoint (no periodic one: ``--min_save_epoch`` stays 1); the mesh flags last."""
    flags = ["--image_root", root, "--train_json", os.path.join(root, "s0.json"),
             "--output_dir", out, "--model_name", "seeded", "--img_size",
             str(cfg.vision.image_size), "--batch_size", str(batch), "--num_epochs", "1",
             "--val_split", "0", "--max_text_len", str(cfg.text.max_position_embeddings),
             "--logging_steps", "1", "--num_workers", "4",
             "--disable_wandb", "--seed", str(SEED),
             "--mesh_data", str(data), "--mesh_model", str(TT_RANKS)]
    if fsdp:
        flags += ["--fsdp", "--no-local_negatives"]
    return flags


def _first_global_rows(n, batch, data):
    """The sample indices of the first global batch, data rank by data rank (each data
    rank's first ``batch`` of its round-robin shard, ``data/pipeline.py``)."""
    from projectiontrainer_tpu_torch.data import pipeline

    return np.concatenate([pipeline.host_shard_indices(n, epoch=0, seed=SEED, process_index=d,
                                                       process_count=data)[:batch]
                           for d in range(data)])


def _tt_fsdp_world():
    """(ranks, backend, why, sharing) for phase 23 (b)'s 2 x 2 mesh: one NCCL rank a card
    on 4 cards or more; else 4 gloo ranks sharing the cards (a rank on card LOCAL_RANK
    modulo the cards); none where a card admits one process only."""
    import torch

    n, ranks = torch.cuda.device_count(), 2 * TT_RANKS
    if n >= ranks:
        return ranks, "nccl", f"{n} cards: one NCCL rank on each of {ranks}", False
    modes = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.split()
    if "Exclusive_Process" in modes:
        return 0, "nccl", (f"{n} card(s) in Exclusive_Process mode: {ranks} ranks need "
                           f"{ranks} cards"), False
    return ranks, "gloo", (f"{n} card(s): {ranks} gloo ranks share them (NCCL refuses two "
                           "ranks on one GPU)"), True


def _tt_stage0_fsdp(root, smi):
    """Phase 23 (b): stage 0 at 2 x 2 with --fsdp and global negatives on the cut towers;
    rank 0's launches, or None where 4 ranks cannot run (``_tt_fsdp_world``)."""
    import torch

    ranks, backend, why, sharing = _tt_fsdp_world()
    if ranks < 2 * TT_RANKS:
        print(f"tensor parallel towers: (b) NOT RUN: {why}", flush=True)
        emit({"phase": 23, "part": "stage0_2x2_fsdp", "ran": False, "why": why})
        return None
    label = ("ranks sharing cards, a sharing figure, not a scaling one" if sharing
             else f"{ranks} ranks, one card each")
    print(f"tensor parallel towers (b): {ranks} ranks over {backend}: {why}", flush=True)
    out = os.path.join(root, "stage0_fsdp")
    cut = tt_stage0_config(DP_STAGE0_LAYERS)
    flags = _tt_stage0_flags(root, out, cut, batch=TT_FSDP_BATCH, data=2, fsdp=True)
    n_train = 2 * TT_FSDP_BATCH * TT_FSDP_STEPS
    gc_cuda()
    rc, logs, wall = _dp_launch(
        "tp_towers_stage0_rank", root,
        ["--layers", str(DP_STAGE0_LAYERS), "--train_samples", str(n_train)] + flags, ranks,
        backend, TT_TIMEOUT_S)
    if rc != 0:
        raise AssertionError(f"tensor parallel towers: the 2 x 2 --fsdp launch exited "
                             f"{rc}:\n{logs[-6000:]}")
    dumps = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(ranks)]
    predicted = tp_towers_predicted(DP_STAGE0_LAYERS, DP_STAGE0_LAYERS)
    _tt_check("tensor parallel stage 0 --fsdp", dumps, STAGE0_KERNELS, TT_FSDP_STEPS,
              lambda i: predicted)
    if not all(d["data_sharded_leaves"] for d in dumps):
        raise AssertionError("tensor parallel stage 0 --fsdp: no data shard")
    _tt_whole_checkpoint("tensor parallel stage 0 --fsdp", out, DP_STAGE0_LAYERS)
    for d in dumps:
        d.pop("first_grads", None)
    gc_cuda()
    # global negatives over the data axis only: the first loss is the one-process loss of
    # the whole global batch (gathered over the world, the model ranks' texts would count
    # twice)
    loss_one, grads_one, _ = _tt_stage0_one_process(
        flags[:flags.index("--mesh_data")] + ["--no-local_negatives"], DP_STAGE0_LAYERS,
        n_train, _first_global_rows(n_train, TT_FSDP_BATCH, 2))
    del grads_one
    gc_cuda()
    rel = abs(dumps[0]["losses"][0] - loss_one) / abs(loss_one)
    if not rel <= LOSS_REL:
        raise AssertionError(f"tensor parallel stage 0 --fsdp: first loss "
                             f"{dumps[0]['losses'][0]} vs one process {loss_one}")
    print(f"tensor parallel stage 0 2 x 2 --fsdp ({label}; {smi}): losses "
          f"{dumps[0]['losses']}, first loss {rel:.2e} from one process", flush=True)
    emit({"phase": 23, "part": "stage0_2x2_fsdp",
          "world": {"ranks": ranks, "backend": backend, "why": why, "sharing_cards": sharing},
          "label": label, "nvidia_smi": smi, "launch_wall_s": wall,
          "losses": dumps[0]["losses"], "first_loss_one_process": loss_one,
          "first_loss_rel_diff": rel,
          "model_axis_collectives_per_step": dumps[0]["counts_by_step"],
          "predicted_per_step": predicted,
          "data_sharded_leaves": dumps[0]["data_sharded_leaves"],
          "whole_leaves_bit_equal_every_step": True, "checkpoint_loads_whole": True,
          "images_per_sec_per_rank": [d["result"].get("images_per_sec") for d in dumps],
          "step_time_ms_per_rank": [d["result"].get("step_time_ms") for d in dumps],
          "launches_per_rank": [d["launches"] for d in dumps],
          "cut": f"so400m towers cut to {DP_STAGE0_LAYERS} of 27 layers each (run time), "
                 f"{TT_FSDP_STEPS} steps at {TT_FSDP_BATCH} a data rank"})
    return dumps[0]["launches"]


def phase_tp_towers():
    """Phase 23: stage 0 and the cls probe over the model axis through the launcher;
    see the module's docstring."""
    import torch
    import torch.nn.functional as F

    ranks, backend, why, sharing = _dp_world("tensor parallel towers")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    world = {"ranks": ranks, "backend": backend, "why": why, "sharing_one_card": sharing}
    if ranks < TT_RANKS:
        print(f"tensor parallel towers: NOT RUN: {why}", flush=True)
        emit({"phase": 23, "ran": False, "why": why, "nvidia_smi": smi})
        return {}
    label = ("ranks sharing one card, a sharing figure, not a scaling one" if sharing
             else f"{ranks} ranks, one card each")
    root = tempfile.mkdtemp(prefix="chip_smoke_tt_")
    launches = {}
    try:
        # (a) stage 0 at 1 x 2, so400m at full width, TT_STAGE0_LAYERS layers a tower
        out = os.path.join(root, "stage0")
        cfg = tt_stage0_config(TT_STAGE0_LAYERS)
        flags = _tt_stage0_flags(root, out, cfg, batch=TT_STAGE0_BATCH, data=1, fsdp=False)
        # the last step profiled on rank 0: the kernel time by span (tp_allreduce apart)
        flags += ["--profile_dir", os.path.join(out, "profile"), "--profile_start_step",
                  str(TT_STAGE0_STEPS - 1), "--profile_num_steps", "1"]
        # (c)'s flags: the cls probe at 1 x 2, ViT-L/16-384 at full width, TT_CLS_LAYERS
        out_cls = os.path.join(root, "cls")
        flags_cls = ["--exp_id", "EXP1", "--class_names", CLS_CLASSES, "--freeze_mode",
                     "1EpochUnfreeze", "--vision_model_name", "seeded", "--data_json",
                     os.path.join(root, "cls.json"), "--image_root", root,
                     "--output_base_dir", out_cls, "--img_size",
                     str(tt_cls_vision_config().image_size), "--batch_size",
                     str(TT_CLS_BATCH), "--epochs", "2", "--num_workers", "4", "--seed",
                     str(SEED), "--logging_steps", "1", "--mesh_data", "1", "--mesh_model",
                     str(TT_RANKS)]
        dump_a, dump_c = (os.path.join(root, d) for d in ("dump_stage0", "dump_cls"))
        for d in (dump_a, dump_c):
            os.makedirs(d)
        gc_cuda()
        # (a) and (c) on the ranks of phases 20-22 (legs_rank)
        leg_walls, _ = _launch_legs(
            [("tp_towers_stage0_rank", dump_a,
              ["--layers", str(TT_STAGE0_LAYERS), "--first_grads",
               "--train_samples", str(TT_STAGE0_BATCH * TT_STAGE0_STEPS)] + flags),
             ("tp_towers_cls_rank", dump_c, flags_cls)], TT_RANKS, backend, 2 * TT_TIMEOUT_S)
        wall, wall_cls = leg_walls
        dumps = [torch.load(os.path.join(dump_a, f"rank{r}.pt"), weights_only=False)
                 for r in range(TT_RANKS)]
        predicted = tp_towers_predicted(cfg.vision.num_layers, cfg.text.num_layers)
        _tt_check("tensor parallel stage 0", dumps, STAGE0_KERNELS, TT_STAGE0_STEPS,
                  lambda i: predicted)
        _tt_whole_checkpoint("tensor parallel stage 0", out, TT_STAGE0_LAYERS)
        split = _tp_split(out)
        grads_tp = dumps[0]["first_grads"]
        for d in dumps:
            d.pop("first_grads", None)
        gc_cuda()
        n_train = TT_STAGE0_BATCH * TT_STAGE0_STEPS
        loss_one, grads_one, fp32_of = _tt_stage0_one_process(
            flags[:flags.index("--mesh_data")], TT_STAGE0_LAYERS, n_train,
            _first_global_rows(n_train, TT_STAGE0_BATCH, 1))
        rel = abs(dumps[0]["losses"][0] - loss_one) / abs(loss_one)
        versus, _ = hold_gradients("tensor parallel stage 0", grads_tp, grads_one, fp32_of)
        del grads_tp, grads_one, fp32_of
        gc_cuda()
        if not rel <= LOSS_REL:
            raise AssertionError(f"tensor parallel stage 0: first loss {dumps[0]['losses'][0]} "
                                 f"vs one process {loss_one}")
        print(f"tensor parallel stage 0 ({label}; {smi}): losses {dumps[0]['losses']}, first "
              f"loss {rel:.2e} from one process, min gradient cosine "
              f"{versus['min_grad_cosine']:.6f}; {predicted} model-axis collectives a step; "
              f"step ms per rank {[d['result'].get('step_time_ms') for d in dumps]}",
              flush=True)
        emit({"phase": 23, "part": "stage0_1x2", "world": world, "label": label,
              "nvidia_smi": smi, "launch_wall_s": wall, "losses": dumps[0]["losses"],
              "first_loss_one_process": loss_one, "first_loss_rel_diff": rel, **versus,
              "model_axis_collectives_per_step": dumps[0]["counts_by_step"],
              "predicted_per_step": predicted, "counts_total": dumps[0]["counts_total"],
              "whole_leaves_bit_equal_every_step": True, "checkpoint_loads_whole": True,
              "images_per_sec_per_rank": [d["result"].get("images_per_sec") for d in dumps],
              "step_time_ms_per_rank": [d["result"].get("step_time_ms") for d in dumps],
              "kernel_ms_last_step_rank0": split,
              "rank_wall_s": [d["wall_s"] for d in dumps],
              "peak_gib_per_rank": [d["peak_gib"] for d in dumps],
              "sharded_leaves": dumps[0]["sharded_leaves"],
              "launches_per_rank": [d["launches"] for d in dumps],
              "cut": f"full width, {TT_STAGE0_LAYERS} of 27 layers a tower; "
                     f"{TT_STAGE0_STEPS} steps at "
                     f"{TT_STAGE0_BATCH} of random in-memory data, no validation (run "
                     "time; a real run: the caption corpus, many epochs, zero-shot each)"})
        launches["stage0_tp_rank0"] = dumps[0]["launches"]

        # (b) stage 0 at 2 x 2 with --fsdp and global negatives, the cut towers
        fsdp_launches = _tt_stage0_fsdp(root, smi)
        if fsdp_launches is not None:
            launches["stage0_fsdp_tp_rank0"] = fsdp_launches

        # (c) the cls probe at 1 x 2, ViT-L/16-384 at full width, TT_CLS_LAYERS layers
        out, flags, wall = out_cls, flags_cls, wall_cls
        dumps = [torch.load(os.path.join(dump_c, f"rank{r}.pt"), weights_only=False)
                 for r in range(TT_RANKS)]
        n_layers = tt_cls_vision_config().num_layers
        trains, frozen = (tp_towers_predicted(n_layers),
                          tp_towers_predicted(n_layers, tower_trains=False))
        _tt_check("tensor parallel cls", dumps, CLS_KERNELS, 2 * TT_CLS_STEPS,
                  lambda i: trains if i < TT_CLS_STEPS else frozen)
        evaluations = dumps[0]["evaluations"]
        if len(evaluations) != 3 or any(lg.shape != (TT_CLS_BATCH, 4) for lg, _ in evaluations):
            raise AssertionError(f"tensor parallel cls: evaluations "
                                 f"{[lg.shape for lg, _ in evaluations]}")
        with open(os.path.join(out, "EXP1", "results.tsv")) as f:
            results = f.read().splitlines()
        gc_cuda()
        loss_one, logits_one, targets_one, auroc = _tt_cls_one_process(flags)
        gc_cuda()
        logits_tp, targets_tp = evaluations[0]
        rel = abs(dumps[0]["losses"][0] - loss_one) / abs(loss_one)
        cos = float(F.cosine_similarity(torch.tensor(logits_tp).flatten().double(),
                                        torch.tensor(logits_one).flatten().double(), dim=0))
        if not (rel <= LOSS_REL and cos >= COS_MIN
                and np.array_equal(targets_tp, targets_one)):
            raise AssertionError(f"tensor parallel cls: first loss {dumps[0]['losses'][0]} vs "
                                 f"{loss_one}; initial evaluation logits cosine {cos}")
        from projectiontrainer_tpu_torch.train import trainer_cls

        auroc_tp = trainer_cls.classification_metrics(logits_tp, targets_tp)[2]
        print(f"tensor parallel cls ({label}; {smi}): losses {dumps[0]['losses']}, first loss "
              f"{rel:.2e} from one process, initial logits cosine {cos:.6f}, AUROC "
              f"{auroc_tp:.4f} (one process {auroc:.4f}) over {len(targets_tp)} rows",
              flush=True)
        emit({"phase": 23, "part": "cls_1x2", "label": label, "nvidia_smi": smi,
              "launch_wall_s": wall, "losses": dumps[0]["losses"],
              "first_loss_one_process": loss_one, "first_loss_rel_diff": rel,
              "initial_logits_cosine": cos, "auroc_initial_tp_one": [auroc_tp, auroc],
              "evaluation_rows": [len(t) for _, t in evaluations], "results_tsv": results,
              "model_axis_collectives_per_step": dumps[0]["counts_by_step"],
              "predicted_per_step": [trains, frozen],
              "whole_leaves_bit_equal_every_step": True,
              "epochs_rank0": dumps[0]["result"]["epochs"],
              "rank_wall_s": [d["wall_s"] for d in dumps],
              "peak_gib_per_rank": [d["peak_gib"] for d in dumps],
              "launches_per_rank": [d["launches"] for d in dumps],
              "cut": f"full width, {TT_CLS_LAYERS} of 24 layers; 2 epochs of "
                     f"{TT_CLS_STEPS} steps at "
                     f"{TT_CLS_BATCH}, {TT_CLS_BATCH} validation samples (a real run: the CXR "
                     "corpus, 10 epochs)"})
        launches["cls_tp_rank0"] = dumps[0]["launches"]
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _tt_cls_one_process(flags):
    """Phase 23 (c) in this process on the whole classifier: the first step's loss and
    the initial evaluation's logits, targets and AUROC."""
    import torch

    from projectiontrainer_tpu_torch.core.config import ClsConfig, from_args, parser_for
    from projectiontrainer_tpu_torch.models import classifier
    from projectiontrainer_tpu_torch.train import common, trainer_cls

    tcfg = from_args(ClsConfig, parser_for(ClsConfig, "").parse_args(
        flags[:flags.index("--mesh_data")]))
    vision_cfg, vision = tp_cls_vision()
    model_cfg = classifier.ClassifierConfig(vision=vision_cfg, num_classes=4,
                                            dropout_rate=tcfg.dropout_rate)
    gen = torch.Generator(device=DEVICE).manual_seed(tcfg.seed)
    params = classifier.init(gen, model_cfg, device=DEVICE, vision=vision)
    out = tempfile.mkdtemp(prefix="chip_smoke_tt_cls_one_")
    tcfg.output_base_dir, tcfg.device = out, DEVICE
    seen = []
    metrics = trainer_cls.classification_metrics
    try:
        trainer_cls.classification_metrics = lambda lg, t, **kw: (
            seen.append((np.asarray(lg), np.asarray(t))) or metrics(lg, t, **kw))
        size = vision_cfg.image_size
        train = ClsSamples(TT_CLS_BATCH * TT_CLS_STEPS, SEED + 50 + TT_CLS_BATCH * TT_CLS_STEPS,
                           size=size, n_classes=4)
        val = ClsSamples(TT_CLS_BATCH, SEED + 50 + TT_CLS_BATCH, size=size, n_classes=4)
        trainer = trainer_cls.ClsTrainer(tcfg, model_cfg=model_cfg, params=params,
                                         train_dataset=train, val_dataset=val)
        _, _, auroc = trainer.evaluate()
        batch = next(iter(common.feed(train, tcfg, epoch=0)))
        step_fn = trainer._steps[False][0]
        _, loss, _ = step_fn(trainer.state, batch, 0)
        torch.cuda.synchronize()
        loss = float(loss)
        del trainer
    finally:
        trainer_cls.classification_metrics = metrics
        shutil.rmtree(out, ignore_errors=True)
    return loss, seen[0][0], seen[0][1], auroc


# ---------------------------------------------------------------------------- phase 24

# phase 22's recipe: batch 1 a rank, the (128, 512) bucket, accumulation 2, fp32 masters
BUDGET_KW = dict(batch_per_device=1, q_len=128, a_len=512, accum_steps=2,
                 master_dtype="fp32", remat="full")
BUDGET_GAP = 0.10         # predicted against measured peak
# BASELINE config #4 at its full 34 layers: (devices, model axis, batch a data rank)
BUDGET_4B = ((4, 1, 2), (4, 1, 4), (8, 1, 2), (8, 1, 4), (8, 2, 2), (8, 2, 4), (8, 8, 4))
# the cells whose collectives phase 24 prints: 8 x 1 beside 1 x 8 (4 KV heads replicated)
BUDGET_4B_COLLECTIVES = ((8, 1, 4), (8, 8, 4))
RESERVE_CODE = """
import json, subprocess, sys


def used():  # the card's used bytes, all processes (the caller waits meanwhile)
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,"
                          "nounits", "-i", "0"], capture_output=True, text=True, check=True)
    return int(out.stdout.split()[0]) << 20


before = used()
import torch, torch.distributed as dist
from projectiontrainer_tpu_torch.kernels import _build
from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN
x = torch.ones(1024, 1024, device="cuda")
y = x @ x                                  # cuBLAS's handle and workspace
_build.library()                           # the hand-written kernels' library
p = {"scale": torch.ones(1024, device="cuda", dtype=torch.bfloat16),
     "bias": torch.zeros(1024, device="cuda", dtype=torch.bfloat16)}
FLN.layernorm(p, x.bfloat16())             # Triton's module (K2)
dist.init_process_group("nccl", init_method="tcp://127.0.0.1:" + sys.argv[1], rank=0,
                        world_size=1)
dist.all_reduce(x)                         # NCCL's communicator and buffers
torch.cuda.synchronize()
grown = used() - before
print(json.dumps({"total": torch.cuda.mem_get_info()[1], "process_bytes": grown,
                  "reserved": torch.cuda.memory_reserved(),
                  "reserve": grown - torch.cuda.memory_reserved()}))
dist.destroy_process_group()
"""


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_full_depth_budgets(root):
    """``projectiontrainer-torch-budget`` for each BUDGET_4B cell, each in its own
    process (host work alone: fake tensors, no card), all started at once; returns
    [(cell, process, output path)]."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    runs = []
    atexit.register(lambda: [proc.kill() for _, proc, _ in runs if proc.poll() is None])
    for n, m, b in BUDGET_4B:
        path = os.path.join(root, f"budget_{n}x{m}_b{b}.json")
        cmd = [sys.executable, "-m", "projectiontrainer_tpu_torch.cli.budget", "--preset",
               "gemma3-4b", "--n_devices", str(n), "--model_axis", str(m),
               "--batch_per_device", str(b), "--accum_steps", "16"]
        with open(path, "w") as out:
            runs.append(((n, m, b), subprocess.Popen(cmd, stdout=out, stderr=subprocess.PIPE,
                                                     text=True, env=env), path))
    return runs


def check_fake_buffers(rng):
    """Each operator's declared buffers (``*_buffers``, each rounded up to the
    allocator's 512 B: what its fake implementation lets a trace charge) against one
    real launch at phase 2's shapes: the peak of ``memory_allocated`` above the start
    over the launch, scratch included. Returns {kernel: (declared, measured)}."""
    import torch

    from projectiontrainer_tpu_torch.ops import flash_attention as FA
    from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN

    def rounded(bufs):
        return sum(-(-int(np.prod(shape)) * torch.empty((), dtype=dt).element_size() // 512) * 512
                   for shape, dt in bufs.values())

    kw = dict(scale=64 ** -0.5, causal=False, window=None)
    q, k, v, do = (_bf16(rng, (8, 576, 16, 64)) for _ in range(4))
    out, lse, out32 = FA._launch(q, k, v, kv_mask=None, out_f32=True, **kw)
    prep = FA.prepare_bwd(q, k, v, None, out32, lse, do)
    args = (q, k, v, prep[0], prep[1], lse, prep[2])
    x = _bf16(rng, (4608, 1024))
    xb, dy = _bf16(rng, (576, 1024)), _bf16(rng, (576, 1024))
    scale, bias = _bf16(rng, (1024,), 0.5) + 1, _bf16(rng, (1024,), 0.1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = {
        "flash_attn_fwd": (lambda: FA._launch(q, k, v, kv_mask=None, out_f32=True, **kw),
                           FA.fwd_buffers(q, True)),
        "flash_attn_bwd_dkv": (lambda: FA.launch_bwd_dkv(*args, **kw), FA.dkv_buffers(q, k)),
        "flash_attn_bwd_dq": (lambda: FA.launch_bwd_dq(*args, **kw), FA.dq_buffers(q)),
        "layernorm_fwd": (lambda: FLN.layernorm_fwd(x, scale, bias, 1e-6),
                          FLN.fwd_buffers(x)),
        "layernorm_bwd": (lambda: FLN.layernorm_bwd(xb, dy, scale, 1e-6),
                          FLN.bwd_buffers(576, 1024, xb.dtype, FLN.bwd_plan(576, 1024, sms))),
    }
    found = {}
    for name, (launch, bufs) in cases.items():
        launch()  # compiled, its per-stream counters made
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kept = launch()
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - start
        del kept
        found[name] = (rounded(bufs), measured)
        if found[name][0] != measured:
            raise AssertionError(f"budget: {name} declares {found[name][0]} bytes, a launch "
                                 f"allocated {measured}")
    return found


def launch_host_cost(rng, n=1000):
    """Host microseconds a K1 launch at the cls tower's shape ([32,576,16,64]) and at a
    tiny one ([1,64,1,64]), through the ``ptt`` operator and through its CUDA
    implementation called directly (the launch as it was before the operator), the
    buffers made once; ``n`` launches a reading, in turns, the queue drained between."""
    import torch

    from projectiontrainer_tpu_torch.ops import flash_attention as FA

    found = {}
    for label, shape in (("cls tower [32,576,16,64]", (32, 576, 16, 64)),
                         ("tiny [1,64,1,64]", (1, 64, 1, 64))):
        q, k, v = (_bf16(rng, shape) for _ in range(3))
        bufs = {key: torch.empty(sz, dtype=dt, device="cuda")
                for key, (sz, dt) in FA.fwd_buffers(q).items()}
        args = (q, k, v, None, bufs["out"], bufs["lse"], None, 64 ** -0.5, False, 0)
        times = {"operator": [], "direct": []}
        for _ in range(2):
            for key, fn in (("operator", FA.FWD_OP), ("direct", FA._fwd_launch)):
                fn(*args)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn(*args)
                times[key].append((time.perf_counter() - t0) / n * 1e6)
                torch.cuda.synchronize()
        found[label] = {key: min(v) for key, v in times.items()}
        found[label]["extra_us"] = found[label]["operator"] - found[label]["direct"]
    return found


def measure_reserve():
    """The bytes a process holds on the card beyond its allocator's before its first
    tensor of a model: the CUDA context, cuBLAS, the kernel library, Triton's module and
    a 1-rank NCCL communicator, read in a fresh process as the growth of the card's used
    memory (``nvidia-smi``, MiB) over its start-up less its allocator's reserved bytes;
    this process waits meanwhile."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", RESERVE_CODE, str(_free_port())],
                          capture_output=True, text=True, timeout=300, env=env)
    if proc.returncode != 0:
        raise AssertionError(f"budget: the reserve's process exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def budget_rank(argv):
    """A rank of phase 24's 2-card check: the budget's program for phase 22's config
    built for real on this rank of the launcher's world, its applying micro-step run
    under the budget's tracker; dumps the card's peak over it, the tracker's, and the
    bytes the process holds beyond its allocator's to ``<dump>/rank<r>.pt``."""
    import torch

    from projectiontrainer_tpu_torch.parallel import budget, distributed

    dump, _, rank = _rank_entry(argv)
    distributed.initialize("cuda")
    try:
        distributed.setup_mesh(distributed.world_size(), 1)
        program = budget.build_program(fsdp_config(FSDP_LAYERS_SHARING), torch.device("cuda"),
                                       fake=False, **BUDGET_KW)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tracker = budget.MemoryTracker(budget.ALLOCATOR_ROUND)
        ran = budget.run_tracked(program, tracker)
        torch.cuda.synchronize()
        free, total = torch.cuda.mem_get_info()
        torch.save({"rank": rank, "peak": torch.cuda.max_memory_allocated(),
                    "tracked": tracker.peak, "at_peak": tracker.at_peak,
                    "collectives": ran["collectives"],
                    "reserve": total - free - torch.cuda.memory_reserved()},
                   os.path.join(dump, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


def check_budget_nccl(root, smi):
    """With 2 cards or more: the budget's rank-0 peak for phase 22's config at world 2
    against rank 0's ``max_memory_allocated`` over its applying micro-step on 2 NCCL
    ranks, a card each (``budget_rank``), within BUDGET_GAP, and the collectives equal."""
    import torch

    from projectiontrainer_tpu_torch.parallel import budget

    rc, logs, wall = _dp_launch("budget_rank", root, [], 2, "nccl", 600)
    if rc != 0:
        raise AssertionError(f"budget: the 2-rank launch exited {rc}:\n{logs[-6000:]}")
    dump, dump1 = (torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                   for r in range(2))
    two = budget.full_joint_budget(fsdp_config(FSDP_LAYERS_SHARING), n_devices=2, **BUDGET_KW)
    gap = (two["per_device"]["peak_bytes"] - dump["peak"]) / dump["peak"]
    found = {"predicted": two["per_device"], "measured_peak": dump["peak"],
             "tracked": dump["tracked"], "tracked_by_category": dump["at_peak"], "gap": gap,
             # rank 1's card holds no other process (this one's context is on card 0)
             "reserve_rank1": dump1["reserve"], "launch_wall_s": wall,
             "collectives_equal": dump["collectives"] == two["collectives"]}
    print(f"budget world 2 over NCCL ({smi}): {found}", flush=True)
    if not abs(gap) <= BUDGET_GAP or not found["collectives_equal"]:
        raise AssertionError(f"budget: world-2 rank 0 {found}")
    return found


def phase_budget(fsdp_runs, full_depth=None):
    """Phase 24: the memory and collective budget (``parallel/budget.py``) against the
    card. The fake implementations' bytes against real launches; the host cost of the
    operator a launch; the reserve a process holds; the predicted peak of phase 22's
    config at world 1 against ``max_memory_allocated`` over the same micro-step run for
    real (within BUDGET_GAP; the gap by category, the real run under the same tracker);
    the meta trace (a host without CUDA) against the fake CUDA one (equal); the predicted
    collectives and rank-0 peak at phase 22's world against what the trainer's rank 0
    counted and measured there over its applying micro-step (equal; within BUDGET_GAP);
    where the host has 2 cards or more, the predicted rank-0 peak at
    world 2 against rank 0's over 2 NCCL ranks; then BASELINE config #4 at full depth,
    printed: peak, fits and collectives at 4 x 1 and 8 x 1 (batch 2 and 4), 4 x 2, and
    1 x 8 at batch 4 (``--model_axis 8``: the 4 KV heads replicated), its collectives
    beside 8 x 1's (``full_depth``: those traces' processes, from
    ``start_full_depth_budgets``, started earlier; else started here)."""
    import contextlib

    import torch

    from projectiontrainer_tpu_torch.parallel import budget

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    root = tempfile.mkdtemp(prefix="chip_smoke_budget_")
    try:
        if full_depth is None:
            full_depth = start_full_depth_budgets(root)
        rng = np.random.default_rng(SEED + 24)
        buffers = check_fake_buffers(rng)
        host_cost = launch_host_cost(rng)
        gc_cuda()
        reserve = measure_reserve()
        cfg = fsdp_config(FSDP_LAYERS_SHARING)
        predicted = budget.full_joint_budget(cfg, n_devices=1, **BUDGET_KW)
        stand_in = budget.full_joint_budget(cfg, n_devices=1, device="meta", **BUDGET_KW)
        if (stand_in["per_device"], stand_in["collectives"]) != (
                predicted["per_device"], predicted["collectives"]):
            raise AssertionError(f"budget: the meta trace {stand_in['per_device']} differs "
                                 f"from the fake CUDA one {predicted['per_device']}")
        card = {}

        @contextlib.contextmanager
        def around_step():
            torch.cuda.synchronize()
            card["start"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            yield
            torch.cuda.synchronize()
            card["peak"] = torch.cuda.max_memory_allocated()

        gc_cuda()
        real = budget.full_joint_budget(cfg, n_devices=1, fake=False, around_step=around_step,
                                        **BUDGET_KW)
        gc_cuda()
        want = predicted["per_device"]["peak_bytes"]
        gap = (want - card["peak"]) / card["peak"]
        by_category = {k: want_k - real["per_device"][k]
                       for k, want_k in predicted["per_device"].items()}
        print(f"budget world 1 ({smi}): predicted peak {want} bytes, the card's "
              f"max_memory_allocated {card['peak']} ({gap:+.2%}); the tracker over the real "
              f"run {real['per_device']['peak_bytes']}; predicted - tracked by category "
              f"{by_category}", flush=True)
        if not abs(gap) <= BUDGET_GAP:
            raise AssertionError(f"budget: world-1 peak predicted {want}, measured "
                                 f"{card['peak']} ({gap:+.2%})")
        world2 = None
        if fsdp_runs.get("collectives_apply_micro_step") is not None:
            # the trainer itself: phase 22's rank 0 over its applying micro-step
            ranks, layers, backend = fsdp_runs["world"]
            at_world = budget.full_joint_budget(fsdp_config(layers), n_devices=ranks,
                                                **BUDGET_KW)
            traced, counted = at_world["collectives"], fsdp_runs["collectives_apply_micro_step"]
            want2 = at_world["per_device"]["peak_bytes"]
            measured2 = fsdp_runs["peak_apply_micro_step"]
            gap2 = (want2 - measured2) / measured2
            print(f"budget at phase 22's world, {ranks} x 1 over {backend}, {layers} layers "
                  f"({smi}): predicted rank-0 peak {want2} bytes, the trainer's "
                  f"max_memory_allocated over its applying micro-step {measured2} "
                  f"({gap2:+.2%}); collectives predicted {traced}, counted {counted}",
                  flush=True)
            if traced != counted:
                raise AssertionError(f"budget: collectives predicted {traced}, phase 22 "
                                     f"counted {counted}")
            if not abs(gap2) <= BUDGET_GAP:
                raise AssertionError(f"budget: phase 22's rank-0 peak predicted {want2}, "
                                     f"measured {measured2} ({gap2:+.2%})")
            world2 = {"ranks": ranks, "layers": layers, "backend": backend,
                      "collectives": traced, "predicted": at_world["per_device"],
                      "max_memory_allocated": measured2, "gap": gap2}
        nccl2 = check_budget_nccl(root, smi) if torch.cuda.device_count() >= 2 else None
        cells = []
        for (n, m, b), proc, path in full_depth:
            _, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise AssertionError(f"budget: the {n} x {m} batch {b} trace exited "
                                     f"{proc.returncode}:\n{err[-3000:]}")
            with open(path) as f:
                report = json.load(f)
            os.remove(path)
            cells.append({k: report[k] for k in ("mesh", "batch_per_device", "per_device",
                                                 "fits", "oom", "state_bytes_per_device",
                                                 "collectives", "whole_units", "trace_s",
                                                 "traced_on")})
            counts = ""
            if (n, m, b) in BUDGET_4B_COLLECTIVES:
                counts = "; collectives (count by phase) " + json.dumps(
                    {kind: {ph: v["count"] for ph, v in by.items()}
                     for kind, by in report["collectives"].items()})
                counts += f"; whole on every model rank: {report['whole_units']}"
            print(f"budget BASELINE #4 at 34 layers, {n // m} x {m} (data x model), batch {b} "
                  f"a data rank: peak "
                  f"{report['per_device']['peak_bytes'] / 2 ** 30:.2f} GiB, fits "
                  f"{report['fits']}, state {report['state_bytes_per_device'] / 2 ** 30:.2f} "
                  f"GiB, traced in {report['trace_s']:.1f} s{counts}", flush=True)
        emit({"phase": 24, "nvidia_smi": smi, "fake_buffers_declared_measured": buffers,
              "launch_host_us": host_cost, "reserve": reserve,
              "usable_bytes_constant": budget.H100_USABLE_BYTES,
              "reserve_constant": budget.H100_RESERVE_BYTES,
              "world1": {"predicted": predicted["per_device"], "tracked": real["per_device"],
                         "max_memory_allocated": card["peak"], "start": card["start"],
                         "gap": gap, "predicted_minus_tracked": by_category,
                         "trace_s": predicted["trace_s"]},
              "world2_collectives": world2, "world2_nccl": nccl2, "baseline4_full_depth": cells})
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    import gc

    import torch

    t0, walls = time.perf_counter(), {}

    def mark(name):  # the seconds since the last mark, printed at the end
        walls[name] = time.perf_counter() - t0 - sum(walls.values())

    device = phase_device()
    phase_build()
    # phase 24's traces of BASELINE config #4 at full depth: host work alone, in seven
    # processes while the card times phase 2's rows
    full_depth = start_full_depth_budgets(tempfile.gettempdir())
    results = phase_kernels()
    mark("0-2 device, build, kernels")

    kernel_counters = counters()
    cfg, params = full_width_model()
    serve_launches = phase_serve(cfg, params, [kernel_counters[n] for n in SERVE_KERNELS])
    phase_end_to_end(cfg, params)
    wide_beams = phase_serve_wide_beams(cfg, params,
                                        [kernel_counters[n] for n in SERVE_KERNELS])
    check_profiler_spans()
    train_launches = phase_train(cfg, params, kernel_counters)
    phase_train_end_to_end(cfg, params, kernel_counters)
    mark("3-6 serve, stage 1")
    del cfg, params
    gc.collect()
    torch.cuda.empty_cache()
    head_dim_1024 = phase_head_dim_1024(kernel_counters)
    gc_cuda()
    mark("6b head dim 1024")

    cfg, params = stage0_model()
    stage0_launches, stage0_stats = phase_stage0_train(cfg, params, kernel_counters)
    gc.collect()
    torch.cuda.empty_cache()
    phase_stage0_end_to_end(cfg, params, kernel_counters)
    gc.collect()
    torch.cuda.empty_cache()
    files_launches = phase_feed(cfg, params, kernel_counters, stage0_stats)
    mark("7-8, 16 stage 0, the feed")
    del cfg, params
    gc.collect()
    torch.cuda.empty_cache()

    cfg, params = full_width_model(STAGE2_LAYERS)
    stage2_launches, stage2_step, params = phase_stage2_train(cfg, params, kernel_counters)
    gc.collect()
    torch.cuda.empty_cache()
    phase_stage2_end_to_end(cfg, params, kernel_counters)
    mark("9-10 stage 2")
    del cfg, params
    gc.collect()
    torch.cuda.empty_cache()

    cfg, params = qwen3_model("nf4-mirror", layers=QLORA_LAYERS)
    qlora_launches, params, adapter_dir = phase_qlora_train(cfg, params, kernel_counters)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        phase_qlora_end_to_end(cfg, params, kernel_counters)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        cfg, params = qwen3_model(layers=QLORA_LAYERS)  # dense bf16, the same seed
        qlora_serve = phase_serve(cfg, params, [kernel_counters[n] for n in SERVE_KERNELS],
                                  clients=8, adapter_path=adapter_dir, phase=13)
        del params
    finally:
        shutil.rmtree(adapter_dir, ignore_errors=True)
    gc_cuda()
    mark("11-13 QLoRA")

    cfg, params = cls_model()
    cls_launches = phase_cls_train(cfg, params, kernel_counters)
    gc_cuda()
    phase_cls_end_to_end(cfg, params, kernel_counters)
    del cfg, params
    gc_cuda()
    mark("14-15 cls")

    cfg, params = llama_vlm()
    slice_launches = {**head_dim_1024, "serve_24_beams": wide_beams,
                      "caption_llama": phase_caption(cfg, params, kernel_counters),
                      "generation_eval": phase_generation_eval(cfg, params, kernel_counters)}
    del cfg, params
    gc_cuda()
    slice_launches.update(phase_zero_shot_tsne(kernel_counters))
    gc_cuda()
    mark("17-19 inference")

    dp = phase_data_parallel()  # the ranks count their own launches
    mark("20 data parallel")
    slice_launches["stage1_dp_rank0"] = {n: dp["stage1_dp"][n] for n in STAGE1_KERNELS}
    slice_launches["stage0_dp_rank0"] = {n: dp["stage0_dp"][n] for n in STAGE0_KERNELS}
    tp_runs = phase_tensor_parallel()
    mark("21 tensor parallel")
    for path, kernels in (("stage2_qlora_tp_rank0", STAGE2_QLORA_KERNELS),
                          ("stage1_tp_rank0", STAGE1_KERNELS),
                          *((f"stage1_tp3_rank{r}", STAGE1_KERNELS) for r in range(TP3_RANKS))):
        if path in tp_runs:
            slice_launches[path] = {n: tp_runs[path][n] for n in kernels}
    gc_cuda()
    fsdp_runs = phase_fsdp()
    mark("22 fsdp")
    if "stage2_fsdp_rank0" in fsdp_runs:
        slice_launches["stage2_fsdp_rank0"] = {n: fsdp_runs["stage2_fsdp_rank0"][n]
                                               for n in STAGE2_KERNELS}
    gc_cuda()
    tt_runs = phase_tp_towers()
    stop_legs_servers()
    mark("23 tensor parallel towers")
    gc_cuda()
    phase_budget(fsdp_runs, full_depth)
    mark("24 budget")
    for path, kernels in (("stage0_tp_rank0", STAGE0_KERNELS),
                          ("stage0_fsdp_tp_rank0", STAGE0_KERNELS),
                          ("cls_tp_rank0", CLS_KERNELS)):
        if path in tt_runs:
            slice_launches[path] = {n: tt_runs[path][n] for n in kernels}

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
                        "launches_per_fsdp_micro_step": fsdp_runs.get(
                            "stage2_fsdp_micro_step", {}).get(name),
                        "max_abs_err": max(r["max_abs_err"] for r in rows),
                        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                        "library_ms": main_row["library_ms"], "library": main_row["library"],
                        "timed_case": main_row["case"],
                        "widest": [{k: r.get(k) for k in ("case", "max_abs_err", "ms", "plain_ms",
                                                          "bound_ms", "bound_by", "library_ms",
                                                          "library", "plan_route",
                                                          "plan_source", "library_gqa_ms")
                                    if k in r}
                                   for r in rows if r.get("widest")]})
    emit({"phase_walls_s": walls, "total_s": time.perf_counter() - t0})
    emit({"kernels": kernels})
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
