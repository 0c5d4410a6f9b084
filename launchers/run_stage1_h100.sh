#!/bin/bash
# Stage 1 (projector alignment) on one node of NVIDIA H100s, data parallel through the
# PyTorch port: one process per GPU, started by projectiontrainer-torch-launch (the
# recipe of run_stage1_v5e8.sh; the reference's accelerate launch over 3 GPUs,
# Stage1/run_projection_train_stage1.sh). Usage: NPROC=8 launchers/run_stage1_h100.sh
set -euo pipefail

# --- Run --- #
RUN_NAME="stage1_gemma3-1b_vitl384"
OUTPUT_DIR="./runs/stage1/${RUN_NAME}"

# --- Data --- #
TRAIN_JSON="/data/cxr/captions_train.json"       # [{"image": ..., "caption": ...}]
IMAGE_ROOT="/data/cxr/images"
IMAGE_ROOT_2=""                                   # optional MIMIC-style second root

# --- Models (local HF snapshot dirs) --- #
VISION_MODEL="/models/XraySigLIP__vit-l-16-siglip-384__webli"
LLM_MODEL="/models/gemma-3-1b-it"

NPROC="${NPROC:-$(nvidia-smi -L | wc -l)}"       # one rank per visible GPU

# --- Hyperparameters (reference defaults: run_projection_train_stage1.sh:6-22) --- #
GLOBAL_BATCH=8          # the v5e-8 recipe's global batch; --batch_size is per GPU
BATCH_SIZE=$(( GLOBAL_BATCH / NPROC > 0 ? GLOBAL_BATCH / NPROC : 1 ))
GRAD_ACCUM=2
LR=3e-5
EPOCHS=10
WARMUP_RATIO=0.05

exec projectiontrainer-torch-launch --nproc_per_node "${NPROC}" --backend nccl \
  --feeder_procs auto stage1 -- \
  --train_json "${TRAIN_JSON}" \
  --image_root "${IMAGE_ROOT}" \
  ${IMAGE_ROOT_2:+--image_root_2 "${IMAGE_ROOT_2}"} \
  --vision_model_name "${VISION_MODEL}" \
  --llm_name "${LLM_MODEL}" \
  --output_dir "${OUTPUT_DIR}" \
  --batch_size "${BATCH_SIZE}" \
  --gradient_accumulation_steps "${GRAD_ACCUM}" \
  --learning_rate "${LR}" \
  --num_epochs "${EPOCHS}" \
  --warmup_ratio "${WARMUP_RATIO}" \
  --enable_qlora \
  --mesh_data -1 --mesh_model 1 \
  --wandb_project projection_stage1 --wandb_run_name "${RUN_NAME}" \
  "$@"
