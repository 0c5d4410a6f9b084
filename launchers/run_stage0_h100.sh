#!/bin/bash
# Stage 0 (SigLIP contrastive vision-encoder fine-tune) on one node of NVIDIA H100s,
# data parallel through the PyTorch port: one process per GPU, started by
# projectiontrainer-torch-launch (the recipe of run_stage0_v5e8.sh; the reference's
# torchrun launcher, Stage0/run_train_vision_encoder_stage0.sh:62, 3 GPUs + NCCL).
# The sigmoid loss uses per-rank negatives (--local_negatives, the reference's DDP
# semantics). Usage: NPROC=8 launchers/run_stage0_h100.sh [extra stage-0 flags]
set -euo pipefail

RUN_NAME="stage0_so400m512"
OUTPUT_DIR="./runs/stage0/${RUN_NAME}"

TRAIN_JSON="/data/cxr/pairs_train.json"          # [{"image": ..., "caption": ...}]
IMAGE_ROOT="/data/cxr/images"

MODEL="/models/siglip2-so400m-patch16-512"

NPROC="${NPROC:-$(nvidia-smi -L | wc -l)}"       # one rank per visible GPU

# reference config: bs16 x 3 GPUs x ga4, lr 5e-5, 100 epochs, bf16, augmentation on
# (run_train_vision_encoder_stage0.sh:13-48); --batch_size is per GPU in the port.
BATCH_SIZE=16           # global = 16 x NPROC
GRAD_ACCUM=4
LR=5e-5
EPOCHS=100

# stage-0 at 512px is the hungriest host pipeline: 8 decode+augment workers a GPU,
# shared out by the launcher (each rank takes FEEDER_PROCS / NPROC)
exec projectiontrainer-torch-launch --nproc_per_node "${NPROC}" --backend nccl \
  --feeder_procs "$((8 * NPROC))" stage0 -- \
  --train_json "${TRAIN_JSON}" \
  --image_root "${IMAGE_ROOT}" \
  --model_name "${MODEL}" \
  --output_dir "${OUTPUT_DIR}" \
  --img_size 512 \
  --batch_size "${BATCH_SIZE}" \
  --gradient_accumulation_steps "${GRAD_ACCUM}" \
  --learning_rate "${LR}" \
  --num_epochs "${EPOCHS}" \
  --freeze_text_encoder --freeze_logit_scale \
  --use_online_augmentation \
  --local_negatives \
  --val_split 0.05 \
  --mesh_data -1 --mesh_model 1 \
  --wandb_project siglip_stage0 --wandb_run_name "${RUN_NAME}" \
  "$@"
