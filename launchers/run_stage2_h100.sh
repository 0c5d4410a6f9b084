#!/bin/bash
# Stage 2 (VQA instruction fine-tune, QLoRA over Qwen3-8B) on one node of NVIDIA H100s
# through the PyTorch port: the recipe of run_stage2_v5e8.sh (the reference's accelerate
# launch over 3 GPUs + bitsandbytes NF4, Stage2/run_vqa_train_stage2.sh:73) with its
# data x model mesh: each replica of the 8B decoder is split over MESH_MODEL GPUs
# (tensor parallelism: heads, hidden columns and the vocab sharded), and the replicas
# take the batch. One process per GPU, started by projectiontrainer-torch-launch over
# NCCL. Usage: NPROC=8 launchers/run_stage2_h100.sh
set -euo pipefail

RUN_NAME="stage2_qwen3-8b_qlora"
STAGE1_RUN="./runs/stage1/stage1_qwen3-8b_vitl384"
OUTPUT_DIR="./runs/stage2/${RUN_NAME}"

TRAIN_JSON="/data/cxr/vqa_train.json"   # [{"image", "problem", "normal_caption"}]
VAL_JSON="/data/cxr/vqa_val.json"
IMAGE_ROOT="/data/cxr/images"
IMAGE_ROOT_2=""                          # optional MIMIC-style second root

VISION_MODEL="/models/XraySigLIP__vit-l-16-siglip-384__webli"
LLM_MODEL="/models/Qwen3-8B"

NPROC="${NPROC:-$(nvidia-smi -L | wc -l)}"   # one rank per visible GPU
MESH_MODEL="${MESH_MODEL:-2}"                 # GPUs per replica (run_stage2_v5e8.sh: 2)
MESH_DATA=$(( NPROC / MESH_MODEL ))           # replicas (run_stage2_v5e8.sh: 4)

# reference config: bs4 x 3 GPUs x ga8, lr 1e-5, 3 epochs, q<=256/a<=1024, LoRA r16
# (run_vqa_train_stage2.sh:26-53); run_stage2_v5e8.sh's global batch of 16.
GLOBAL_BATCH=16
BATCH_SIZE=$(( GLOBAL_BATCH / MESH_DATA > 0 ? GLOBAL_BATCH / MESH_DATA : 1 ))  # per replica
GRAD_ACCUM=8
LR=1e-5
EPOCHS=3
RESUME_QLORA_PATH=""    # set to .../checkpoint-epoch_N/language_model to warm-start

exec projectiontrainer-torch-launch --nproc_per_node "${NPROC}" --backend nccl \
  --feeder_procs auto stage2 -- \
  --train_json "${TRAIN_JSON}" \
  --val_json "${VAL_JSON}" \
  --image_root "${IMAGE_ROOT}" \
  ${IMAGE_ROOT_2:+--image_root_2 "${IMAGE_ROOT_2}"} \
  --vision_model_name "${VISION_MODEL}" \
  --llm_name "${LLM_MODEL}" \
  --stage1_projector_path "${STAGE1_RUN}" \
  --output_dir "${OUTPUT_DIR}" \
  --batch_size "${BATCH_SIZE}" \
  --gradient_accumulation_steps "${GRAD_ACCUM}" \
  --learning_rate "${LR}" \
  --num_epochs "${EPOCHS}" \
  --warmup_ratio 0.05 \
  --max_q_len 256 --max_a_len 1024 \
  --enable_qlora --quant_method nf4-mirror \
  --lora_r 16 --lora_alpha 32 --lora_dropout 0.05 \
  ${RESUME_QLORA_PATH:+--resume_qlora_adapter_path "${RESUME_QLORA_PATH}"} \
  --mesh_data "${MESH_DATA}" --mesh_model "${MESH_MODEL}" \
  --wandb_project vqa_stage2 --wandb_run_name "${RUN_NAME}" \
  "$@"
