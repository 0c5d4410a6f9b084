#!/bin/bash
# Stage 2 full-joint (BASELINE.json config #4: --train_ve_first_epoch, the vision tower in
# epoch 0, the projector and the whole Gemma3-4B decoder trained) on one node of NVIDIA
# H100s through the PyTorch port. Fp32 masters, the Adam moments and the accumulator take
# about 16 bytes a parameter, ~68 GB for the ~4.2 B parameters of ViT-L/16-384 +
# projector + Gemma3-4B: more than one card holds. --fsdp shards the params and that
# state over the data axis (ZeRO-3, parallel/fsdp.py): each of the NPROC ranks (one per
# GPU, over NCCL) keeps 1/NPROC of every large leaf, gathers a layer's weights as it runs
# and reduce-scatters their gradients. Usage: NPROC=4 launchers/run_stage2_full_joint_h100.sh
set -euo pipefail

RUN_NAME="stage2_gemma3-4b_full_joint"
STAGE1_RUN="./runs/stage1/stage1_gemma3-4b_vitl384"
OUTPUT_DIR="./runs/stage2/${RUN_NAME}"

TRAIN_JSON="/data/cxr/vqa_train.json"   # [{"image", "problem", "normal_caption"}]
VAL_JSON="/data/cxr/vqa_val.json"
IMAGE_ROOT="/data/cxr/images"
IMAGE_ROOT_2=""                          # optional MIMIC-style second root

VISION_MODEL="/models/XraySigLIP__vit-l-16-siglip-384__webli"
LLM_MODEL="/models/gemma-3-4b-it"

NPROC="${NPROC:-$(nvidia-smi -L | wc -l)}"   # one data rank per visible GPU

# the reference's stage-2 schedule (run_vqa_train_stage2.sh:26-53: lr 1e-5, accumulation
# 8, q<=256 / a<=1024), batch 1 a rank (the 4B's activations at 1855 tokens), fp32
# masters with bf16 compute, per-layer remat
BATCH_SIZE=1
GRAD_ACCUM=8
LR=1e-5
EPOCHS=3

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
  --unfreeze_llm --unfreeze_projection_layer --train_ve_first_epoch \
  --master_dtype fp32 --mixed_precision bf16 --remat full \
  --fsdp --mesh_data "${NPROC}" \
  --wandb_project vqa_stage2 --wandb_run_name "${RUN_NAME}" \
  "$@"
