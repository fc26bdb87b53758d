#!/usr/bin/env bash
# GSPO RL on STGR-RL-36k with the PyTorch port on one CUDA device (sibling
# of scripts/run_grpo_video.sh, at the reference's flags: max_prompt_length
# 16384, completion 768, beta 0.04, grad-norm 5, 4 generations, lr 1e-6),
# under PEFT (LoRA rank 16, alpha 32, q_proj/v_proj): a full fine-tune step
# of the 7B model with its frozen reference copy does not fit one 80 GB card.
set -euo pipefail

export WANDB_MODE=${WANDB_MODE:-offline}

DATA_ROOT=${DATA_ROOT:?set DATA_ROOT to the dataset root}
MODEL_PATH=${MODEL_PATH:?set MODEL_PATH to the SFT checkpoint}
DATASET=${DATASET:-${DATA_ROOT}/annotations/STGR-RL-36k.json}
OUTPUT_DIR=${OUTPUT_DIR:-./checkpoints/gspo_video_torch}

python -m open_o3_video_tpu_torch.train.grpo_main \
    --model_name_or_path "${MODEL_PATH}" \
    --dataset_name "${DATASET}" \
    --data_root "${DATA_ROOT}" \
    --output_dir "${OUTPUT_DIR}" \
    --max_prompt_length 16384 \
    --max_completion_length 768 \
    --num_generations 4 \
    --beta 0.04 \
    --max_grad_norm 5 \
    --learning_rate 1e-6 \
    --max_pixels 401408 \
    --save_steps 500 \
    --logging_steps 1 \
    --use_peft \
    --lora_r 16 \
    --lora_alpha 32 \
    --lora_target_modules q_proj,v_proj \
    --report_to "${REPORT_TO:-wandb}" \
    --device "${DEVICE:-cuda}" \
    "$@"
