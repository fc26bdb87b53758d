#!/usr/bin/env bash
# SFT cold-start on STGR-CoT-30k with the PyTorch port on one CUDA device
# (sibling of scripts/run_sft_video.sh, at the reference's flags: a full
# fine-tune at lr 1e-6 in bf16 with gradient checkpointing, one example a
# step). Pass --use_peft (and --lora_r/--lora_alpha/--lora_target_modules)
# for LoRA over the frozen base.
set -euo pipefail

export WANDB_MODE=${WANDB_MODE:-offline}

DATA_ROOT=${DATA_ROOT:?set DATA_ROOT to the dataset root}
MODEL_PATH=${MODEL_PATH:?set MODEL_PATH to Qwen2.5-VL-7B-Instruct}
DATASET=${DATASET:-${DATA_ROOT}/annotations/STGR-CoT-30k.json}
OUTPUT_DIR=${OUTPUT_DIR:-./checkpoints/sft_video_torch}

python -m open_o3_video_tpu_torch.train.sft_main \
    --model_name_or_path "${MODEL_PATH}" \
    --dataset_name "${DATASET}" \
    --data_root "${DATA_ROOT}" \
    --output_dir "${OUTPUT_DIR}" \
    --learning_rate 1e-6 \
    --num_train_epochs 1 \
    --save_steps 500 \
    --logging_steps 1 \
    --gradient_checkpointing \
    --bf16 \
    --report_to "${REPORT_TO:-wandb}" \
    --device "${DEVICE:-cuda}" \
    "$@"
