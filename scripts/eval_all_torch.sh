#!/usr/bin/env bash
# The evaluation suite on the PyTorch port, on one NVIDIA GPU (sibling of
# scripts/eval_all.sh; the reference's eval/scripts/eval_all.sh contract):
# V-STAR inference, then the Qwen2.5-72B judge (TVGBench, VideoMME,
# WorldSense and VideoMMMU below, commented out). The judge's decoder is
# group-128 int4 (~40 GB), so it runs on the same single card.
set -euo pipefail

MODEL_PATH=${MODEL_PATH:?set MODEL_PATH to the evaluated checkpoint}
JUDGE_PATH=${JUDGE_PATH:-/path/to/Qwen2.5-72B-Instruct}
DATA_DIR=${DATA_DIR:?set DATA_DIR to the benchmark data root}
OUT_DIR=${OUT_DIR:-./eval_results}
DEVICE=${DEVICE:-cuda}
mkdir -p "${OUT_DIR}"

# ---- V-STAR: inference then LLM-judge scoring -------------------------------
python -m open_o3_video_tpu_torch.eval.cli vstar \
    --model_path "${MODEL_PATH}" \
    --anno "${DATA_DIR}/vstar/annotations.json" \
    --video_folder "${DATA_DIR}/vstar/videos" \
    --output "${OUT_DIR}/vstar_results.json" \
    --item_batch "${ITEM_BATCH:-4}" \
    --device "${DEVICE}"

python -m open_o3_video_tpu_torch.eval.cli vstar-judge \
    --model_path "${JUDGE_PATH}" \
    --result_file "${OUT_DIR}/vstar_results.json" \
    --load_in_int4 \
    --device "${DEVICE}"

# ---- Other benchmarks (as scripts/eval_all.sh lists them) -------------------
# python -m open_o3_video_tpu_torch.eval.cli tvgbench \
#     --model_path "${MODEL_PATH}" --anno "${DATA_DIR}/tvgbench/annotations.json" \
#     --video_folder "${DATA_DIR}/tvgbench/videos" --output "${OUT_DIR}/tvgbench_results.json" \
#     --device "${DEVICE}"
#
# python -m open_o3_video_tpu_torch.eval.cli videomme \
#     --model_path "${MODEL_PATH}" --data_dir "${DATA_DIR}/videomme" \
#     --N 1 --vote majority_voting --output "${OUT_DIR}/videomme_results.json" \
#     --device "${DEVICE}"
#
# python -m open_o3_video_tpu_torch.eval.cli worldsense \
#     --model_path "${MODEL_PATH}" --data_dir "${DATA_DIR}/worldsense" \
#     --asr_dir "${DATA_DIR}/worldsense/asr" \
#     --N 1 --vote majority_voting --output "${OUT_DIR}/worldsense" \
#     --device "${DEVICE}"
#
# python -m open_o3_video_tpu_torch.eval.cli videommmu \
#     --model_path "${MODEL_PATH}" --data_dir "${DATA_DIR}/videommmu" \
#     --N 1 --vote majority_voting --output "${OUT_DIR}/videommmu_results.json" \
#     --device "${DEVICE}"
