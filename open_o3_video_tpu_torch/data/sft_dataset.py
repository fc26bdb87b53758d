"""SFT batches: labels masked as the reference masks them, and several
examples packed into one right-padded batch (counterpart of part of
``open_o3_video_tpu/data/sft_dataset.py``, which imports PIL and JAX).

``collate_sft_frames`` is the part of the JAX ``collate_sft`` after the
media fetch, for the temporal / general video QA tasks: it takes the chat
messages and the already decoded frames with their sampling rate. Decoding
a video file waits for a port of ``data/video.py``.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from ..grounding.prompts import VISION_PLACEHOLDER, frame_prompt_sft_temporal
from ..models.qwen25vl.model import build_vision_row_index, get_rope_index

VISUAL_TOKEN_IDS = (151655,)  # Qwen2.5-VL masks the image-pad token
IGNORE_INDEX = -100


def visual_mask_ids(model_cfg) -> tuple[int, ...]:
    """Which special tokens the SFT labels mask, by family: Qwen2-VL masks
    vision_start/vision_end/video_pad, every other family only the image
    token the processor expands (Qwen2.5-VL: 151655)."""
    if getattr(model_cfg, "model_type", "") == "qwen2_vl":
        return (
            model_cfg.vision_start_token_id,
            model_cfg.vision_end_token_id,
            model_cfg.video_token_id,
        )
    return (getattr(model_cfg, "image_token_id", None) or VISUAL_TOKEN_IDS[0],)


def collate_sft_frames(
    messages: list[dict[str, Any]],
    frames: Sequence[np.ndarray],
    fps: float,
    processor,
    model_cfg,
) -> dict[str, Any]:
    """One example (system, user with a video, assistant target) and its
    decoded frames (CHW uint8) -> a train-step batch of one row: the video
    placeholder becomes the SFT temporal frame prompt (one image per frame),
    labels mask pad and visual tokens, M-RoPE positions from the grids."""
    text = processor.apply_chat_template(messages, add_generation_prompt=False)
    text = text.replace(VISION_PLACEHOLDER, frame_prompt_sft_temporal(len(frames), fps))
    proc = processor(text, images=list(frames))

    input_ids = np.asarray([proc.input_ids])
    labels = input_ids.copy()
    pad_id = getattr(processor.tokenizer, "pad_token_id", None)
    if pad_id is not None:
        labels[labels == pad_id] = IGNORE_INDEX
    for tok in visual_mask_ids(model_cfg):
        labels[labels == tok] = IGNORE_INDEX

    position_ids, _ = get_rope_index(model_cfg, input_ids, image_grid_thw=proc.grid_thw)
    return {
        "input_ids": input_ids,
        "labels": labels,
        "position_ids": position_ids,
        "pixel_patches": proc.pixel_patches,
        "grid_thw": proc.grid_thw,
        "vision_token_id": model_cfg.image_token_id,
    }


def pack_sft_batch(
    singles: list[dict[str, Any]],
    model_cfg,
    *,
    pad_multiple: int = 64,
) -> dict[str, Any]:
    """Pad per-example collates into one batch: B rows, right-padded to a
    shared multiple of ``pad_multiple``, vision patches concatenated in row
    order with an explicit row-index map (numpy, as the JAX package's)."""
    B = len(singles)
    lens = [s["input_ids"].shape[1] for s in singles]
    L = -(-max(lens) // pad_multiple) * pad_multiple
    pad_id = model_cfg.pad_token_id

    ids = np.full((B, L), pad_id, dtype=np.int64)
    labels = np.full((B, L), IGNORE_INDEX, dtype=np.int64)
    attn_valid = np.zeros((B, L), dtype=bool)
    pos = np.ones((3, B, L), dtype=np.int64)  # HF keeps pad positions at 1
    patch_list, grid_list, offsets = [], [], []
    n_merged = 0
    for b, s in enumerate(singles):
        n = lens[b]
        ids[b, :n] = s["input_ids"][0]
        labels[b, :n] = s["labels"][0]
        attn_valid[b, :n] = True
        pos[:, b, :n] = s["position_ids"][:, 0]
        offsets.append(n_merged)
        if s.get("pixel_patches") is not None:
            patch_list.append(np.asarray(s["pixel_patches"]))
            grid_list.append(np.asarray(s["grid_thw"]))
            n_merged += patch_list[-1].shape[0] // model_cfg.vision.merge_unit

    batch: dict[str, Any] = {
        "input_ids": ids,
        "labels": labels,
        "position_ids": pos,
        "attn_valid": attn_valid,
    }
    if patch_list:
        tok = model_cfg.image_token_id
        batch["pixel_patches"] = np.concatenate(patch_list, axis=0)
        batch["grid_thw"] = np.concatenate(grid_list, axis=0)
        batch["vision_token_id"] = tok
        batch["vision_row_index"] = build_vision_row_index(ids, tok, offsets)
    return batch
