"""SFT dataset: per-task message building and the collate paths
(counterpart of ``open_o3_video_tpu/data/sft_dataset.py``, which imports PIL
and JAX).

Rebuilds the reference's prepare_dataset + collate_fn (sft_multi_task.py):

- visual QA: image grounding with the box text rescaled to the resized image;
- temporal-spatial free-form QA: the ground-truth keyframes interleaved with
  the frames by time, Gemini boxes rewritten to pixels;
- temporal QA / General video QA: the timestamped frame prompt.

Targets are ``<think>...</think>\\n<answer>...</answer>``; labels mask pad and
visual tokens. ``collate_sft_frames`` is the temporal / general branch after
the media fetch (it takes decoded frames), which ``collate_sft`` calls;
media are read by ``data/video.py`` (the native libav decoder or OpenCV) and
resized by the PIL-parity bicubic of ``ops/resize.py``.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Optional, Sequence

import numpy as np

from ..grounding.coords import resize_boxes_in_text, rewrite_gemini_boxes_in_text
from ..grounding.prompts import (
    SFT_SYSTEM_PROMPT,
    VISION_PLACEHOLDER,
    frame_prompt_sft_temporal,
    interleave_keyframes,
)
from ..models.qwen25vl.model import build_vision_row_index, get_rope_index
from .media_roots import media_roots
from .rl_dataset import load_keyframes
from .video import fetch_image, fetch_video

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


def load_sft_dataset(path: str) -> list[dict[str, Any]]:
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [json.loads(line) for line in f if line.strip()]
        return json.load(f)


def prepare_sft_example(example: dict[str, Any], data_root: str) -> dict[str, Any]:
    """Attach the chat messages with the assistant target
    (sft_multi_task.py:56-204)."""
    task = example["task"]
    roots = media_roots(data_root)
    target = ("<think>" + example["reasoning_process"] + "</think>\n<answer>" + example["answer"]
              + "</answer>")

    def wrap(media, question_text):
        return [
            {"role": "system", "content": [{"type": "text", "text": SFT_SYSTEM_PROMPT[task]}]},
            {"role": "user", "content": [media, {"type": "text", "text": question_text}]},
            {"role": "assistant", "content": [{"type": "text", "text": target}]},
        ]

    if task == "visual QA":
        media = {"type": "image", "image": os.path.join(roots["treevgr"], example["image_path"])}
        messages = wrap(media, example["question"])
        return {"messages": messages, "image_size": example["image_size"], "task": task,
                "source": example["source"], "key_frames": []}
    if task == "temporal-spatial free-form QA":
        root = roots["str_plm"] if example["source"] == "STR_plm_rdcap" else roots["str"]
        media = {"type": "video", "video": os.path.join(root, example["video_path"])}
        messages = wrap(media, example["question"])
        return {"messages": messages, "key_frames": example["key_frames"], "task": task,
                "source": example["source"], "image_size": []}
    if task == "temporal QA":
        media = {"type": "video", "video": os.path.join(roots["tvg"], example["video_path"])}
        messages = wrap(media, "Question: " + example["question"])
        return {"messages": messages, "task": task, "source": example["source"],
                "key_frames": [], "image_size": []}
    if task in ("General video QA MCQ", "General video QA Free-form"):
        media = {"type": "video", "video": os.path.join(roots["videor1"], example["video_path"])}
        messages = wrap(media, "Question: " + example["question"])
        return {"messages": messages, "task": task, "source": example["source"],
                "key_frames": [], "image_size": []}
    raise ValueError(f"Unknown task: {task}")


def _single_row(proc, processor, model_cfg) -> dict[str, Any]:
    """A processed example -> a train-step batch of one row: labels with pad
    and visual tokens masked, M-RoPE positions from the grids."""
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


def collate_sft_frames(
    messages: list[dict[str, Any]],
    frames: Sequence[np.ndarray],
    fps: float,
    processor,
    model_cfg,
) -> dict[str, Any]:
    """One example (system, user with a video, assistant target) and its
    decoded frames (CHW) -> a train-step batch of one row: the video
    placeholder becomes the SFT temporal frame prompt (one image per frame).
    The temporal QA / General video QA branch of ``collate_sft``."""
    text = processor.apply_chat_template(messages, add_generation_prompt=False)
    text = text.replace(VISION_PLACEHOLDER, frame_prompt_sft_temporal(len(frames), fps))
    return _single_row(processor(text, images=list(frames)), processor, model_cfg)


def collate_sft(
    example: dict[str, Any],
    processor,
    model_cfg,
    data_root: str,
    *,
    nframes: Optional[int] = None,
) -> dict[str, Any]:
    """One prepared example -> a train-step batch of one row (the
    reference's bs = 1, sft_multi_task.py:294), its media read from
    ``data_root``."""
    example = copy.deepcopy(example)
    messages = example["messages"]
    task = example["task"]
    video_ele = image_ele = None
    for msg in messages:
        if isinstance(msg["content"], list):
            for ele in msg["content"]:
                if ele.get("type") == "video":
                    video_ele = dict(ele)
                elif ele.get("type") == "image":
                    image_ele = dict(ele)

    if task == "visual QA":
        text = processor.apply_chat_template(messages, add_generation_prompt=False)
        img = fetch_image(image_ele)  # CHW
        text = resize_boxes_in_text(text, example["image_size"], [img.shape[2], img.shape[1]])
        return _single_row(processor(text, images=[img]), processor, model_cfg)

    if nframes is not None:
        video_ele["nframes"] = nframes
    video, fps = fetch_video(video_ele)
    T, _, H, W = video.shape
    frames = [video[i] for i in range(T)]
    if task != "temporal-spatial free-form QA":  # temporal QA / General video QA
        return collate_sft_frames(messages, frames, fps, processor, model_cfg)
    kf_frames = load_keyframes(example, data_root, (W, H))
    kf_times = [kf["time"] for kf in example["key_frames"]]
    plan, frame_prompt = interleave_keyframes(T, fps, kf_times, round_kf_display=False,
                                              append_total_line=False)
    images = [frames[i] if kind == "video" else kf_frames[i] for kind, i in plan]
    text = processor.apply_chat_template(messages, add_generation_prompt=False)
    text = text.replace(VISION_PLACEHOLDER, frame_prompt)
    text = rewrite_gemini_boxes_in_text(text, (W, H))
    return _single_row(processor(text, images=images), processor, model_cfg)


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


def collate_sft_batch(
    examples: list[dict[str, Any]],
    processor,
    model_cfg,
    data_root: str,
    *,
    nframes: Optional[int] = None,
    pad_multiple: int = 64,
) -> dict[str, Any]:
    """B prepared examples -> one padded batch (see ``pack_sft_batch``)."""
    singles = [collate_sft(ex, processor, model_cfg, data_root, nframes=nframes)
               for ex in examples]
    return pack_sft_batch(singles, model_cfg, pad_multiple=pad_multiple)
