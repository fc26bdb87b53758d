"""RL dataset: loading, prompt attachment and per-step sample preparation
(counterpart of ``open_o3_video_tpu/data/rl_dataset.py``, which imports PIL).

- ``load_rl_dataset``: JSON/JSONL, the conversation attached, the train size
  cut to a multiple of 4 (the reference's ``data_loader.py:43-58``);
- ``rl_sample_from_frames``: the part after decoding, for the video tasks:
  the frame prompt with timestamps, the ground-truth keyframes interleaved
  for the temporal-spatial task, tokenization, the reward columns;
- ``prepare_rl_sample``: resolves the media, reads the video (``data/video.py``,
  OpenCV) and the keyframes or the image (OpenCV, resized by the PIL-parity
  bicubic instead of PIL), then the above. Where cv2 is missing it raises an
  ImportError that says so; the card's machine has no cv2, so its smoke run
  feeds ``rl_sample_from_frames`` synthetic frames.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Optional, Sequence

import numpy as np

from ..grounding.prompts import (
    VISION_PLACEHOLDER,
    frame_prompt_rl,
    interleave_keyframes,
    make_conversation,
)
from .media_roots import keyframe_root, resolve_media
from .video import fetch_image, fetch_video, read_image, resize_image


def load_rl_dataset(path: str) -> list[dict[str, Any]]:
    """JSON/JSONL -> examples with their 'prompt' chat attached; the train
    size cut to a multiple of 4."""
    with open(path) as f:
        if path.endswith(".jsonl"):
            data = [json.loads(line) for line in f if line.strip()]
        else:
            data = json.load(f)
    data = [make_conversation(dict(ex)) for ex in data]
    keep = len(data) - (len(data) % 4)
    print(f"Dataset 'train' split size: {keep}")
    return data[:keep]


def _clean_none(example: dict[str, Any]) -> dict[str, Any]:
    """Drop None-valued entries from content dicts and key_items
    (grpo_trainer.py:386-394, 439-450)."""
    for entry in example.get("prompt", []):
        if isinstance(entry.get("content"), list):
            for sub in entry["content"]:
                if isinstance(sub, dict):
                    for key in [k for k, val in sub.items() if val is None]:
                        del sub[key]
    if isinstance(example.get("key_items"), dict):
        for key in [k for k, val in example["key_items"].items() if val is None]:
            del example["key_items"][key]
        for item in example["key_items"].values():
            if isinstance(item, dict):
                for key in [k for k, val in item.items() if val is None]:
                    del item[key]
    return example


def _prepared(example: dict[str, Any]) -> dict[str, Any]:
    example = copy.deepcopy(example)
    if "prompt" not in example:
        make_conversation(example)
    return _clean_none(example)


def _sample(processor, prompt_text: str, images, reward_kwargs: dict) -> dict[str, Any]:
    reward_kwargs["prompt_text_final"] = prompt_text
    proc = processor(prompt_text, images=images)
    return {
        "input_ids": proc.input_ids,
        "pixel_patches": proc.pixel_patches,
        "grid_thw": proc.grid_thw,
        # from the processor: a remapped tokenizer's id, not a constant
        "vision_token_id": getattr(processor, "image_token_id", 151655),
        "reward_kwargs": reward_kwargs,
    }


def _load_keyframes(example, data_root, size_wh) -> list[np.ndarray]:
    """Keyframe images resized to the video frame size (W, H), CHW uint8
    (grpo_trainer.py:503-513)."""
    root = keyframe_root(example, data_root)
    w, h = size_wh
    return [resize_image(read_image(os.path.join(root, kf["path"])), h, w)
            for kf in example["key_frames"]]


def rl_sample_from_frames(
    example: dict[str, Any],
    processor,
    frames: Sequence[np.ndarray],
    sample_fps: float,
    keyframes: Optional[Sequence[np.ndarray]] = None,
) -> dict[str, Any]:
    """One video example and its decoded frames (CHW, at the model's
    resolution) -> a ``GSPOTrainer`` sample. The temporal-spatial task
    interleaves ``keyframes`` (CHW, the frames' size; one per
    ``example["key_frames"]`` entry) by time (grpo_trainer.py:477-537)."""
    example = _prepared(example)
    prompt_text = processor.apply_chat_template(example["prompt"], add_generation_prompt=True)
    reward_kwargs = {k: v for k, v in example.items() if k != "prompt"}
    frames = list(frames)
    T = len(frames)
    _, H, W = np.shape(frames[0])
    reward_kwargs["video_sample_fps"] = sample_fps
    reward_kwargs["video_duration"] = T / sample_fps
    reward_kwargs["image_size"] = (W, H)
    if example.get("task") == "temporal-spatial free-form QA":
        kf_times = [kf["time"] for kf in example["key_frames"]]
        plan, frame_prompt = interleave_keyframes(
            T, sample_fps, kf_times, round_kf_display=True, append_total_line=True)
        images = [frames[i] if kind == "video" else keyframes[i] for kind, i in plan]
    else:
        frame_prompt = frame_prompt_rl(T, sample_fps)
        images = frames
    return _sample(processor, prompt_text.replace(VISION_PLACEHOLDER, frame_prompt), images,
                   reward_kwargs)


def prepare_rl_sample(
    example: dict[str, Any],
    processor,
    data_root: str,
    *,
    nframes: Optional[int] = None,
) -> dict[str, Any]:
    """One RL example -> a ``GSPOTrainer`` sample, its media read from
    ``data_root``: a video as per-frame images with a timestamped frame
    prompt (keyframes interleaved for the temporal-spatial task), or one
    image."""
    example = _prepared(example)
    media_kind, media_path = resolve_media(example, data_root)
    if media_kind == "image":
        img = fetch_image({"image": media_path})
        prompt_text = processor.apply_chat_template(example["prompt"], add_generation_prompt=True)
        reward_kwargs = {k: v for k, v in example.items() if k != "prompt"}
        reward_kwargs["image_size_refine"] = (img.shape[2], img.shape[1])
        return _sample(processor, prompt_text, [img], reward_kwargs)
    ele = {"video": media_path}
    if nframes is not None:
        ele["nframes"] = nframes
    video, sample_fps = fetch_video(ele)
    T, _, H, W = video.shape
    keyframes = None
    if example.get("task") == "temporal-spatial free-form QA":
        keyframes = _load_keyframes(example, data_root, (W, H))
    return rl_sample_from_frames(example, processor, [video[i] for i in range(T)], sample_fps,
                                 keyframes)
