"""What the reference works out again from the raw inputs: prompt text,
token ids, resized frames and their patch rows.

Plain Python, NumPy and PyTorch, copied from the published processors'
rules and frozen here, so that the reference imports nothing of the
program: the Qwen chat markup, a byte-level tokenizer (UTF-8 bytes, special
tokens at their Qwen ids), Qwen's ``smart_resize``, Pillow's antialiased
bicubic resample (its coefficient windows on its 2^-22 grid, each pass
rounded to uint8), and the Qwen2-VL image processor's normalisation and
patch layout (2x2 merge blocks interleaved).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

IM_START, IM_END = "<|im_start|>", "<|im_end|>"
VISION_START, VISION_END = "<|vision_start|>", "<|vision_end|>"
IMAGE_PAD, VIDEO_PAD = "<|image_pad|>", "<|video_pad|>"
SPECIAL_IDS = {IM_START: 151644, IM_END: 151645, VISION_START: 151652, VISION_END: 151653,
               IMAGE_PAD: 151655, VIDEO_PAD: 151656, "<|endoftext|>": 151643}
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)
IMAGE_FACTOR, MIN_PIXELS, MAX_PIXELS, MAX_RATIO = 28, 4 * 28 * 28, 256 * 28 * 28, 200


def render_chat(messages: Sequence[dict], add_generation_prompt: bool = True) -> str:
    """Qwen's chat markup: an image element is a vision block of one image
    pad, a video element one of a video pad."""
    out = []
    for msg in messages:
        content = msg["content"]
        if isinstance(content, str):
            text = content
        else:
            parts = []
            for ele in content:
                if ele.get("type") == "image" or "image" in ele:
                    parts.append(VISION_START + IMAGE_PAD + VISION_END)
                elif ele.get("type") == "video" or "video" in ele:
                    parts.append(VISION_START + VIDEO_PAD + VISION_END)
                else:
                    parts.append(ele["text"])
            text = "".join(parts)
        out.append(f"{IM_START}{msg['role']}\n{text}{IM_END}\n")
    if add_generation_prompt:
        out.append(f"{IM_START}assistant\n")
    return "".join(out)


def encode(text: str) -> list[int]:
    """Byte-level ids: each special token as its id, every other character
    as its UTF-8 bytes."""
    ids: list[int] = []
    i = 0
    while i < len(text):
        for tok, tid in SPECIAL_IDS.items():
            if text.startswith(tok, i):
                ids.append(tid)
                i += len(tok)
                break
        else:
            ids.extend(text[i].encode("utf-8"))
            i += 1
    return ids


def expand_pads(text: str, pad: str, counts: Sequence[int]) -> str:
    """Each ``pad`` of ``text`` repeated as many times as its image has
    merged tokens, in order."""
    parts = text.split(pad)
    if len(parts) - 1 != len(counts):
        raise ValueError(f"{len(counts)} images but {len(parts) - 1} {pad} placeholders")
    return "".join(p + (pad * counts[i] if i < len(counts) else "") for i, p in enumerate(parts))


def smart_resize(height: int, width: int, factor: int = IMAGE_FACTOR,
                 min_pixels: int = MIN_PIXELS, max_pixels: int = MAX_PIXELS) -> tuple[int, int]:
    """Qwen's rule: both sides multiples of ``factor``, the area within
    [min_pixels, max_pixels], the aspect ratio about kept."""
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError("aspect ratio over 200")
    h = max(factor, round(height / factor) * factor)
    w = max(factor, round(width / factor) * factor)
    if h * w > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h = max(factor, math.floor(height / beta / factor) * factor)
        w = max(factor, math.floor(width / beta / factor) * factor)
    elif h * w < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h = math.ceil(height * beta / factor) * factor
        w = math.ceil(width * beta / factor) * factor
    return h, w


def _bicubic(x: np.ndarray) -> np.ndarray:
    a, x = -0.5, np.abs(x)
    inner = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    outer = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, inner, np.where(x < 2.0, outer, 0.0))


def resample_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float64 coefficients of Pillow's antialiased bicubic
    resample, quantized to its 2^-22 grid."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    out = np.zeros((out_size, in_size))
    for o in range(out_size):
        center = (o + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        w = _bicubic((np.arange(lo, hi) - center + 0.5) / fscale)
        if w.sum() != 0.0:
            w = w / w.sum()
        out[o, lo:hi] = w
    pb = 1 << 22
    return np.where(out < 0, np.ceil(out * pb - 0.5), np.floor(out * pb + 0.5)) / pb


def resize(frames: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(T, C, H, W) uint8 -> float64 uint8 values at (out_h, out_w): the
    horizontal pass, then the vertical one, each rounded half up and
    clamped to [0, 255]."""
    dev = frames.device
    ww = torch.from_numpy(resample_matrix(frames.shape[3], out_w)).to(dev)
    wh = torch.from_numpy(resample_matrix(frames.shape[2], out_h)).to(dev)
    x = frames.to(torch.float64)
    x = torch.clamp(torch.floor(torch.einsum("tchw,ow->tcho", x, ww) + 0.5), 0, 255)
    return torch.clamp(torch.floor(torch.einsum("tchw,oh->tcow", x, wh) + 0.5), 0, 255)


def patch_rows(frames: torch.Tensor, patch: int, temporal: int, merge: int) -> torch.Tensor:
    """(T, C, H, W) values in [0, 255] -> float32 patch rows
    (T * H/p * W/p, C * temporal * p * p), each frame repeated over the
    temporal patch axis (an image of grid_t 1), rows in 2x2 merge-block
    order."""
    x = frames.to(torch.float64) / 255.0
    mean = torch.from_numpy(CLIP_MEAN.astype(np.float64)).to(x.device)[:, None, None]
    std = torch.from_numpy(CLIP_STD.astype(np.float64)).to(x.device)[:, None, None]
    x = ((x - mean) / std).repeat_interleave(temporal, dim=0)
    T, C, H, W = x.shape
    gt, gh, gw = T // temporal, H // patch, W // patch
    x = x.reshape(gt, temporal, C, gh // merge, merge, patch, gw // merge, merge, patch)
    x = x.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(gt * gh * gw, C * temporal * patch * patch).to(torch.float32)
