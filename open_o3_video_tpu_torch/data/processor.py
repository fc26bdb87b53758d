"""Processor: chat template + vision token expansion + patchification
(counterpart of ``open_o3_video_tpu/data/processor.py``).

A copy rather than an import: ``open_o3_video_tpu.data`` imports its video
decoder, which needs PIL, and the card's machine has no PIL. Frames come in
as CHW or TCHW arrays (no PIL branch).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence

import numpy as np

from ..ops.preprocess import patchify

IM_START = "<|im_start|>"
IM_END = "<|im_end|>"
VISION_START = "<|vision_start|>"
VISION_END = "<|vision_end|>"
IMAGE_PAD = "<|image_pad|>"
VIDEO_PAD = "<|video_pad|>"

# Qwen2.5-VL special token ids (shared across the released checkpoints).
SPECIAL_IDS = {
    IM_START: 151644,
    IM_END: 151645,
    VISION_START: 151652,
    VISION_END: 151653,
    IMAGE_PAD: 151655,
    VIDEO_PAD: 151656,
    "<|endoftext|>": 151643,
}


def render_chat(messages: Sequence[dict], add_generation_prompt: bool = False) -> str:
    """Qwen chat markup (the template shipped with Qwen2.5-VL checkpoints)."""
    out = []
    for msg in messages:
        content = msg["content"]
        if isinstance(content, str):
            text = content
        else:
            parts = []
            for ele in content:
                etype = ele.get("type")
                if etype == "image" or "image" in ele:
                    parts.append(f"{VISION_START}{IMAGE_PAD}{VISION_END}")
                elif etype == "video" or "video" in ele:
                    parts.append(f"{VISION_START}{VIDEO_PAD}{VISION_END}")
                elif etype == "text" or "text" in ele:
                    parts.append(ele["text"])
            text = "".join(parts)
        out.append(f"{IM_START}{msg['role']}\n{text}{IM_END}\n")
    if add_generation_prompt:
        out.append(f"{IM_START}assistant\n")
    return "".join(out)


class ByteTokenizer:
    """Deterministic tokenizer-free fallback: UTF-8 bytes + special tokens.

    Vocabulary: 0-255 raw bytes, then specials at their Qwen ids.
    """

    vocab_size = 152064

    def __init__(self, specials: Optional[dict] = None):
        self._specials = dict(specials if specials is not None else SPECIAL_IDS)
        self._id_to_special = {v: k for k, v in self._specials.items()}
        self.eos_token_id = self._specials[IM_END]
        self.pad_token_id = self._specials["<|endoftext|>"]

    @classmethod
    def for_config(cls, cfg) -> "ByteTokenizer":
        """Specials remapped to a model config's ids (tiny-vocab tests)."""
        return cls(specials={
            IM_START: cfg.eos_token_id - 1 if cfg.eos_token_id >= 1 else 98,
            IM_END: cfg.eos_token_id,
            VISION_START: cfg.vision_start_token_id,
            VISION_END: cfg.vision_end_token_id,
            IMAGE_PAD: cfg.image_token_id,
            VIDEO_PAD: cfg.video_token_id,
            "<|endoftext|>": cfg.pad_token_id,
        })

    def encode(self, text: str, **_kw) -> list[int]:
        ids: list[int] = []
        i = 0
        while i < len(text):
            matched = False
            if text[i] == "<":
                for tok, tid in self._specials.items():
                    if text.startswith(tok, i):
                        ids.append(tid)
                        i += len(tok)
                        matched = True
                        break
            if not matched:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out: list[str] = []
        byte_buf: list[int] = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for tid in ids:
            tid = int(tid)
            if tid in self._id_to_special:
                flush()
                if not skip_special_tokens:
                    out.append(self._id_to_special[tid])
            elif tid < 256:
                byte_buf.append(tid)
            else:
                flush()
        flush()
        return "".join(out)


@dataclasses.dataclass
class ProcessedInputs:
    input_ids: list[int]
    pixel_patches: Optional[np.ndarray]  # (S, patch_dim)
    grid_thw: Optional[np.ndarray]  # (num_images, 3)


class O3VideoProcessor:
    """text (+ images as CHW / TCHW arrays) -> model inputs."""

    def __init__(self, tokenizer=None, patch_size: int = 14,
                 temporal_patch_size: int = 2, merge_size: int = 2):
        self.tokenizer = tokenizer or ByteTokenizer()
        self.patch_size = patch_size
        self.image_token_id = self._special_id(IMAGE_PAD, 151655)
        self.video_token_id = self._special_id(VIDEO_PAD, 151656)
        self.temporal_patch_size = temporal_patch_size
        self.merge_size = merge_size

    def _special_id(self, token: str, default: int) -> int:
        tk = self.tokenizer
        if hasattr(tk, "_specials"):  # ByteTokenizer (possibly remapped)
            return tk._specials.get(token, default)
        if hasattr(tk, "convert_tokens_to_ids"):  # HF tokenizer
            tid = tk.convert_tokens_to_ids(token)
            if tid is not None and tid >= 0:
                return tid
        return default

    @classmethod
    def from_pretrained(cls, model_dir: str, **kw):
        """The checkpoint's HF tokenizer, or the ByteTokenizer when the
        directory has no tokenizer files."""
        has_tokenizer = any(
            os.path.exists(os.path.join(model_dir, f))
            for f in ("tokenizer.json", "tokenizer_config.json", "vocab.json",
                      "tokenizer.model")
        )
        if has_tokenizer:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(model_dir)
            tok.padding_side = "left"
        else:
            print(f"[warn] no tokenizer files in {model_dir}; using ByteTokenizer")
            tok = ByteTokenizer()
        return cls(tokenizer=tok, **kw)

    def apply_chat_template(self, messages, add_generation_prompt: bool = True) -> str:
        tok = self.tokenizer
        if hasattr(tok, "apply_chat_template") and getattr(tok, "chat_template", None):
            return tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=add_generation_prompt
            )
        return render_chat(messages, add_generation_prompt=add_generation_prompt)

    def process_images(self, images: Sequence[Any]) -> ProcessedInputs:
        """Patchify images only (no text)."""
        patches_list, grids = [], []
        for img in images:
            tchw = np.asarray(img)
            if tchw.ndim == 3:
                tchw = tchw[None]
            p, g = patchify(
                tchw,
                patch_size=self.patch_size,
                temporal_patch_size=self.temporal_patch_size,
                merge_size=self.merge_size,
            )
            patches_list.append(p)
            grids.append(g)
        return ProcessedInputs(
            input_ids=[],
            pixel_patches=np.concatenate(patches_list, axis=0),
            grid_thw=np.asarray(grids, dtype=np.int64),
        )

    def __call__(self, text: str, images: Optional[Sequence[Any]] = None,
                 precomputed_vision: Optional[ProcessedInputs] = None) -> ProcessedInputs:
        """Expand each <|image_pad|> to t*h*w / merge_size^2 tokens of its
        image (single frames CHW / 1xCHW, or frame stacks TCHW) and tokenize.
        ``precomputed_vision`` (from :meth:`process_images`) skips the
        patchify and is reused as it is: the result holds the very same
        ``pixel_patches`` object, so the engine, which encodes one tower pass
        per distinct patch object, encodes requests over the same frames
        once."""
        vision = precomputed_vision
        if vision is None and images:
            vision = self.process_images(images)

        if vision is not None:
            merge_unit = self.merge_size**2
            grids = np.asarray(vision.grid_thw)
            counts = [int(np.prod(g)) // merge_unit for g in grids]
            n_placeholders = text.count(IMAGE_PAD)
            if n_placeholders != len(counts):
                raise ValueError(
                    f"{len(counts)} images but {n_placeholders} {IMAGE_PAD} placeholders"
                )
            expanded = []
            for segment_idx, segment in enumerate(text.split(IMAGE_PAD)):
                expanded.append(segment)
                if segment_idx < len(counts):
                    expanded.append(IMAGE_PAD * counts[segment_idx])
            text = "".join(expanded)

        input_ids = self.tokenizer.encode(text, add_special_tokens=False) if hasattr(
            self.tokenizer, "encode"
        ) else self.tokenizer(text)["input_ids"]
        if vision is not None:
            return ProcessedInputs(
                input_ids=list(input_ids),
                pixel_patches=vision.pixel_patches,
                grid_thw=vision.grid_thw,
            )
        return ProcessedInputs(input_ids=list(input_ids), pixel_patches=None, grid_thw=None)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self.tokenizer.decode(ids, skip_special_tokens=skip_special_tokens)
