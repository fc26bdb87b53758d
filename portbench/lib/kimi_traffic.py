"""The traffic of a Kimi-VL session (``entry`` "video_session"): per call
one fresh video of ``frames`` frames (uint8 TCHW, ``frame_hw``, at ``fps``)
that the program resizes on the card to ``resize_hw``, and
``requests_per_call`` grounded questions about it (``questions``), each a
prompt of its own in Kimi-VL's chat layout: the mix's system prompt, then
per frame its timestamp and an image block (media start, "image", media
content, one placeholder a merged patch, media end), then the question.
Every prompt of a call shares the video prefix; the token ids come from a
byte-level encoder (UTF-8 bytes, the special tokens at the ids the
configuration's ``special_token_ids`` give). Every seed makes the same
sizes: the seed changes the pixels and nothing else."""

from __future__ import annotations

import numpy as np

from .traffic import call_rng


def render(system: str, blocks: list, question: str, sp: dict) -> list:
    """Token ids of one prompt: ``blocks`` a list of (text, placeholder
    count) pairs, one per frame."""
    def text(s):
        return list(s.encode("utf-8"))

    ids = [sp["im_system"]] + text("system") + [sp["im_middle"]] + text(system) + [sp["im_end"]]
    ids += [sp["im_user"]] + text("user") + [sp["im_middle"]]
    for stamp, n in blocks:
        ids += text(stamp) + [sp["media_start"]] + text("image") + [sp["media_content"]]
        ids += [sp["media_pad"]] * n + [sp["media_end"]]
    ids += text(question) + [sp["im_end"]]
    return ids + [sp["im_assistant"]] + text("assistant") + [sp["im_middle"]]


def make_call(mix: dict, arch, seed: int, index: int) -> dict:
    if mix["entry"] != "video_session":
        raise ValueError(f"unknown traffic entry {mix['entry']!r}")
    rng = call_rng(seed, index)
    n, (h, w) = mix["frames"], mix["frame_hw"]
    rh, rw = mix["resize_hw"]
    p = arch.vision.patch
    per_frame = (rh // p) * (rw // p) // arch.vision.unit
    frames = rng.integers(0, 256, size=(n, 3, h, w), dtype=np.uint8)
    blocks = [(f"<{i / mix['fps']:.1f} seconds>", per_frame) for i in range(n)]
    qs = mix["questions"][:mix["requests_per_call"]]
    reqs = [{"ids": render(mix["system"], blocks, q, arch.special)} for q in qs]
    return {"entry": "video_session", "frames": frames, "requests": reqs,
            "grid": (n, rh // p, rw // p), "resize_hw": (rh, rw)}
