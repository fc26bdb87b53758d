"""The one traffic generator: a mix file of ``portbench/traffic/`` (its
parameters) and a seed in, the calls of a run out.

A serving mix is a closed loop of batch calls, each of ``requests_per_call``
requests over fresh frames drawn from the seed (uint8, as a video decoder
hands them over), so that no call shares a video with another and the
prefix cache is only ever hit within a call. Every seed makes the same
sizes: the seed changes the pixels and nothing else. ``entry`` says how the
requests are laid out:

- ``vstar_item``: one V-STAR item a call, its five queries over one video
  (``frames`` frames of ``frame_hw``, HWC, at ``fps``) with the eval's
  prompt functions (``vstar_prompts``) and the item's texts from the mix.
- ``video_requests``: ``requests_per_call`` requests, each its own video of
  ``frames`` frames (TCHW) that the program resizes on the device to
  ``resize_hw``, laid out as Qwen3-VL's processor lays out a video: a
  timestamp and a vision block per frame, then the question, under the
  mix's system prompt; its token ids made here (a byte-level tokenizer).
"""

from __future__ import annotations

import numpy as np

from ..reference import inputs as ref_inputs
from . import vstar_prompts


def call_rng(seed: int, index: int) -> np.random.Generator:
    """The random stream of call ``index`` (-1: the warm-up call) of a run
    with ``seed``, independent of every other call's."""
    return np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, index + 1])


def make_call(mix: dict, arch, seed: int, index: int) -> dict:
    rng = call_rng(seed, index)
    n, (h, w) = mix["frames"], mix["frame_hw"]
    if mix["entry"] == "vstar_item":
        frames = rng.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)
        times = [i / mix["fps"] for i in range(n)]
        return {"entry": "vstar_item", "frames": [frames[i] for i in range(n)],
                "times": times, "item": mix["item"],
                "prompts": vstar_prompts.prompts(mix["item"]), "keys": vstar_prompts.KEYS}
    if mix["entry"] == "video_requests":
        reqs = []
        rh, rw = mix["resize_hw"]
        p = arch.vision.patch
        per_frame = (rh // p) * (rw // p) // arch.vision.unit
        for _ in range(mix["requests_per_call"]):
            frames = rng.integers(0, 256, size=(n, 3, h, w), dtype=np.uint8)
            blocks = "".join(f"<{i / mix['fps']:.1f} seconds><|vision_start|>"
                             + "<|video_pad|>" * per_frame + "<|vision_end|>" for i in range(n))
            text = ref_inputs.render_chat([
                {"role": "system", "content": [{"type": "text", "text": mix["system"]}]},
                {"role": "user", "content": [{"type": "text", "text": blocks},
                                             {"type": "text", "text": mix["question"]}]}])
            reqs.append({"frames": frames, "ids": ref_inputs.encode(text),
                         "grid": (n, rh // p, rw // p), "resize_hw": (rh, rw)})
        return {"entry": "video_requests", "requests": reqs}
    raise ValueError(f"unknown traffic entry {mix['entry']!r}")
