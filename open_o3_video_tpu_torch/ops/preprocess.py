"""Frames -> patch rows (rescale, normalize, patchify) in numpy (counterpart
of ``open_o3_video_tpu/ops/preprocess.py``).

A copy, not an import: ``chip_smoke.py`` drives the port's serving path and
must import nothing of the JAX package, so neither may the port. The copy
keeps only the host path; ``tests/test_torch_host.py`` holds its patch rows
equal to the JAX package's.

Frames are rescaled by 1/255, normalized with the OpenAI-CLIP statistics,
padded to a temporal_patch_size multiple, and flattened into
(grid_t * grid_h * grid_w, C * tps * psz^2) rows whose order interleaves 2x2
merge blocks, as the HF Qwen2-VL image processor lays them out.
"""

from __future__ import annotations

import numpy as np

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def normalize_frames(frames_tchw: np.ndarray) -> np.ndarray:
    """uint8/float [0,255] TCHW -> normalized float32 TCHW."""
    x = frames_tchw.astype(np.float32) / 255.0
    return (x - OPENAI_CLIP_MEAN[:, None, None]) / OPENAI_CLIP_STD[:, None, None]


def patchify(frames_tchw: np.ndarray, patch_size: int = 14, temporal_patch_size: int = 2,
             merge_size: int = 2) -> tuple[np.ndarray, tuple[int, int, int]]:
    """(patches (grid_t*grid_h*grid_w, C*tps*psz^2) float32, (grid_t, grid_h,
    grid_w)). A single image is passed as T=1 and padded by repetition."""
    x = normalize_frames(frames_tchw)
    T, C, H, W = x.shape
    if T % temporal_patch_size != 0:
        reps = temporal_patch_size - (T % temporal_patch_size)
        x = np.concatenate([x, np.repeat(x[-1:], reps, axis=0)], axis=0)
        T = x.shape[0]
    grid_t = T // temporal_patch_size
    grid_h, grid_w = H // patch_size, W // patch_size
    x = x.reshape(
        grid_t, temporal_patch_size, C,
        grid_h // merge_size, merge_size, patch_size,
        grid_w // merge_size, merge_size, patch_size,
    )
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    patches = x.reshape(grid_t * grid_h * grid_w, C * temporal_patch_size * patch_size**2)
    return np.ascontiguousarray(patches, dtype=np.float32), (grid_t, grid_h, grid_w)
