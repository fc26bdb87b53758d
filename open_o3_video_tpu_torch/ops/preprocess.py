"""Frames -> patch rows (rescale, normalize, patchify) in numpy (counterpart
of ``open_o3_video_tpu/ops/preprocess.py``).

A copy, not an import: ``chip_smoke.py`` drives the port's serving path and
must import nothing of the JAX package, so neither may the port.
``tests/test_torch_host.py`` and ``tests/test_torch_frames.py`` hold its
patch rows equal to the JAX package's.

Frames are rescaled by 1/255, normalized with the OpenAI-CLIP statistics,
padded to a temporal_patch_size multiple, and flattened into
(grid_t * grid_h * grid_w, C * tps * psz^2) rows whose order interleaves 2x2
merge blocks, as the HF Qwen2-VL image processor lays them out.
``patchify_device`` does the same on the frames' device (the engine's uint8
frame path: the host uploads raw frames, an eighth of the bytes of their
float32 patches, which repeat each frame twice); its rows equal the host
path's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

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


def patchify_device(frames_tchw: torch.Tensor, patch_size: int = 14,
                    temporal_patch_size: int = 2, merge_size: int = 2,
                    out_dtype=None, mean=None, std=None) -> torch.Tensor:
    """:func:`patchify` on the tensor's device: uint8 or float (T, C, H, W),
    T already a multiple of ``temporal_patch_size``, to patch rows in
    float32, cast to ``out_dtype`` at the end. The normalize is the host
    path's, one op at a time (divide by 255, subtract the mean, divide by
    the std), each a correctly rounded float32 op. Every constant is a
    tensor on the frames' device: PyTorch divides a CUDA tensor by a Python
    scalar as a product with its reciprocal, which can differ from the
    quotient by an ulp. ``mean`` and ``std`` (per channel) default to the
    CLIP values of the Qwen processors."""
    dev = frames_tchw.device
    x = frames_tchw.to(torch.float32) / torch.full((), 255.0, device=dev)
    mean = torch.from_numpy(np.asarray(OPENAI_CLIP_MEAN if mean is None else mean,
                                       dtype=np.float32)).to(dev)[:, None, None]
    std = torch.from_numpy(np.asarray(OPENAI_CLIP_STD if std is None else std,
                                      dtype=np.float32)).to(dev)[:, None, None]
    x = (x - mean) / std
    T, C, H, W = x.shape
    grid_t = T // temporal_patch_size
    grid_h, grid_w = H // patch_size, W // patch_size
    x = x.reshape(
        grid_t, temporal_patch_size, C,
        grid_h // merge_size, merge_size, patch_size,
        grid_w // merge_size, merge_size, patch_size,
    )
    x = x.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    out = x.reshape(grid_t * grid_h * grid_w, C * temporal_patch_size * patch_size**2)
    return out.to(out_dtype) if out_dtype is not None else out


def frames_as_images_patches(frames_tchw: np.ndarray, patch_size: int = 14,
                             temporal_patch_size: int = 2, merge_size: int = 2):
    """A video fed as per-frame images, the training and eval hot path: each
    frame an image of grid_t 1 (repeated across the temporal patch axis).
    Returns (patches stacked (S, patch_dim), grid_thw (num_frames, 3))."""
    all_patches = []
    grids = []
    for t in range(frames_tchw.shape[0]):
        p, g = patchify(frames_tchw[t:t + 1], patch_size, temporal_patch_size, merge_size)
        all_patches.append(p)
        grids.append(g)
    return np.concatenate(all_patches, axis=0), np.asarray(grids, dtype=np.int64)
