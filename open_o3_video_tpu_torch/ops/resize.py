"""PIL-parity bicubic resize as two separable matmuls (counterpart of
``open_o3_video_tpu/ops/resize.py``; XLA there, plain torch here).

The reference resizes every frame with PIL's antialiased bicubic. PIL's
resample is a separable convolution with a precomputed coefficient window
per output pixel, so the whole resize is

    out = round8(Wh @ round8(x @ Ww^T))

with ``pil_resize_weights`` reproducing Pillow's ``precompute_coeffs``
(quantized to its 2^-22 fixed-point grid) and ``round8`` its per-pass
uint8 rounding (round half up, clamp to [0, 255]). The result is within one
LSB of PIL's on real frames. This replaces PIL, which the card's machine
does not have. ``resize_frames_device`` is the engine's on-device resize of
``Request.resize_hw`` (frames uploaded at their decoded size);
``resize_frames_host`` is its numpy twin.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

BICUBIC_A = -0.5  # PIL/Catmull-Rom-family coefficient (Pillow Resample.c)
BICUBIC_SUPPORT = 2.0


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    a = BICUBIC_A
    inner = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    outer = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, inner, np.where(x < 2.0, outer, 0.0))


@functools.lru_cache(maxsize=256)
def pil_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 row-stochastic resample matrix: Pillow's
    ``precompute_coeffs`` (support scaled by the downscale ratio, windows
    bounded as ``(int)(center +- support + 0.5)``, each normalized over its
    in-bounds taps), quantized to the 2^-22 grid as ``normalize_coeffs_8bpc``
    does, which keeps rounding ties on PIL's side."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = BICUBIC_SUPPORT * filterscale
    out = np.zeros((out_size, in_size), dtype=np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        taps = np.arange(xmin, xmax, dtype=np.float64)
        w = _bicubic_filter((taps - center + 0.5) / filterscale)
        s = w.sum()
        if s != 0.0:
            w = w / s
        out[xx, xmin:xmax] = w
    pb = 1 << 22  # PIL PRECISION_BITS fixed-point grid (round half away)
    out = np.where(out < 0, np.ceil(out * pb - 0.5), np.floor(out * pb + 0.5)) / pb
    return out.astype(np.float32)


def _round8(x: torch.Tensor) -> torch.Tensor:
    """PIL clip8: round half up to the uint8 grid, clamped (stays float32)."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 matmuls in full float32 inside, whatever the caller set:
    under TF32 the coefficients would lose their 2^-22 grid, and with it the
    PIL-parity rounding."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def resize_frames_device(frames: torch.Tensor, wh: torch.Tensor, ww: torch.Tensor,
                         quantize: bool = True) -> torch.Tensor:
    """(T, C, H, W) uint8 or float -> (T, C, H', W') float32 in [0, 255] on
    the tensor's device. ``wh``/``ww`` are the :func:`pil_resize_weights`
    matrices of the H and W axes, as float32 tensors on that device (the
    caller may cache them per shape). The horizontal pass, then the
    vertical one (PIL's order), each rounded to uint8 values when
    ``quantize`` (the PIL-parity mode; off for resampling data that is
    already continuous)."""
    x = frames.to(torch.float32)
    with _full_f32_matmul():
        x = torch.einsum("tchw,ow->tcho", x, ww)
        if quantize:
            x = _round8(x)
        x = torch.einsum("tchw,oh->tcow", x, wh)
    return _round8(x) if quantize else x


def resize_frames(frames: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(T, C, H, W) uint8 or float -> (T, C, out_h, out_w) float32 in
    [0, 255]: :func:`resize_frames_device` with the weights of these
    sizes."""
    dev = frames.device
    ww = torch.from_numpy(pil_resize_weights(frames.shape[3], out_w)).to(dev)
    wh = torch.from_numpy(pil_resize_weights(frames.shape[2], out_h)).to(dev)
    return resize_frames_device(frames, wh, ww)


def resize_frames_host(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """The numpy twin of :func:`resize_frames_device` (PIL-parity mode)."""
    wh = pil_resize_weights(frames.shape[2], out_h)
    ww = pil_resize_weights(frames.shape[3], out_w)
    x = frames.astype(np.float32)
    x = np.clip(np.floor(np.einsum("tchw,ow->tcho", x, ww) + 0.5), 0, 255)
    x = np.clip(np.floor(np.einsum("tchw,oh->tcow", x, wh) + 0.5), 0, 255)
    return x
