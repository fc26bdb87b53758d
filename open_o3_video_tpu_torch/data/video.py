"""Video ingestion: decode, uniform frame sampling, smart resize (the reading
plan of ``open_o3_video_tpu/data/video.py``, a copy, since that module
imports PIL).

- ``smart_resize``: 28-factor aspect-preserving size under pixel budgets;
- ``smart_nframes``: fps- or nframes-driven frame count, rounded to
  FRAME_FACTOR and clamped;
- ``sample_indices``: ``linspace(0, total - 1, nframes).round()``;
- ``trim_window``: ``video_start``/``video_end`` as an inclusive pts range;
- ``fetch_video``: decode a file with OpenCV (imported when called), then
  the PIL-parity bicubic resize of ``ops/resize.py`` instead of PIL.

OpenCV is the only reader here (the JAX package's native libav decoder is
not ported). Where cv2 is missing, ``fetch_video`` raises an ImportError
that says so.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..ops.resize import resize_frames

# Constants (reference: vision_process.py:25-42)
IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 256 * 28 * 28
MAX_RATIO = 200

VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 128 * 28 * 28
FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 16

VIDEO_TOTAL_PIXELS = int(float(os.environ.get("VIDEO_MAX_PIXELS", 128000 * 28 * 28 * 0.9)))


def round_by_factor(number: float, factor: int) -> int:
    return round(number / factor) * factor


def ceil_by_factor(number: float, factor: int) -> int:
    return math.ceil(number / factor) * factor


def floor_by_factor(number: float, factor: int) -> int:
    return math.floor(number / factor) * factor


def smart_resize(height: int, width: int, factor: int = IMAGE_FACTOR,
                 min_pixels: int = MIN_PIXELS, max_pixels: int = MAX_PIXELS) -> tuple[int, int]:
    """Target (h, w), both multiples of ``factor``, with h * w in
    [min_pixels, max_pixels] and the aspect ratio about kept."""
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(f"absolute aspect ratio must be smaller than {MAX_RATIO}, "
                         f"got {max(height, width) / min(height, width)}")
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = floor_by_factor(height / beta, factor)
        w_bar = floor_by_factor(width / beta, factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def smart_nframes(ele: dict, total_frames: int, video_fps: float) -> int:
    """Number of frames to sample for the model."""
    if "fps" in ele and "nframes" in ele:
        raise ValueError("give either `fps` or `nframes`, not both")
    if "nframes" in ele:
        nframes = round_by_factor(ele["nframes"], FRAME_FACTOR)
    else:
        fps = ele.get("fps", FPS)
        min_frames = ceil_by_factor(ele.get("min_frames", FPS_MIN_FRAMES), FRAME_FACTOR)
        max_frames = floor_by_factor(ele.get("max_frames", min(FPS_MAX_FRAMES, total_frames)),
                                     FRAME_FACTOR)
        nframes = total_frames / video_fps * fps
        nframes = min(min(max(nframes, min_frames), max_frames), total_frames)
        nframes = floor_by_factor(nframes, FRAME_FACTOR)
    if not FRAME_FACTOR <= nframes <= total_frames:
        raise ValueError(f"nframes should in interval [{FRAME_FACTOR}, {total_frames}], "
                         f"but got {nframes}.")
    return nframes


def sample_indices(total_frames: int, nframes: int) -> np.ndarray:
    """Uniform sampling, ``torch.linspace(...).round()`` (half to even)."""
    return np.round(np.linspace(0, total_frames - 1, nframes)).astype(np.int64)


def trim_window(ele: dict, total_frames: int, video_fps: float) -> tuple[int, int]:
    """``video_start``/``video_end`` (seconds, an inclusive pts range) ->
    (first frame index, window length in frames)."""
    start = float(ele.get("video_start") or 0.0)
    end = ele.get("video_end", None)
    start_idx = max(0, int(math.ceil(start * video_fps - 1e-6)))
    if end is None:
        end_idx = total_frames - 1
    else:
        end_idx = min(total_frames - 1, int(math.floor(float(end) * video_fps + 1e-6)))
    if end_idx < start_idx:
        raise ValueError(f"empty video window [video_start={start}, video_end={end}] "
                         f"at fps={video_fps} ({total_frames} frames)")
    return start_idx, end_idx - start_idx + 1


def _read_video_cv2(ele: dict) -> tuple[np.ndarray, float]:
    """OpenCV decode of the sampled frames: (TCHW uint8 RGB, sample fps).
    Seeks per sampled index when the samples are sparse, else (or when a
    seek fails) decodes in order from the window's start."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reading a video file needs OpenCV (cv2), which is not installed") from e

    video_path = ele["video"]
    if video_path.startswith("file://"):
        video_path = video_path[7:]
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cv2 failed to open video: {video_path}")
    total_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    video_fps = cap.get(cv2.CAP_PROP_FPS) or 1.0
    start_idx, window = trim_window(ele, total_frames, video_fps)
    nframes = smart_nframes(ele, total_frames=window, video_fps=video_fps)
    idx = sample_indices(window, nframes) + start_idx

    frames = []
    if (start_idx + window) > 4 * nframes:  # sparse: seeking beats decoding everything
        for i in idx:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
    if len(frames) != nframes:
        frames = []
        cap.release()
        cap = cv2.VideoCapture(video_path)
        pos = 0
        if start_idx > 0:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(start_idx))
            if int(cap.get(cv2.CAP_PROP_POS_FRAMES)) == int(start_idx):
                pos = int(start_idx)
            else:  # unreliable seeking: decode from 0
                cap.release()
                cap = cv2.VideoCapture(video_path)
        counts = {int(i): int(np.sum(idx == i)) for i in idx}
        while len(frames) < nframes:
            if not cap.grab():
                break
            if pos in counts:
                ok, frame = cap.retrieve()
                if not ok:
                    break
                frames.extend([frame] * counts[pos])
            pos += 1
    cap.release()
    if len(frames) < nframes:
        if not frames:
            raise IOError(f"cv2 decoded no frames from {video_path}")
        frames.extend([frames[-1]] * (nframes - len(frames)))  # a truncated container
    video = np.ascontiguousarray(np.stack(frames)[..., ::-1].transpose(0, 3, 1, 2))  # BGR -> RGB TCHW
    return video, nframes / max(window, 1e-6) * video_fps


def fetch_video(ele: dict, image_factor: int = IMAGE_FACTOR) -> tuple[np.ndarray, float]:
    """Decode, sample and resize one video file: (float32 TCHW frames at the
    model's resolution, sample fps)."""
    video, sample_fps = _read_video_cv2(ele)
    nframes, _, height, width = video.shape
    min_pixels = ele.get("min_pixels", VIDEO_MIN_PIXELS)
    total_pixels = ele.get("total_pixels", VIDEO_TOTAL_PIXELS)
    max_pixels = max(min(VIDEO_MAX_PIXELS, total_pixels / nframes * FRAME_FACTOR),
                     int(min_pixels * 1.05))
    max_pixels = min(ele.get("max_pixels", max_pixels), max_pixels)
    if "resized_height" in ele and "resized_width" in ele:
        h, w = smart_resize(ele["resized_height"], ele["resized_width"], factor=image_factor)
    else:
        h, w = smart_resize(height, width, factor=image_factor, min_pixels=min_pixels,
                            max_pixels=max_pixels)
    return resize_frames(torch.from_numpy(video), h, w).numpy(), sample_fps
