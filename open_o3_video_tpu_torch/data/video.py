"""Video ingestion: decode, uniform frame sampling, smart resize (the reading
plan of ``open_o3_video_tpu/data/video.py``, a copy, since that module
imports PIL).

- ``smart_resize``: 28-factor aspect-preserving size under pixel budgets;
- ``smart_nframes``: fps- or nframes-driven frame count, rounded to
  FRAME_FACTOR and clamped;
- ``sample_indices``: ``linspace(0, total - 1, nframes).round()``;
- ``trim_window``: ``video_start``/``video_end`` as an inclusive pts range;
- ``fetch_video``: decode a file with the selected reader, then the
  PIL-parity bicubic resize of ``ops/resize.py`` instead of PIL;
- ``read_image`` / ``fetch_image``: an image file (a keyframe, a GQA image)
  read as PIL's ``convert("RGB")`` gives it, resized the same way (PIL's
  ``Image.resize`` default for RGB is bicubic).

Video readers, as the JAX package selects them: ``native``, the C++ libav
decoder of ``native/video_decoder.py`` (built at first use), when it is
available, else ``cv2`` (OpenCV, imported when called);
``FORCE_VIDEO_READER`` overrides the choice, which is printed once. A failed
native read is retried with cv2 when cv2 can be imported; otherwise its
error propagates as it is. Images are read with cv2 when it can be imported,
else with the native decoder at the image's own size (frame 0): exact for
PNG (RGB or gray; an RGBA PNG loses its alpha instead of being flattened
onto white), close to but not equal to PIL for JPEG (chroma upsampling).
With neither reader, reading raises an ImportError that says what is
missing.
"""

from __future__ import annotations

import functools
import logging
import math
import os
import sys

import numpy as np
import torch

from ..ops.resize import resize_frames

logger = logging.getLogger(__name__)

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


def _read_video_native(ele: dict) -> tuple[np.ndarray, float]:
    """C++ libav decoder: decodes only the sampled frames (TCHW uint8 RGB,
    sample fps)."""
    from ..native import video_decoder

    video_path = ele["video"]
    if video_path.startswith("file://"):
        video_path = video_path[7:]
    meta = video_decoder.probe(video_path)
    total_frames, video_fps = meta.num_frames, meta.fps
    start_idx, window = trim_window(ele, total_frames, video_fps)
    nframes = smart_nframes(ele, total_frames=window, video_fps=video_fps)
    idx = sample_indices(window, nframes) + start_idx
    video = video_decoder.decode_frames(video_path, idx)  # THWC uint8 RGB
    video = np.ascontiguousarray(video.transpose(0, 3, 1, 2))
    return video, nframes / max(window, 1e-6) * video_fps


VIDEO_READER_BACKENDS = {
    "native": _read_video_native,
    "cv2": _read_video_cv2,
}

FORCE_VIDEO_READER = os.getenv("FORCE_VIDEO_READER", None)


def _has_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


@functools.lru_cache(maxsize=1)
def get_video_reader_backend() -> str:
    """``FORCE_VIDEO_READER`` when set, else ``native`` when the libav
    decoder is available (a failed build raises), else ``cv2``; printed once
    (with what the native decoder lacks, when it is not used)."""
    from ..native import video_decoder

    if FORCE_VIDEO_READER is not None:
        if FORCE_VIDEO_READER not in VIDEO_READER_BACKENDS:
            raise RuntimeError(f"FORCE_VIDEO_READER={FORCE_VIDEO_READER!r}: expected one of "
                               f"{sorted(VIDEO_READER_BACKENDS)}")
        backend, why = FORCE_VIDEO_READER, " (FORCE_VIDEO_READER)"
    elif video_decoder.available():
        backend, why = "native", ""
    else:
        backend, why = "cv2", f" (native decoder unavailable: missing {video_decoder.missing()})"
    print(f"open_o3_video_tpu_torch using {backend} to read video{why}.", file=sys.stderr)
    return backend


def fetch_video(ele: dict, image_factor: int = IMAGE_FACTOR) -> tuple[np.ndarray, float]:
    """Decode, sample and resize one video file: (float32 TCHW frames at the
    model's resolution, sample fps). A native read that fails on the file
    (OSError, ValueError) is retried with cv2 when cv2 can be imported."""
    backend = get_video_reader_backend()
    try:
        video, sample_fps = VIDEO_READER_BACKENDS[backend](ele)
    except (OSError, ValueError) as e:
        if backend == "cv2" or not _has_cv2():
            raise
        logger.warning(f"video reader backend {backend} error, falling back to cv2, msg: {e}")
        video, sample_fps = VIDEO_READER_BACKENDS["cv2"](ele)
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


def _read_image_native(path: str) -> np.ndarray:
    """An image file through the libav decoder: frame 0 at the image's own
    size (``probe`` counts 0 frames for a PNG, so its count is not used)."""
    from ..native import video_decoder

    if not video_decoder.available():
        raise ImportError("reading an image file needs OpenCV (cv2) or the native libav decoder; "
                          f"cv2 is not installed and the decoder lacks {video_decoder.missing()}")
    meta = video_decoder.probe(path)
    return video_decoder.decode_frames_scaled(path, [0], meta.width, meta.height,
                                              bicubic=False)[0]


def read_image(path: str) -> np.ndarray:
    """An image file as HWC uint8 RGB, as PIL's ``to_rgb`` makes it: gray
    repeated over the channels, RGBA flattened onto white (PIL's paste
    blend, rounded as its ``BLEND`` macro rounds). Read with cv2, or without
    it with the native decoder (see the module docstring)."""
    if path.startswith("file://"):
        path = path[7:]
    try:
        import cv2
    except ImportError:
        return _read_image_native(path)
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"cv2 failed to read image: {path}")
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: only 8-bit images are read, got {img.dtype}")
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    if img.shape[2] == 4:
        rgb = img[:, :, 2::-1].astype(np.int32)
        alpha = img[:, :, 3:].astype(np.int32)
        tmp = 255 * (255 - alpha) + rgb * alpha + 128
        return ((tmp + (tmp >> 8)) >> 8).astype(np.uint8)
    return np.ascontiguousarray(img[:, :, ::-1])


def resize_image(img_hwc: np.ndarray, height: int, width: int) -> np.ndarray:
    """HWC uint8 -> CHW uint8 at (height, width), the PIL-parity bicubic."""
    chw = torch.from_numpy(np.ascontiguousarray(img_hwc.transpose(2, 0, 1)))[None]
    return resize_frames(chw, height, width)[0].to(torch.uint8).numpy()


def fetch_image(ele: dict, size_factor: int = IMAGE_FACTOR) -> np.ndarray:
    """Read and smart-resize one image file (``ele["image"]``, a path, and
    optional ``min_pixels``/``max_pixels``) as the JAX package's
    ``fetch_image`` does: CHW uint8 RGB."""
    img = read_image(ele["image"])
    h, w = smart_resize(img.shape[0], img.shape[1], factor=size_factor,
                        min_pixels=ele.get("min_pixels", MIN_PIXELS),
                        max_pixels=ele.get("max_pixels", MAX_PIXELS))
    return resize_image(img, h, w)
