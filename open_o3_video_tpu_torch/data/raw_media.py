"""Lossless media files written with numpy and the standard library only,
for machines without an encoder (no OpenCV, no PIL): an uncompressed AVI
(BGR24 DIB frames, top-down, with an ``idx1`` index) and a PNG (8-bit RGB,
gray or RGBA, filter 0 on every row). Both decode to exactly the pixels
written, so a reader can be held to them bit for bit.

The AVI's rows are top-down (biHeight < 0): with bottom-up rows the FFmpeg
that OpenCV 5.0.0 bundles (avcodec 62.28) reads the right pixels but corrupts its
heap, and the process aborts when it frees it.
"""

from __future__ import annotations

import struct
import zlib
from fractions import Fraction

import numpy as np

AVIF_HASINDEX = 0x10
AVIIF_KEYFRAME = 0x10


def _chunk(fourcc: bytes, data: bytes) -> bytes:
    pad = b"\0" if len(data) % 2 else b""
    return fourcc + struct.pack("<I", len(data)) + data + pad


def _list(kind: bytes, body: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", len(body) + 4) + kind + body


def write_raw_avi(path: str, frames: np.ndarray, fps: float) -> None:
    """(T, H, W, 3) uint8 RGB frames -> an AVI of uncompressed BGR24 frames
    (BI_RGB, biHeight < 0: rows top-down, each padded to 4 bytes) at
    ``fps``."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[3] != 3:
        raise ValueError(f"expected (T, H, W, 3) uint8 frames, got {frames.shape} {frames.dtype}")
    n, h, w, _ = frames.shape
    stride = (w * 3 + 3) // 4 * 4
    size = stride * h
    rate = Fraction(fps).limit_denominator(1_000_000)
    avih = struct.pack("<10I4I", round(1e6 / fps), size * int(np.ceil(fps)), 0, AVIF_HASINDEX,
                       n, 0, 1, size, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIII4h", b"vids", b"DIB ", 0, 0, 0, 0, rate.denominator,
                       rate.numerator, 0, n, size, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, size, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih)
                 + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    chunks, index, offset = [], [], 4  # idx1 offsets count from the 'movi' fourcc
    for frame in frames:
        rows = np.zeros((h, stride), np.uint8)
        rows[:, :w * 3] = frame[:, :, ::-1].reshape(h, w * 3)  # BGR
        chunks.append(_chunk(b"00db", rows.tobytes()))
        index.append(struct.pack("<4sIII", b"00db", AVIIF_KEYFRAME, offset, size))
        offset += len(chunks[-1])
    body = hdrl + _list(b"movi", b"".join(chunks)) + _chunk(b"idx1", b"".join(index))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body) + 4) + b"AVI " + body)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 -> an 8-bit PNG."""
    img = np.asarray(img)
    channels = 1 if img.ndim == 2 else img.shape[2] if img.ndim == 3 else 0
    color = {1: 0, 3: 2, 4: 6}.get(channels)  # PNG color types: gray, RGB, RGBA
    if img.dtype != np.uint8 or color is None:
        raise ValueError(f"expected (H, W[, 3|4]) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    raw = b"".join(b"\0" + row.tobytes() for row in img.reshape(h, -1))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))
