"""ctypes bindings for the C++ libav video decoder (counterpart of
``open_o3_video_tpu/native/video_decoder.py``).

The shared library probes a container's metadata and decodes exactly the
requested frame indices to RGB24, skipping decode work for unsampled frames
where the codec allows.

The library is built at first use with ``g++ -O3 -fPIC -shared -std=c++17
src/video_decoder.cc -lavformat -lavcodec -lavutil -lswscale`` (the JAX
package's ``build.sh``) into ``_build/`` beside the package, in a directory
keyed by a hash of the source and the flags, under a file lock so that
concurrent processes build it once. Unlike the JAX bindings, nothing here
swallows a failure: ``available()`` answers False only when g++ or a libav
header or library is missing (``missing()`` names which), and a build that
was attempted and failed raises with g++'s stderr.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import re
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "src" / "video_decoder.cc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "libo3video.so"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
# library -> the header of it that the source includes
LIBAV = {
    "avformat": "libavformat/avformat.h",
    "avcodec": "libavcodec/avcodec.h",
    "avutil": "libavutil/imgutils.h",
    "swscale": "libswscale/swscale.h",
}
LINK_FLAGS = tuple(f"-l{name}" for name in LIBAV)


@dataclass
class VideoMeta:
    num_frames: int
    fps: float
    width: int
    height: int


def _include_dirs(cxx: str) -> list[str]:
    """The compiler's ``#include <...>`` search path."""
    out = subprocess.run([cxx, "-xc++", "-E", "-v", os.devnull], capture_output=True,
                         text=True).stderr
    block = re.search(r"#include <\.\.\.> search starts here:\n(.*?)End of search list",
                      out, re.S)
    return [line.strip() for line in block.group(1).splitlines()] if block else []


@functools.cache
def probe_libav() -> dict:
    """What the build needs, as found on this machine: {"g++": path or None,
    "headers": {header: path or None}, "libraries": {lib<name>.so: path or
    None}}. Headers are looked up on g++'s include path, libraries with
    ``g++ -print-file-name`` (the linker's search)."""
    cxx = shutil.which("g++")
    found: dict = {"g++": cxx, "headers": {}, "libraries": {}}
    dirs = _include_dirs(cxx) if cxx else []
    for name, header in LIBAV.items():
        hits = [os.path.join(d, header) for d in dirs if os.path.exists(os.path.join(d, header))]
        found["headers"][header] = hits[0] if hits else None
        lib = f"lib{name}.so"
        path = None
        if cxx:
            path = subprocess.run([cxx, f"-print-file-name={lib}"], capture_output=True,
                                  text=True).stdout.strip()
            path = os.path.realpath(path) if os.path.isabs(path) and os.path.exists(path) else None
        found["libraries"][lib] = path
    return found


def missing() -> list[str]:
    """What the build needs and this machine lacks (empty when it can build)."""
    found = probe_libav()
    out = [] if found["g++"] else ["g++"]
    out += [name for group in ("headers", "libraries")
            for name, path in found[group].items() if path is None]
    return out


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}"


def build() -> Path:
    """Compile the decoder into its keyed build directory (once; concurrent
    callers wait on a file lock) and return the library's path. Raises
    RuntimeError with g++'s stderr when the build fails."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():  # built while this process waited
            return lib
        tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
        cmd = [shutil.which("g++") or "g++", *CXX_FLAGS, str(SOURCE), *LINK_FLAGS, "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building the video decoder:\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, lib)  # atomic: a reader never loads a partial file
    return lib


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.o3v_probe.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),  # num_frames
        ctypes.POINTER(ctypes.c_double),  # fps
        ctypes.POINTER(ctypes.c_int),  # width
        ctypes.POINTER(ctypes.c_int),  # height
    ]
    lib.o3v_probe.restype = ctypes.c_int
    lib.o3v_decode_frames.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),  # indices
        ctypes.c_int64,  # n indices
        ctypes.POINTER(ctypes.c_uint8),  # out buffer (n, H, W, 3)
        ctypes.c_int,  # width
        ctypes.c_int,  # height
    ]
    lib.o3v_decode_frames.restype = ctypes.c_int
    lib.o3v_decode_frames_scaled.argtypes = lib.o3v_decode_frames.argtypes + [
        ctypes.c_int,  # interp: 0 = bilinear, 1 = bicubic
    ]
    lib.o3v_decode_frames_scaled.restype = ctypes.c_int
    return lib


def available() -> bool:
    """True when the decoder is built or builds now; False when g++ or libav
    is missing (see ``missing``). A failed build raises."""
    if missing():
        return False
    _load()
    return True


def probe(path: str) -> VideoMeta:
    lib = _load()
    n = ctypes.c_int64()
    fps = ctypes.c_double()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.o3v_probe(path.encode(), ctypes.byref(n), ctypes.byref(fps), ctypes.byref(w),
                       ctypes.byref(h))
    if rc != 0:
        raise IOError(f"o3v_probe failed ({rc}) for {path}")
    return VideoMeta(num_frames=n.value, fps=fps.value, width=w.value, height=h.value)


def decode_frames(path: str, indices: np.ndarray) -> np.ndarray:
    """Decode the given frame indices; returns (N, H, W, 3) uint8 RGB."""
    meta = probe(path)
    return decode_frames_scaled(path, indices, meta.width, meta.height, bicubic=False)


def decode_frames_scaled(path: str, indices: np.ndarray, width: int, height: int,
                         bicubic: bool = True) -> np.ndarray:
    """Decode and swscale-resize in one C++ pass; (N, height, width, 3)
    uint8. swscale's SWS_BICUBIC approximates the reference's PIL bicubic."""
    if width <= 0 or height <= 0:
        # A degenerate pixel budget can floor smart_resize to 0 on one axis;
        # swscale must never see a 0 dimension (it aborts the process).
        raise ValueError(f"invalid resize target {width}x{height} (pixel budget too small "
                         f"for this aspect ratio)")
    lib = _load()
    idx = np.ascontiguousarray(np.asarray(indices, dtype=np.int64))
    out = np.empty((len(idx), height, width, 3), dtype=np.uint8)
    rc = lib.o3v_decode_frames_scaled(
        path.encode(),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(idx),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        width,
        height,
        1 if bicubic else 0,
    )
    if rc != 0:
        raise IOError(f"o3v_decode_frames_scaled failed ({rc}) for {path}")
    return out
