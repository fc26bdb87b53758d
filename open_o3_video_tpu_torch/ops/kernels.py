"""Build, load and launch-count the hand-written CUDA kernels in ``csrc/``.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, then linked into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The library lives under ``_build/``
beside the package, in a directory keyed by a hash of the sources and flags,
so an edited source rebuilds and an unchanged one is reused.

``LAUNCHES`` counts, per kernel entry point (the inference and the exact
training modes of K1-K3 under their own names, K5 and K6 per kernel, K7's
decode and prefill routes, its two K7a probes, the latent attention's
decode and prefill, and RMSNorm), the launches made by its
wrapper; callers reset it with :func:`reset_launches`
to show which kernels a run went through.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "_build"
LIB_NAME = "libo3v_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "o3v_fused_window_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "o3v_window_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "o3v_flash_attention_gqa": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL, _LL, _LL, _P,
    ),
    "o3v_fused_window_attention_exact": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "o3v_window_attention_exact": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "o3v_flash_attention_gqa_exact": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL, _LL, _LL, _P,
    ),
    "o3v_flash_attention_gqa_bwd_dq": (_P,) * 9 + (_I,) * 6 + (_P,),
    "o3v_flash_attention_gqa_bwd_dkv": (_P,) * 11 + (_I,) * 6 + (_P,),
    "o3v_fused_window_attention_bwd": (_P,) * 6 + (_I,) * 4 + (_F, _P),
    "o3v_window_attention_bwd_dq": (_P,) * 8 + (_I,) * 4 + (_F, _P),
    "o3v_window_attention_bwd_dkv": (_P,) * 9 + (_I,) * 4 + (_F, _P),
    "o3v_decode_attention_gqa": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
        _LL, _LL, _LL, _LL, _P,
    ),
    "o3v_int4_matmul": (_P,) * 6 + (_I,) * 6 + (_P,),
    "o3v_int4_matmul_wgmma": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "o3v_int4_matmul_stream": (_P,) * 5 + (_I,) * 4 + (_P,),
    "o3v_int4_matmul_convert": (_P,) * 5 + (_I,) * 4 + (_P,),
    "o3v_mla_decode": (_P, _P, _P, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "o3v_mla_prefill": (_P,) * 8 + (_I,) * 4 + (_LL,) * 14 + (_F, _P),
    "o3v_rms_norm": (_P, _P, _P, _LL, _I, _LL, _I, _F, _I, _I, _I, _P),
}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.cu")) + sorted(SOURCE_DIR.glob("*.cuh"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into the keyed build directory (if not there yet)
    and return the library's path. Each source compiles in its own ``nvcc``,
    all at once; the objects are then linked. The compilers' output,
    including the per-kernel register and spill report, is kept in
    ``build.log``."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs, jobs = [], []
    for src in sorted(SOURCE_DIR.glob("*.cu")):
        objs.append(str(out_dir / f"{src.stem}.{tag}.o"))
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True)))
    log, failed = [], []
    for cmd, proc in jobs:
        stdout, stderr = proc.communicate()
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {cmd[-1]}:\n{stderr[-4000:]}")
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    if not failed:
        cmd = [_nvcc(), "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, lib)  # atomic: a concurrent builder never loads a partial file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def use_kernel(x: torch.Tensor, impl: str) -> bool:
    """``impl="auto"``: the kernel for a CUDA tensor, the plain version for a
    CPU tensor. ``impl="torch"``: the plain version wherever ``x`` lies."""
    if impl == "torch":
        return False
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'torch', got {impl!r}")
    return x.is_cuda


@functools.cache
def sm_count(device_index: int) -> int:
    """The card's streaming multiprocessors (the kernels' launch plans)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check_tensor(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of this dtype and shape.
    Floating-point operands must be 16-byte aligned (the kernels load them 16
    bytes per thread); ids, positions and flags are read one at a time."""
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if x.data_ptr() % (16 if x.is_floating_point() else x.element_size()):
        raise ValueError(f"{name}: data pointer is misaligned")


def check_kv(name: str, x: torch.Tensor, shape: tuple, dtypes: tuple) -> None:
    """k/v of the decoder kernels: a CUDA (B, T, Hkv, D) tensor of one of
    ``dtypes`` with each token's (Hkv, D) block contiguous; batch and token
    strides are free (a layer view of the stacked cache) but must keep every
    token row on a 16-byte boundary, since rows are loaded 16 bytes per
    thread."""
    if not x.is_cuda or x.dtype not in dtypes or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected CUDA {'/'.join(map(str, dtypes))} {tuple(shape)}, "
                         f"got {x.device} {x.dtype} {tuple(x.shape)}")
    D, Hkv, item = shape[3], shape[2], x.element_size()
    if x.stride(3) != 1 or x.stride(2) != D or (x.stride(1) * item) % 16 or (x.stride(0) * item) % 16:
        raise ValueError(f"{name}: unsupported strides {x.stride()}")
    if x.data_ptr() % 16 or x.stride(1) < Hkv * D:
        raise ValueError(f"{name}: misaligned or overlapping token rows")


# The head_dims the kernels are built for: 80 for the vision tower's K1 and
# K6's fused backward (Qwen2.5-VL's windowed blocks), 80 and 72 for K2 (both
# modes) and K6's whole-frame dq and dk/dv (Qwen3-VL's 1152 / 16 heads), 128
# for the decoder's K3 and K4.
VISION_HEAD_DIM = 80
WINDOW_HEAD_DIMS = (72, 80)
TEXT_HEAD_DIM = 128


def check_head_dim(name: str, d: int, built) -> None:
    """Raise ValueError unless ``d`` is ``built`` (an int) or one of them (a
    tuple). At 72, Qwen3-VL's head_dim, the message says that only the
    windowed blocks' kernels lack it: Qwen3-VL's tower has none."""
    dims = built if isinstance(built, tuple) else (built,)
    if d not in dims:
        why = (" (K1 and K6's fused backward serve windowed blocks, which no tower of "
               "head_dim 72 has)" if d == 72 else "")
        raise ValueError(f"{name}: head_dim {d} not built; this kernel is built for "
                         f"{'/'.join(map(str, dims))}{why}")


def launch(name: str, *args) -> None:
    """Call C entry point ``o3v_<name>`` on the current stream and count it.

    The entry point returns ``cudaGetLastError()`` after its launch; a launch
    the GPU refused (too many threads, too much shared memory) raises here
    instead of passing silently."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(library(), f"o3v_{name}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
    LAUNCHES[name] += 1
