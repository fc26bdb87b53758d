"""Shared setup for the PyTorch port's parity tests (tests/test_torch_*.py).

Every test feeds the same numpy inputs, drawn from ``np.random.default_rng``,
to the JAX package and to the port. JAX is imported inside the functions
that need it, so the port's CUDA tests in the same files can be collected on
a machine without JAX (``pytest --noconftest -m cuda``).
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np
import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

# Tolerances. f32 on the CPU: the two packages sum in different orders
# (~1e-7 relative per op); 1e-5 covers the attention ops, 1e-4 whole models.
ATOL_OP = 1e-5
ATOL_MODEL = 1e-4
# bf16 on the card, kernel vs plain version: outputs of unit scale round to
# bf16 (2^-7 at |x| < 2), and the kernel's summation order can flip the bf16
# rounding of an individual probability; 1e-2 covers one output ulp.
ATOL_BF16 = 1e-2
# The same at any output scale (attention over t random keys gives outputs
# ~sqrt(e/t), 0.006 at t = 81888, where ATOL_BF16 would pass a zero output):
# max abs error at most KERNEL_REL_MAX * min(1, max|ref|), relative L2 error
# at most KERNEL_REL_L2. chip_smoke.py holds the kernels to the same bounds.
KERNEL_REL_MAX = 2e-2
KERNEL_REL_L2 = 1e-2


def assert_kernel_close(out: torch.Tensor, ref: torch.Tensor) -> None:
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    bound = KERNEL_REL_MAX * min(1.0, ref.abs().max().item())
    rel = ((out - ref).norm() / ref.norm()).item()
    assert err <= bound and rel <= KERNEL_REL_L2, (
        f"max abs error {err} (bound {bound}), relative L2 error {rel} (bound {KERNEL_REL_L2})")


def cuda_device() -> torch.device:
    """The card for a test marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def normal(r: np.random.Generator, *shape, scale: float = 1.0) -> np.ndarray:
    return (scale * r.standard_normal(shape)).astype(np.float32)


def packed_ids(r: np.random.Generator, n: int, w: int, max_windows: int = 3) -> np.ndarray:
    """(n, w) int32 segment ids as the packed ViT layout makes them: each
    row holds 1..max_windows contiguous windows (ids 1, 2, ...) then 0-pad;
    row 0 is pure padding."""
    ids = np.zeros((n, w), np.int32)
    for i in range(1, n):
        k = int(r.integers(1, max_windows + 1))
        cuts = np.sort(r.choice(np.arange(1, w), size=k, replace=False))
        start = 0
        for j, end in enumerate(cuts):
            ids[i, start:end] = j + 1
            start = end
    return ids


def row_ids(r: np.random.Generator, n: int, w: int, kind: int | str) -> np.ndarray:
    """(n, w) segment ids for the window kernels' tests: ``kind`` an int
    (packed_ids with up to that many windows a row), "pads" (every row pure
    padding) or "four" (every row four windows of random sizes, then
    padding)."""
    if isinstance(kind, int):
        return packed_ids(r, n, w, kind)
    ids = np.zeros((n, w), np.int32)
    if kind == "four":
        for i in range(n):
            start = 0
            for j, end in enumerate(np.sort(r.choice(np.arange(1, w), size=4, replace=False))):
                ids[i, start:end] = j + 1
                start = end
    return ids


def tiny_configs():
    """(JAX config, port config): Qwen25VLConfig.tiny() in f32, both sides."""
    from open_o3_video_tpu.models.qwen25vl import Qwen25VLConfig as JaxConfig
    from open_o3_video_tpu_torch.models.qwen25vl.config import Qwen25VLConfig

    return JaxConfig.tiny(), Qwen25VLConfig.tiny()


def jax_params_numpy(jcfg, seed: int = 0) -> dict:
    """The JAX package's random init (jitted: eager init compiles op by op)
    as a tree of numpy arrays."""
    import jax

    from open_o3_video_tpu.models.qwen25vl import params as P

    return jax.tree.map(np.asarray, jax.jit(functools.partial(P.init, jcfg, seed))())


@functools.cache
def model_pair(seed: int = 0):
    """Tiny f32 model in both packages with the same weights:
    (jax cfg, jax params, port cfg, port params)."""
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu_torch.models.qwen25vl import params as TP

    jcfg, tcfg = tiny_configs()
    tree = jax_params_numpy(jcfg, seed)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = TP.from_jax_params(tree, tcfg, torch.device("cpu"))
    return jcfg, jparams, tcfg, tparams


def frames(r: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """n synthetic uint8 CHW frames."""
    return r.integers(0, 256, size=(n, 3, h, w), dtype=np.uint8)


def _reset_video_reader() -> None:
    from open_o3_video_tpu_torch.data import video

    video.get_video_reader_backend.cache_clear()


@pytest.fixture
def no_video_reader(monkeypatch):
    """Neither of the port's readers: cv2 blocked and the native decoder
    reported as missing its libav headers (the reader choice is re-made
    before and after the test)."""
    from open_o3_video_tpu_torch.native import video_decoder

    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(video_decoder, "missing", lambda: ["libavformat/avformat.h"])
    _reset_video_reader()
    yield
    _reset_video_reader()


@pytest.fixture
def port_reader(monkeypatch):
    """Sets the port's video reader: ``port_reader("native" | "cv2")`` (as
    FORCE_VIDEO_READER does), re-made after the test. "native" skips where
    the libav decoder cannot be built."""
    from open_o3_video_tpu_torch.data import video
    from open_o3_video_tpu_torch.native import video_decoder

    def force(name):
        if name == "native" and video_decoder.missing():
            pytest.skip(f"the native decoder needs {video_decoder.missing()}")
        monkeypatch.setattr(video, "FORCE_VIDEO_READER", name)
        _reset_video_reader()

    yield force
    _reset_video_reader()


@pytest.fixture
def jax_reader(monkeypatch):
    """Sets the JAX package's video reader: ``jax_reader("native" | "cv2")``
    (skips "native" where its decoder is not built and cannot be)."""
    from open_o3_video_tpu.data import video as JV

    def force(name):
        if name == "native" and not JV.is_native_available():
            pytest.skip("the JAX package's native decoder is not available")
        monkeypatch.setattr(JV, "get_video_reader_backend", lambda: name)
        return JV

    return force
