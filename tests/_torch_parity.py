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


@functools.cache
def family_pair(name: str, seed: int = 0):
    """``model_pair`` for another tiny family config of both packages
    (``"tiny_qwen3"``, ``"tiny_qwen2"``): JAX's random init carried across
    by ``from_jax_params``: (jax cfg, jax params, port cfg, port params)."""
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.models.qwen25vl import config as JC
    from open_o3_video_tpu_torch.models.qwen25vl import config as TC
    from open_o3_video_tpu_torch.models.qwen25vl import params as TP

    jcfg, tcfg = getattr(JC, name)(), getattr(TC, name)()
    tree = jax_params_numpy(jcfg, seed)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            TP.from_jax_params(tree, tcfg, torch.device("cpu")))


@functools.cache
def hf_tiny():
    """The tiny HF Qwen2.5-VL of tests/test_model_parity.py (f32, weights
    from torch seed 0) and the port's config and params loaded from its
    state dict: (HF model, port config, port params). Skips where
    transformers is missing."""
    import dataclasses

    transformers = pytest.importorskip("transformers")
    from transformers.models.qwen2_5_vl import Qwen2_5_VLConfig

    from open_o3_video_tpu_torch.models.qwen25vl import params as TP
    from open_o3_video_tpu_torch.models.qwen25vl.config import Qwen25VLConfig

    cfg = Qwen25VLConfig.tiny()
    v, t = cfg.vision, cfg.text
    hf_cfg = Qwen2_5_VLConfig(
        vision_config=dict(
            depth=v.depth, hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
            num_heads=v.num_heads, patch_size=v.patch_size,
            spatial_merge_size=v.spatial_merge_size, temporal_patch_size=v.temporal_patch_size,
            window_size=v.window_size, fullatt_block_indexes=list(v.fullatt_block_indexes),
            out_hidden_size=v.out_hidden_size, tokens_per_second=v.tokens_per_second),
        text_config=dict(
            vocab_size=t.vocab_size, hidden_size=t.hidden_size,
            intermediate_size=t.intermediate_size, num_hidden_layers=t.num_hidden_layers,
            num_attention_heads=t.num_attention_heads,
            num_key_value_heads=t.num_key_value_heads, rms_norm_eps=t.rms_norm_eps,
            rope_theta=t.rope_theta,
            rope_scaling={"type": "mrope", "mrope_section": list(t.mrope_section)},
            tie_word_embeddings=False, max_position_embeddings=t.max_position_embeddings),
        image_token_id=cfg.image_token_id % t.vocab_size,
        video_token_id=cfg.video_token_id % t.vocab_size,
        vision_start_token_id=cfg.vision_start_token_id % t.vocab_size,
        vision_end_token_id=cfg.vision_end_token_id % t.vocab_size,
        tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    hf = transformers.Qwen2_5_VLForConditionalGeneration(hf_cfg).eval().float()
    cfg = dataclasses.replace(
        cfg, image_token_id=hf_cfg.image_token_id, video_token_id=hf_cfg.video_token_id,
        vision_start_token_id=hf_cfg.vision_start_token_id,
        vision_end_token_id=hf_cfg.vision_end_token_id)
    params = TP.from_hf_state_dict(hf.state_dict().items(), cfg, torch.device("cpu"))
    return hf, cfg, params


@functools.cache
def hf_tiny_qwen3():
    """HF's tiny Qwen3-VL (f32, weights from torch seed 0) at the port's
    ``tiny_qwen3`` widths, its state dict loaded by the port's HF loader."""
    transformers = pytest.importorskip("transformers")
    from transformers.models.qwen3_vl import Qwen3VLConfig

    from open_o3_video_tpu_torch.models.qwen25vl import params as TP
    from open_o3_video_tpu_torch.models.qwen25vl.config import tiny_qwen3

    cfg = tiny_qwen3()
    v, t = cfg.vision, cfg.text
    hf_cfg = Qwen3VLConfig(
        vision_config=dict(
            depth=v.depth, hidden_size=v.hidden_size, hidden_act="gelu_pytorch_tanh",
            intermediate_size=v.intermediate_size, num_heads=v.num_heads,
            patch_size=v.patch_size, spatial_merge_size=v.spatial_merge_size,
            temporal_patch_size=v.temporal_patch_size, out_hidden_size=v.out_hidden_size,
            num_position_embeddings=v.num_position_embeddings,
            deepstack_visual_indexes=list(v.deepstack_visual_indexes)),
        text_config=dict(
            vocab_size=t.vocab_size, hidden_size=t.hidden_size,
            intermediate_size=t.intermediate_size, num_hidden_layers=t.num_hidden_layers,
            num_attention_heads=t.num_attention_heads,
            num_key_value_heads=t.num_key_value_heads, head_dim=t.head_dim,
            rms_norm_eps=t.rms_norm_eps, rope_theta=t.rope_theta,
            rope_scaling={"rope_type": "default", "mrope_section": list(t.mrope_section),
                          "mrope_interleaved": True},
            attention_bias=False, tie_word_embeddings=False,
            max_position_embeddings=t.max_position_embeddings),
        image_token_id=cfg.image_token_id, video_token_id=cfg.video_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
        vision_end_token_id=cfg.vision_end_token_id, tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = transformers.Qwen3VLForConditionalGeneration(hf_cfg).eval().float()
    return hf, cfg, TP.from_hf_state_dict(hf.state_dict().items(), cfg, torch.device("cpu"))


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
