"""The port's model and engine against HF transformers' Qwen2.5-VL: the tiny
random HF model of ``tests/test_model_parity.py`` (``_torch_parity.hf_tiny``),
its state dict loaded into the port. ``forward``'s logits match HF's on a
text-only batch and on an image request at three grids, within the
tolerances the JAX package's parity tests hold (f32: 2e-4 absolute and
2e-3 relative for text, 5e-4 and 5e-3 with vision, whose tower adds its
own sums); the engine's greedy tokens, plain and speculative, equal HF's
``generate`` (greedy, no repetition penalty); the same for HF's tiny
Qwen3-VL (``_torch_parity.hf_tiny_qwen3``: deepstack, qk-norm, interleaved
M-RoPE) on an image request."""

import numpy as np
import pytest
import torch

from _torch_parity import hf_tiny, hf_tiny_qwen3, rng

from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.models.qwen25vl.model import forward, get_rope_index


def _image_ids(cfg, r, grid):
    t, h, w = grid
    n_patches = t * h * w
    pixel = r.standard_normal((n_patches, cfg.vision.patch_dim)).astype(np.float32)
    ids = (r.integers(0, 400, 5).tolist() + [cfg.vision_start_token_id]
           + [cfg.image_token_id] * (n_patches // 4) + [cfg.vision_end_token_id]
           + r.integers(0, 400, 4).tolist())
    return ids, pixel, np.array([grid])


def test_text_only_logits_match_hf():
    hf, cfg, params = hf_tiny()
    input_ids = rng(0).integers(0, 400, size=(2, 12))
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(input_ids)).logits.numpy()
        position_ids, _ = get_rope_index(cfg, input_ids)
        got, _ = forward(params, cfg, torch.from_numpy(input_ids), torch.from_numpy(position_ids))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("grid", [(1, 4, 8), (1, 8, 8), (2, 6, 10)])
def test_image_request_logits_match_hf(grid):
    hf, cfg, params = hf_tiny()
    ids, pixel, grid_thw = _image_ids(cfg, rng(1), grid)
    input_ids = np.array([ids])
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(input_ids), pixel_values=torch.from_numpy(pixel),
                  image_grid_thw=torch.from_numpy(grid_thw)).logits.numpy()
        position_ids, _ = get_rope_index(cfg, input_ids, image_grid_thw=grid_thw)
        got, _ = forward(params, cfg, torch.from_numpy(input_ids),
                         torch.from_numpy(position_ids), pixel_patches=torch.from_numpy(pixel),
                         grid_thw=grid_thw, vision_token_id=cfg.image_token_id)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-3)


@pytest.mark.parametrize("spec", [False, True])
@pytest.mark.parametrize("vision", [False, True])
def test_greedy_engine_tokens_match_hf_generate(vision, spec):
    """10 greedy tokens of one request (text-only, or an image of grid
    (1, 4, 8)) through InferenceEngine, f32 cache, plain or with greedy
    speculative decoding, equal to HF generate's."""
    hf, cfg, params = hf_tiny()
    r = rng(2)
    if vision:
        ids, pixel, grid_thw = _image_ids(cfg, r, (1, 4, 8))
        req = Request(ids, pixel_patches=pixel, grid_thw=grid_thw,
                      vision_token_id=cfg.image_token_id)
        extra = {"pixel_values": torch.from_numpy(pixel),
                 "image_grid_thw": torch.from_numpy(grid_thw)}
    else:
        ids = r.integers(0, 400, 9).tolist()
        req, extra = Request(ids), {}
    with torch.no_grad():
        want = hf.generate(input_ids=torch.tensor([ids]), max_new_tokens=10, do_sample=False,
                           repetition_penalty=1.0, eos_token_id=cfg.eos_token_id,
                           pad_token_id=cfg.pad_token_id, **extra)[0, len(ids):].tolist()
    engine = InferenceEngine(params, cfg, cache_dtype=torch.float32, prompt_buckets=(64,),
                             spec_decode=spec, spec_draft=4)
    got = engine.generate([req], SamplingParams(temperature=0.0, repetition_penalty=1.0,
                                                max_tokens=10))[0]["token_ids"]
    assert got == want
    assert (engine.spec_stats["verify_steps"] > 0) == spec


def test_qwen3vl_forward_and_greedy_tokens_match_hf():
    """An image request: ``forward``'s logits within the tolerance of JAX's
    HF parity test (5e-4, 5e-3 relative), and 8 greedy engine tokens equal
    to HF ``generate``'s (no repetition penalty)."""
    from test_torch_qwen3vl import _image_prompt, _patches

    hf, cfg, params = hf_tiny_qwen3()
    r = rng(6)
    grid = np.array([[1, 4, 8]])
    ids = _image_prompt(cfg, r, grid)
    pix = _patches(cfg, r, grid)
    with torch.no_grad():
        want = hf(input_ids=torch.tensor([ids]), pixel_values=torch.from_numpy(pix),
                  image_grid_thw=torch.from_numpy(grid)).logits.numpy()
        pos, _ = get_rope_index(cfg, np.array([ids]), image_grid_thw=grid)
        got, _ = forward(params, cfg, torch.tensor([ids]), torch.from_numpy(pos),
                         pixel_patches=torch.from_numpy(pix), grid_thw=grid,
                         vision_token_id=cfg.image_token_id)
        np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-3)
        tokens = hf.generate(input_ids=torch.tensor([ids]), pixel_values=torch.from_numpy(pix),
                             image_grid_thw=torch.from_numpy(grid), max_new_tokens=8,
                             do_sample=False, repetition_penalty=1.0,
                             attention_mask=torch.ones(1, len(ids), dtype=torch.long))
    engine = InferenceEngine(params, cfg, cache_dtype=torch.float32, prompt_buckets=(64,))
    out = engine.generate([Request(ids, pixel_patches=pix, grid_thw=grid,
                                   vision_token_id=cfg.image_token_id)],
                          SamplingParams(temperature=0.0, repetition_penalty=1.0, max_tokens=8))
    assert out[0]["token_ids"] == tokens[0, len(ids):].tolist()
