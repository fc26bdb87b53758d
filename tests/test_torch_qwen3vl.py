"""Qwen3-VL (dense) in the port against the JAX package at tiny dims
(``tiny_qwen3``, JAX's random init carried across by ``from_jax_params``)
(HF transformers' tiny ``Qwen3VLForConditionalGeneration`` in
``test_torch_hf_parity.py``): the config and its HF form, the interleaved M-RoPE tables, ``get_rope_index``'s
per-frame split of a video grid, the tower's embeddings and deepstack taps
on uniform and mixed grids, ``forward``'s logits in float32, the engine's
greedy tokens (an image, a video, five queries sharing a prefix, a chunked
prefill whose chunk boundary cuts the vision block) and a safetensors round
trip both ways. Same numpy inputs on both sides; f32 on the CPU."""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_MODEL, family_pair, rng

from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.models.qwen25vl import config as TC
from open_o3_video_tpu_torch.models.qwen25vl import model as TM
from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.ops.rope import mrope_cos_sin, mrope_cos_sin_interleaved

# f32 on the CPU, the two packages summing in different orders: the tower's
# tables and the logits agree to ~5e-7 (measured); 1e-5 is the bound.
ATOL = 1e-5


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    return d


def test_config_fields_and_hf_dict_match_jax():
    from open_o3_video_tpu.models.qwen25vl import config as JC

    assert _fields(TC.tiny_qwen3()) == _fields(JC.tiny_qwen3())
    hf = TC.QWEN3_VL_8B_INSTRUCT_CONFIG
    ours = TC.Qwen25VLConfig.from_hf_dict(hf)
    assert _fields(ours) == _fields(JC.Qwen25VLConfig.from_hf_dict(hf))
    v, t = ours.vision, ours.text
    assert (v.depth, v.hidden_size, v.num_heads, v.head_dim, v.patch_size,
            v.deepstack_visual_indexes, v.out_hidden_size) == (27, 1152, 16, 72, 16, (8, 16, 24),
                                                              4096)
    assert (t.hidden_size, t.num_hidden_layers, t.num_attention_heads, t.num_key_value_heads,
            t.head_dim, t.vocab_size, t.mrope_section) == (4096, 36, 32, 8, 128, 151936,
                                                           (24, 20, 20))
    for cfg in (ours, TC.tiny_qwen3()):
        back = TC.Qwen25VLConfig.from_hf_dict(cfg.to_hf_dict(), dtype=cfg.dtype)
        assert back == cfg
        assert cfg.to_hf_dict() == JC.Qwen25VLConfig.from_hf_dict(cfg.to_hf_dict()).to_hf_dict()


@pytest.mark.parametrize("head_dim,section", [(16, (4, 2, 2)), (128, (24, 20, 20))])
def test_interleaved_cos_sin_match_jax(head_dim, section):
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.rope import mrope_cos_sin_interleaved as jax_tables

    pos = rng(0).integers(0, 4000, size=(3, 2, 9))
    ours = mrope_cos_sin_interleaved(torch.from_numpy(pos), head_dim, section, 5e6)
    theirs = jax_tables(jnp.asarray(pos), head_dim, section, 5e6)
    for a, b in zip(ours, theirs):  # f32 cos/sin of angles to ~4000 rad: ATOL
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    # one position on all three axes (text, and every decode step): plain rope
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    inter = mrope_cos_sin_interleaved(torch.from_numpy(same), head_dim, section, 5e6)
    chunked = mrope_cos_sin(torch.from_numpy(same), head_dim, section, 5e6)
    assert all(torch.equal(a, b) for a, b in zip(inter, chunked))


def _video_prompt(cfg, r, grid, stamp=55):
    """A Qwen3-VL video prompt as HF's processor lays it out: text, then per
    frame ``<stamp><vision_start><video_pad> x n<vision_end>``, then text."""
    t, h, w = grid
    ids = r.integers(5, 90, size=3).tolist()
    for _ in range(t):
        ids += ([stamp, cfg.vision_start_token_id]
                + [cfg.video_token_id] * (h * w // cfg.vision.merge_unit)
                + [cfg.vision_end_token_id])
    return ids + r.integers(5, 90, size=4).tolist()


def _image_prompt(cfg, r, grids, pre=5, post=4):
    ids = r.integers(5, 90, size=pre).tolist()
    for t, h, w in grids:
        ids += ([cfg.vision_start_token_id] + [cfg.image_token_id] * (t * h * w // 4)
                + [cfg.vision_end_token_id])
    return ids + r.integers(5, 90, size=post).tolist()


def _patches(cfg, r, grids):
    n = int(np.prod(grids, axis=1).sum())
    return r.standard_normal((n, cfg.vision.patch_dim)).astype(np.float32)


def test_rope_index_matches_jax():
    """The video grid splits into per-frame grids of t = 1 (time lives in
    the timestamp text); images and a left-padded batch as Qwen2.5-VL."""
    from open_o3_video_tpu.models.qwen25vl.model import get_rope_index

    jcfg, _, tcfg, _ = family_pair("tiny_qwen3")
    r = rng(2)
    grid = np.array([[3, 4, 4]])
    ids = np.array([_video_prompt(tcfg, r, grid[0])])
    mask = np.ones_like(ids)
    mask[0, :2] = 0
    for kw in ({}, {"attention_mask": mask}):
        ours = TM.get_rope_index(tcfg, ids, video_grid_thw=grid, **kw)
        theirs = get_rope_index(jcfg, ids, video_grid_thw=grid, **kw)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    # the frame spacing plays no part (JAX's copy indexes it per frame grid
    # and raises IndexError past the first)
    for a, b in zip(TM.get_rope_index(tcfg, ids, video_grid_thw=grid, second_per_grid_ts=[2.0]),
                    get_rope_index(jcfg, ids, video_grid_thw=grid)):
        np.testing.assert_array_equal(a, b)
    # every frame block starts its own temporal index at 0
    pos, _ = TM.get_rope_index(tcfg, ids, video_grid_thw=grid)
    vis = ids[0] == tcfg.video_token_id
    assert len(set(pos[0, 0][vis] - pos[1, 0][vis].min())) > 1
    images = np.array([[1, 4, 8], [2, 6, 4]])
    ids = np.array([_image_prompt(tcfg, r, images)])
    for a, b in zip(TM.get_rope_index(tcfg, ids, image_grid_thw=images),
                    get_rope_index(jcfg, ids, image_grid_thw=images)):
        np.testing.assert_array_equal(a, b)


def jax_tower(name, pix, grid):
    """JAX's ``encode_vision`` at these inputs, jitted (one compile, not one
    per op: the CPU tests' time)."""
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.models.qwen25vl.model import encode_vision

    jcfg, jparams, _, _ = family_pair(name)
    return jax.jit(lambda p, x: encode_vision(p, jcfg, x, grid))(jparams, jnp.asarray(pix))


def jax_logits(name, ids, pos, **vision):
    """JAX's ``forward`` logits at these inputs, jitted."""
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.models.qwen25vl.model import forward

    jcfg, jparams, _, _ = family_pair(name)
    pix = vision.pop("pixel_patches", None)
    fn = jax.jit(lambda p, i, q, x: forward(p, jcfg, i, q, pixel_patches=x, **vision)[0])
    return np.asarray(fn(jparams, jnp.asarray(ids), jnp.asarray(pos),
                         None if pix is None else jnp.asarray(pix)))


@pytest.mark.parametrize("grids", [[(2, 6, 10)], [(1, 4, 8), (1, 6, 6), (2, 4, 4)]])
def test_tower_and_taps_match_jax(grids):
    """A uniform grid (whole frames as equal runs) and mixed ones (a
    gather/scatter plan): the merged embeddings and every deepstack tap."""
    _, _, tcfg, tparams = family_pair("tiny_qwen3")
    grid = np.array(grids)
    pix = _patches(tcfg, rng(3), grid)
    main, taps = TM.encode_vision(tparams, tcfg, torch.from_numpy(pix), grid)
    jmain, jtaps = jax_tower("tiny_qwen3", pix, grid)
    assert len(taps) == len(jtaps) == len(tcfg.vision.deepstack_visual_indexes)
    for a, b in zip([main] + taps, [jmain] + jtaps):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("kind", ["image", "video"])
def test_forward_logits_match_jax(kind):
    _, _, tcfg, tparams = family_pair("tiny_qwen3")
    r = rng(4)
    grid = np.array([[1, 4, 8]] if kind == "image" else [[2, 4, 8]])
    ids = np.array([_image_prompt(tcfg, r, grid) if kind == "image"
                    else _video_prompt(tcfg, r, grid[0])])
    tok = tcfg.image_token_id if kind == "image" else tcfg.video_token_id
    pos, _ = TM.get_rope_index(tcfg, ids, **{f"{kind}_grid_thw": grid})
    pix = _patches(tcfg, r, grid)
    kw = dict(pixel_patches=torch.from_numpy(pix), grid_thw=grid, vision_token_id=tok)
    ours, _ = TM.forward(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), **kw)
    theirs = jax_logits("tiny_qwen3", ids, pos, pixel_patches=pix, grid_thw=grid,
                        vision_token_id=tok)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=ATOL)
    # the taps reach the logits: zeroing them changes them
    zeroed = dict(tparams, visual=dict(tparams["visual"], deepstack=[
        {k: torch.zeros_like(x) for k, x in m.items()} for m in tparams["visual"]["deepstack"]]))
    bare, _ = TM.forward(zeroed, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), **kw)
    assert (bare - ours).abs().max() > 1e-3


# One engine configuration for every case: a prefix cache, and prompts of 48
# tokens or more prefill in chunks of 16 (the JAX engine pads to its 48
# bucket, the port to the longest prompt: their chunk boundaries differ, and
# both cut the vision block).
KNOBS = dict(prompt_buckets=(48, 64), prefix_cache_min=8, suffix_buckets=(16,),
             long_prefill_threshold=48, long_prefill_chunk=16)


@functools.cache
def _jax_engine(name):
    import jax.numpy as jnp

    from open_o3_video_tpu.engine import InferenceEngine as JaxEngine

    jcfg, jparams, _, _ = family_pair(name)
    return JaxEngine(jparams, jcfg, cache_dtype=jnp.float32, **KNOBS)


def engine_cases(cfg, name):
    """(requests, sampling) of each engine case over a family's tiny config."""
    r = rng(5)
    img = np.array([[1, 4, 8]])
    vid = np.array([[2, 4, 8]])
    big = np.array([[1, 8, 8]])
    pix_img, pix_vid, pix_big = (_patches(cfg, r, g) for g in (img, vid, big))
    video_ids = (_video_prompt(cfg, r, vid[0]) if name == "tiny_qwen3"
                 else _image_prompt(cfg, r, [(2, 4, 8)]))
    if name != "tiny_qwen3":
        video_ids = [cfg.video_token_id if t == cfg.image_token_id else t for t in video_ids]
    shared = [7, 8, cfg.vision_start_token_id] + [cfg.image_token_id] * 8 + [
        cfg.vision_end_token_id]
    greedy = SamplingParams(temperature=0.0, repetition_penalty=1.05, max_tokens=6)
    return {
        "image": [Request(_image_prompt(cfg, r, img), pixel_patches=pix_img, grid_thw=img,
                          vision_token_id=cfg.image_token_id)],
        "video": [Request(video_ids, pixel_patches=pix_vid, grid_thw=vid,
                          vision_token_id=cfg.video_token_id,
                          second_per_grid_ts=None if name == "tiny_qwen3" else [2.0])],
        "prefix": [Request(shared + [20 + q, 30 + q, 40 + q], pixel_patches=pix_img,
                           grid_thw=img, vision_token_id=cfg.image_token_id) for q in range(5)],
        # 16 vision tokens from position 8: the first chunk ends inside them
        "chunked": [Request(_image_prompt(cfg, r, big, pre=7, post=27), pixel_patches=pix_big,
                            grid_thw=big, vision_token_id=cfg.image_token_id)],
    }, greedy


def run_engine_case(name, case):
    """Both engines on one case: the port's outputs and engine, after their
    tokens and log-probabilities were held to the JAX engine's."""
    from open_o3_video_tpu.engine import Request as JaxRequest
    from open_o3_video_tpu.engine import SamplingParams as JaxSampling

    _, _, tcfg, tparams = family_pair(name)
    reqs, sampling = engine_cases(tcfg, name)[0][case], engine_cases(tcfg, name)[1]
    engine = InferenceEngine(tparams, tcfg, cache_dtype=torch.float32, **KNOBS)
    ours = engine.generate(reqs, sampling, return_logprobs=True)
    fields = [f.name for f in dataclasses.fields(Request)]
    theirs = _jax_engine(name).generate(
        [JaxRequest(**{f: getattr(q, f) for f in fields}) for q in reqs],
        JaxSampling(**dataclasses.asdict(sampling)), return_logprobs=True)
    for o, t in zip(ours, theirs):
        assert o["token_ids"] == [int(x) for x in t["token_ids"]]
        np.testing.assert_allclose(o["logprobs"], t["logprobs"], atol=ATOL_MODEL)
    return ours, engine


@pytest.mark.parametrize("case", ["image", "video", "prefix", "chunked"])
def test_engine_greedy_tokens_match_jax_engine(case):
    ours, engine = run_engine_case("tiny_qwen3", case)
    if case == "prefix":
        assert engine.counters["prefix_blocks"] == 1 and engine.counters["tower_passes"] == 1
    if case == "chunked":
        assert engine.counters["prefills"] == 4  # 52 tokens in chunks of 16


def test_safetensors_round_trip_both_ways(tmp_path):
    """The port's export loads in JAX's ``load_pretrained`` leaf for leaf,
    and JAX's export in the port's."""
    import jax

    from open_o3_video_tpu.models.qwen25vl import params as JP

    jcfg, jparams, tcfg, tparams = family_pair("tiny_qwen3")
    ours_dir, theirs_dir = tmp_path / "ours", tmp_path / "theirs"
    for d in (ours_dir, theirs_dir):
        d.mkdir()
        (d / "config.json").write_text(json.dumps(tcfg.to_hf_dict()))
    TP.save_safetensors(tparams, tcfg, str(ours_dir / "model.safetensors"))
    JP.save_safetensors(jparams, jcfg, str(theirs_dir / "model.safetensors"))
    loaded_j, _ = JP.load_pretrained(str(ours_dir), cfg=jcfg)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 loaded_j, jparams)
    cfg_t = TC.Qwen25VLConfig.from_pretrained(str(theirs_dir), dtype=torch.float32)
    assert cfg_t == tcfg
    loaded_t, _ = TP.load_pretrained(str(theirs_dir), torch.device("cpu"), cfg_t)
    want, got = TP.to_jax_layout(tparams), TP.to_jax_layout(loaded_t)
    jax.tree.map(np.testing.assert_array_equal, got, want)


@pytest.mark.parametrize("family", ["tiny_qwen3", "tiny_qwen2"])
def test_training_entry_points_refuse_the_served_families(family, tmp_path):
    """What the port still refuses of the two families' training: both CLIs
    a checkpoint of Qwen3-VL's patch 16 (their processor cuts frames for
    patch 14, as JAX's apps do), the eval wrapper Qwen3-VL, and K1 and K6's
    fused backward (the windowed blocks' kernels) head_dim 72. The step
    factories and the GSPO trainer build for both families, and K2's exact
    mode and K6's whole-frame kernels take head_dim 72 (they raise only at
    the CPU tensor). Training itself: tests/test_torch_train_families.py."""
    from open_o3_video_tpu_torch.eval.model_engine import QwenVLEngine
    from open_o3_video_tpu_torch.ops import window_attention as twa
    from open_o3_video_tpu_torch.train import grpo_main, sft_main
    from open_o3_video_tpu_torch.train.gspo import GSPOConfig, GSPOTrainer
    from open_o3_video_tpu_torch.train.lora import LoraConfig
    from open_o3_video_tpu_torch.train.sft import (
        SFTConfig, make_lora_train_step, make_optimizer, make_train_step)

    cfg = getattr(TC, family)()
    opt = make_optimizer(SFTConfig())
    make_train_step(cfg, SFTConfig(), opt)
    make_lora_train_step(cfg, SFTConfig(), opt, 1.0)
    GSPOTrainer(TP.init(cfg, 0, torch.device("cpu")), None, cfg, GSPOConfig(), detokenize=str,
                lora=LoraConfig(rank=2))
    published = TC.Qwen25VLConfig.from_hf_dict(
        TC.QWEN3_VL_8B_INSTRUCT_CONFIG if family == "tiny_qwen3" else
        TC.QWEN2_VL_7B_INSTRUCT_CONFIG)
    (tmp_path / "config.json").write_text(json.dumps(published.to_hf_dict()))
    for main in (sft_main.main, grpo_main.main):
        args = ["--model_name_or_path", str(tmp_path), "--device", "cpu",
                "--dataset_name", str(tmp_path / "data.json"), "--data_root", str(tmp_path),
                "--output_dir", str(tmp_path / "out")]
        if family == "tiny_qwen3":
            with pytest.raises(NotImplementedError, match="patch 14"):
                main(args)
        else:  # past the family's checks: the missing weights stop it
            with pytest.raises(ValueError, match="checkpoint is missing"):
                main(args)
    if family == "tiny_qwen3":
        with pytest.raises(NotImplementedError, match="patch 14"):
            QwenVLEngine({}, cfg=cfg)
    q = torch.zeros(1, 64, 1, 72, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="windowed blocks"):
        twa._check_fused("fused_window_attention", q.reshape(1, 64, 72).repeat(1, 1, 3), None,
                         None, None, 1)
    for name in ("window_attention_exact", "window_attention_bwd"):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            twa._check_window(name, q, q, q, torch.ones(1, 64))
