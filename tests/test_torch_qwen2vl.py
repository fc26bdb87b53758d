"""Qwen2-VL in the port against the JAX package at tiny dims (``tiny_qwen2``,
JAX's random init carried across by ``from_jax_params``): the config and
its HF form (``embed_dim``, ``mlp_ratio``, the merger's ``hidden_size``),
``get_rope_index``'s raw frame index (no tokens_per_second scaling), the
LayerNorm + QuickGELU tower over whole frames on uniform and mixed grids,
``forward``'s logits in float32, the engine's greedy tokens (an image, a
video, five queries sharing a prefix, a chunked prefill cutting the vision
block) and a safetensors round trip both ways."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_parity import family_pair, rng
from test_torch_qwen3vl import (
    ATOL,
    _image_prompt,
    _patches,
    jax_logits,
    jax_tower,
    run_engine_case,
)

from open_o3_video_tpu_torch.models.qwen25vl import config as TC
from open_o3_video_tpu_torch.models.qwen25vl import model as TM
from open_o3_video_tpu_torch.models.qwen25vl import params as TP


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("dtype", None)
    return d


def test_config_fields_and_hf_dict_match_jax():
    from open_o3_video_tpu.models.qwen25vl import config as JC

    assert _fields(TC.tiny_qwen2()) == _fields(JC.tiny_qwen2())
    hf = TC.QWEN2_VL_7B_INSTRUCT_CONFIG
    ours = TC.Qwen25VLConfig.from_hf_dict(hf)
    assert _fields(ours) == _fields(JC.Qwen25VLConfig.from_hf_dict(hf))
    v, t = ours.vision, ours.text
    assert (v.depth, v.hidden_size, v.intermediate_size, v.head_dim, v.out_hidden_size,
            v.use_windows, v.act_type) == (32, 1280, 5120, 80, 3584, False, "quickgelu")
    assert _fields(t) == _fields(TC.Qwen25VLConfig().text) | {"max_position_embeddings": 32768}
    for cfg in (ours, TC.tiny_qwen2()):
        assert TC.Qwen25VLConfig.from_hf_dict(cfg.to_hf_dict(), dtype=cfg.dtype) == cfg
        assert cfg.to_hf_dict() == JC.Qwen25VLConfig.from_hf_dict(cfg.to_hf_dict()).to_hf_dict()


@pytest.mark.parametrize("spacing", [None, [0.5], [2.0]])
def test_rope_index_raw_frame_index_matches_jax(spacing):
    """A video of 3 temporal patches: its temporal positions are 0, 1, 2
    whatever the frame spacing (Qwen2.5-VL scales them by it)."""
    from open_o3_video_tpu.models.qwen25vl.model import get_rope_index

    jcfg, _, tcfg, _ = family_pair("tiny_qwen2")
    grid = np.array([[3, 4, 4]])
    ids = _image_prompt(tcfg, rng(2), grid)
    ids = np.array([[tcfg.video_token_id if t == tcfg.image_token_id else t for t in ids]])
    kw = {} if spacing is None else {"second_per_grid_ts": spacing}
    ours = TM.get_rope_index(tcfg, ids, video_grid_thw=grid, **kw)
    for a, b in zip(ours, get_rope_index(jcfg, ids, video_grid_thw=grid, **kw)):
        np.testing.assert_array_equal(a, b)
    vis = ids[0] == tcfg.video_token_id
    t_pos = ours[0][0, 0][vis]
    assert sorted(set(t_pos - t_pos.min())) == [0, 1, 2]


@pytest.mark.parametrize("grids", [[(2, 6, 10)], [(1, 4, 8), (1, 6, 6), (2, 4, 4)]])
def test_tower_matches_jax(grids):
    _, _, tcfg, tparams = family_pair("tiny_qwen2")
    grid = np.array(grids)
    pix = _patches(tcfg, rng(3), grid)
    ours = TM.encode_vision(tparams, tcfg, torch.from_numpy(pix), grid)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_tower("tiny_qwen2", pix, grid)),
                               atol=ATOL)


@pytest.mark.parametrize("kind", ["image", "video"])
def test_forward_logits_match_jax(kind):
    _, _, tcfg, tparams = family_pair("tiny_qwen2")
    r = rng(4)
    grid = np.array([[1, 4, 8]] if kind == "image" else [[2, 4, 8]])
    tok = tcfg.image_token_id if kind == "image" else tcfg.video_token_id
    ids = np.array([[tok if t == tcfg.image_token_id else t
                     for t in _image_prompt(tcfg, r, grid)]])
    pos, _ = TM.get_rope_index(tcfg, ids, **{f"{kind}_grid_thw": grid})
    pix = _patches(tcfg, r, grid)
    ours, _ = TM.forward(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(pos),
                         pixel_patches=torch.from_numpy(pix), grid_thw=grid, vision_token_id=tok)
    theirs = jax_logits("tiny_qwen2", ids, pos, pixel_patches=pix, grid_thw=grid,
                        vision_token_id=tok)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=ATOL)


@pytest.mark.parametrize("case", ["image", "video", "prefix", "chunked"])
def test_engine_greedy_tokens_match_jax_engine(case):
    _, engine = run_engine_case("tiny_qwen2", case)
    if case == "prefix":
        assert engine.counters["prefix_blocks"] == 1 and engine.counters["tower_passes"] == 1
    if case == "chunked":
        assert engine.counters["prefills"] == 4


def test_safetensors_round_trip_both_ways(tmp_path):
    """Qwen2-VL's names (``mlp.fc1``, the merger's ``ln_q`` with its bias)
    both ways between the packages."""
    import jax

    from open_o3_video_tpu.models.qwen25vl import params as JP

    jcfg, jparams, tcfg, tparams = family_pair("tiny_qwen2")
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
    jax.tree.map(np.testing.assert_array_equal, TP.to_jax_layout(loaded_t),
                 TP.to_jax_layout(tparams))
