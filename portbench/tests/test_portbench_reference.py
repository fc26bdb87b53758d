"""The plain reference against the program's plain path (its CPU code, in
float32) at tiny sizes of both families; the benchmark's weights against
the program's parameter layout; the reference's inputs against what the
program's processor makes of the same frames and prompts."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench.lib import serve_check, traffic
from portbench.lib.arch import read_arch
from portbench.lib.weights import make_weights
from portbench.reference import inputs as ref_inputs
from portbench.reference import qwen_vl

import tiny


def program_cfg(config: dict):
    from open_o3_video_tpu_torch.models.qwen25vl import Qwen25VLConfig

    return Qwen25VLConfig.from_hf_dict(config, dtype=torch.float32)


def shapes(tree):
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("config", [tiny.qwen25, tiny.qwen3_moe], ids=["qwen25", "qwen3_moe"])
def test_weights_have_the_programs_layout(config):
    from open_o3_video_tpu_torch.models.qwen25vl import params as P

    cfg = config()
    ours = make_weights(read_arch(cfg), 3, torch.device("cpu"), torch.float32)
    assert shapes(ours) == shapes(P.init(program_cfg(cfg), 3, torch.device("cpu")))


def test_weights_repeat_for_a_seed_and_differ_across_seeds():
    a = read_arch(tiny.qwen25())
    w1, w2 = (make_weights(a, 2**31 + 9, torch.device("cpu")) for _ in range(2))
    w3 = make_weights(a, 2**31 + 10, torch.device("cpu"))
    assert torch.equal(w1["text"]["lm_head"], w2["text"]["lm_head"])
    assert not torch.equal(w1["text"]["lm_head"], w3["text"]["lm_head"])


def one_request(config: dict, seed: int):
    """A tiny request of the serving mix of ``config``'s family: ids, the
    rope grids, patches and the tower's grid, made by the reference."""
    a = read_arch(config)
    mix = tiny.mix("vstar" if a.family == "qwen2_5_vl" else "video8")
    call = traffic.make_call(mix, a, seed, 0)
    return a, call, serve_check.request_inputs(call, 0, a, torch.device("cpu"))


@pytest.mark.parametrize("config", [tiny.qwen25, tiny.qwen3_moe], ids=["qwen25", "qwen3_moe"])
def test_reference_logits_match_the_programs_plain_forward(config):
    from open_o3_video_tpu_torch.models.qwen25vl.model import forward, get_rope_index

    cfg = config()
    a, call, inp = one_request(cfg, 5)
    weights = make_weights(a, 11, torch.device("cpu"), torch.float32)
    pcfg = program_cfg(cfg)
    ids = np.asarray(inp["ids"])[None]
    if a.family == "qwen2_5_vl":
        grid, tok, kw = np.asarray(inp["tower_grid"]), a.image_token, "image_grid_thw"
    else:
        grid, tok, kw = np.asarray(inp["tower_grid"]), a.video_token, "video_grid_thw"
    pos, _ = get_rope_index(pcfg, ids, **{kw: grid})
    theirs, _ = forward(weights, pcfg, torch.from_numpy(ids), torch.from_numpy(pos),
                        pixel_patches=inp["patches"], grid_thw=grid, vision_token_id=tok,
                        attn_impl="torch")
    with torch.no_grad():
        tower = qwen_vl.vision_tower(weights["visual"], a, inp["patches"], inp["tower_grid"])
        ours = qwen_vl.logits(weights, a, inp["ids"], inp["rope_grids"], tower,
                              slice(0, len(inp["ids"])))
    assert np.array_equal(qwen_vl.mrope_positions(inp["ids"], inp["rope_grids"], a), pos[:, 0])
    scale = theirs.abs().max()
    assert (ours - theirs[0]).abs().max() <= 1e-4 * scale


def test_reference_inputs_match_the_programs_processor():
    """The V-STAR path: the prompt text, ids and patch rows the reference
    works out equal what the program's eval path makes of the call."""
    from open_o3_video_tpu_torch.data.processor import O3VideoProcessor
    from open_o3_video_tpu_torch.eval import vstar
    from open_o3_video_tpu_torch.eval.model_engine import QwenVLEngine

    cfg = tiny.qwen25()
    a, call, _ = one_request(cfg, 8)
    model = QwenVLEngine(make_weights(a, 1, torch.device("cpu"), torch.float32),
                         cfg=program_cfg(cfg), processor=O3VideoProcessor(), device="cpu")
    images = None
    for r, key in enumerate(call["keys"]):
        raw, images = vstar.build_query_input(call["prompts"][key], call["frames"], call["times"],
                                              model, images)
        req = model._request_from_raw(raw)
        ours = serve_check.request_inputs(call, r, a, torch.device("cpu"))
        assert list(req.input_ids) == ours["ids"], key
        diff = (torch.as_tensor(req.pixel_patches) - ours["patches"]).abs()
        # the program resizes in float32, the reference in float64: a uint8
        # rounding tie may fall the other way (one level, 1/255 over the
        # smallest CLIP deviation)
        assert diff.max() <= 1.0 / 255 / 0.26 + 1e-6 and diff.mean() < 1e-4
        assert [tuple(g) for g in req.grid_thw] == ours["tower_grid"]


def test_a_tiny_run_of_each_serving_cell_is_correct():
    from portbench.runners import serve

    for config, mix, cell in ((tiny.qwen25, "vstar", "vstar.qwen25vl-7b"),
                              (tiny.qwen3_moe, "video8", "serve.qwen3vl-30b-a3b")):
        files = {"config": config(), "mix": tiny.mix(mix),
                 "limits": {"gap_max": {"limit": 0.02}}}
        r = serve.run(cell, files, [], 2**31 + 3, 0.01, False, torch.device("cpu"),
                            time.perf_counter())
        assert r["correct"] and r["attempted"] == files["mix"]["requests_per_call"]
        assert r["check"]["tokens"] == 2 * files["mix"]["max_tokens"]
        assert ref_inputs.smart_resize(360, 640) == (336, 588)
