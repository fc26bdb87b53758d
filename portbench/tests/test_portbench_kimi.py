"""The Kimi-VL cell's and the long-context cell's pieces on the CPU at a
tiny size: the weight layout against the program's own ``init``, the
traffic, the work, a whole run of each new runner (the check included),
the reference importing nothing of the program, and the four new readers
on a synthetic ``bench.Context``."""

from __future__ import annotations

import copy
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import tiny
from portbench.lib import bench, counts, counts_mla, kimi_arch, kimi_traffic, kimi_weights
from portbench.lib import kimi_work

BENCH_DIR = Path(__file__).resolve().parents[1]


def tiny_kimi() -> dict:
    d = json.loads((BENCH_DIR / "configs" / "kimi-vl-a3b.json").read_text())
    d.update(hidden_size=64, intermediate_size=96, num_hidden_layers=3, num_attention_heads=4,
             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             moe_intermediate_size=24, n_routed_experts=8, num_experts_per_tok=3)
    d["vision_config"].update(num_hidden_layers=2, hidden_size=32, intermediate_size=48,
                              num_attention_heads=2, init_pos_emb_height=8,
                              init_pos_emb_width=8)
    return d


def kimi_mix() -> dict:
    m = copy.deepcopy(json.loads((BENCH_DIR / "traffic" / "longvideo8.json").read_text()))
    m.update(frames=2, frame_hw=[48, 90], resize_hw=[56, 84], requests_per_call=3,
             max_tokens=6, warmup_tokens=2, calls_made_in_setup=1, max_slots=2)
    m["system"] = m["system"][:300]  # the prefix above the prefix cache's 256 tokens
    return m


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_weight_layout_is_the_programs():
    from open_o3_video_tpu_torch.models.kimi_vl import KimiVLConfig, params

    d = tiny_kimi()
    a = kimi_arch.read_arch(d)
    ours = kimi_weights.make_weights(a, 3, torch.device("cpu"))
    cfg = KimiVLConfig.from_hf_dict(d)
    theirs = params.init(cfg, 0, "cpu")
    assert _shapes(ours) == _shapes(theirs)
    assert kimi_weights.count(a) == sum(
        math.prod(s) for s in _leaf_shapes(kimi_weights.leaf_specs(a), "w"))


def _leaf_shapes(tree, kind):
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _leaf_shapes(v, kind)]
    if isinstance(tree, list):
        return [s for v in tree for s in _leaf_shapes(v, kind)]
    return [tree[1]] if tree[0] == kind else []


def test_the_published_configuration_is_16_4b_parameters():
    a = kimi_arch.read_arch(json.loads((BENCH_DIR / "configs" / "kimi-vl-a3b.json").read_text()))
    assert 16.3e9 < kimi_weights.count(a) < 16.5e9
    assert counts_mla.latent_bytes_per_token(a) == 27 * 576 * 2


def test_traffic_shares_the_video_prefix_and_work_counts_it():
    d = tiny_kimi()
    a = kimi_arch.read_arch(d)
    mix = kimi_mix()
    call = kimi_traffic.make_call(mix, a, 2**33 + 5, 0)
    again = kimi_traffic.make_call(mix, a, 2**33 + 5, 0)
    assert np.array_equal(call["frames"], again["frames"])
    ids = [r["ids"] for r in call["requests"]]
    assert all(x.count(a.image_token) == 2 * 4 * 6 // 4 for x in ids)
    w = kimi_work.call_work(call, [[1, 2], [3], [4, 5, 6]], a)
    pl = w["shared"][0]
    assert pl >= 256 and all(s == pl for s in w["shared"])
    assert ids[0][:pl] == ids[1][:pl] and ids[0][pl] != ids[1][pl]
    assert w["forwards"][0] == (pl, pl) and len(w["forwards"]) == 4
    assert w["grids"] == [[(2, 4, 6)]]


def test_kimi_runner_runs_and_checks_on_the_cpu(monkeypatch):
    from open_o3_video_tpu_torch.models.kimi_vl import text as KT
    from portbench.runners import serve_kimi

    seen = {"expanded": 0, "absorbed": 0}
    for name, path in (("mla_prefill_attention", "expanded"), ("mla_decode", "absorbed")):
        def counted(*a, _fn=getattr(KT, name), _path=path, **kw):
            seen[_path] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(KT, name, counted)

    files = {"config": tiny_kimi(), "mix": kimi_mix(), "limits": {"gap_max": {"limit": 1.0}}}
    r = serve_kimi.run("longvideo.kimi-vl-a3b", files, [], 5, 0.01, False,
                       torch.device("cpu"), time.perf_counter())
    assert r["correct"], r["check"]
    c = r["counters"][0]
    assert c["prefix_blocks"] == 1 and c["tower_passes"] == 1
    assert seen["expanded"] > 0 and seen["absorbed"] > 0
    assert r["check"]["requests"] == 2 and r["check"]["gap_max"] < 0.5


def test_kimi_check_control_is_not_correct():
    """The float8 control in the program's place on the tiny model: its
    tokens lie further below the reference's best than bf16 rounding puts
    the program's."""
    from portbench.runners import serve_kimi

    files = {"config": tiny_kimi(), "mix": kimi_mix(), "limits": {"gap_max": {"limit": 1.0}}}
    r = serve_kimi.run("longvideo.kimi-vl-a3b", files, [], 5, 0.01, False,
                       torch.device("cpu"), time.perf_counter(), judge="fp8")
    assert r["check"]["judge"] == "fp8" and r["check"]["lp_err_max"] > 0


def test_long_context_runner_runs_with_an_fp8_cache_on_the_cpu():
    from portbench.runners import serve_long

    mix = copy.deepcopy(json.loads((BENCH_DIR / "traffic" / "longctx1.json").read_text()))
    mix.update(frames=2, frame_hw=[40, 72], resize_hw=[56, 84], max_tokens=4, warmup_tokens=2,
               calls_made_in_setup=1)
    files = {"config": tiny.qwen25(), "mix": mix, "limits": {"gap_max": {"limit": 1.0}}}
    r = serve_long.run("longctx.qwen25vl-7b", files, [], 7, 0.01, False, torch.device("cpu"),
                       time.perf_counter())
    assert r["check"]["requests"] == 1 and r["failed"] == 0
    assert r["check"]["gap_max"] < 1.0


def test_long_context_prompts_fit_the_contract():
    from portbench.lib import traffic
    from portbench.lib.arch import read_arch
    from portbench.runners import serve_long

    mix = json.loads((BENCH_DIR / "traffic" / "longctx1.json").read_text())
    a = read_arch(json.loads((BENCH_DIR / "configs" / "qwen25vl-7b.json").read_text()))
    small = dict(mix, frame_hw=[28, 28])  # the prompt's length does not depend on the pixels
    call = traffic.make_call(small, a, 1, 0)
    n = len(call["requests"][0]["ids"])
    assert 81_000 < n <= serve_long.MAX_PROMPT
    serve_long.check_call(call, a)


def _ctx(arch, records, work, trace, traced_index):
    return bench.Context("longvideo.kimi-vl-a3b", arch, {}, [None] * len(records), records,
                         work, traced_index, trace)


def test_the_four_readers_on_a_synthetic_context():
    a = kimi_arch.read_arch(json.loads((BENCH_DIR / "configs" / "kimi-vl-a3b.json").read_text()))
    work = {"grids": [[(64, 24, 42)]], "forwards": [(18000, 18000), (50, 18050)],
            "prompts": [18050, 18060], "shared": [18000, 18000], "answers": [512, 300]}
    steady = {"seconds": 4.0, "stages": {"decode": 3.0}, "counters": {}, "decode_steps": 511}
    traced = {"seconds": 6.0, "stages": {"decode": 4.0},
              "counters": {"expert_reads": 26 * 511 * 10, "moe_layer_steps": 26 * 511},
              "decode_steps": 511}
    trace = {"kernel_s": {"o3v_mla_decode": 0.9, "o3v_mla_decode_combine": 0.1,
                          "o3v_mla_prefill": 0.25}, "busy_s": 5.0, "window_s": 6.0}
    ctx = _ctx(a, [steady, traced], [work, work], trace, 1)
    dec = bench.read_metric("mla_decode_roofline.serve", ctx)
    least = sum(counts_mla.bound_s(*counts_mla.decode_attention(
        a, [p + s for p, n in zip(work["prompts"], work["answers"]) if n > s]))
        for s in range(1, 512))
    assert dec == pytest.approx(100 * least / 1.0)
    pre = bench.read_metric("mla_prefill_roofline.serve", ctx)
    flops, nbytes = counts_mla.prefill_attention(a, work["forwards"])
    assert pre == pytest.approx(100 * counts.bound_s(flops, nbytes) / 0.25)
    assert 0 < bench.read_metric("mla_moe_decode_roofline.serve", ctx) < 100
    assert 0 < bench.read_metric("mfu_mla.serve", ctx) < 100
    # a program without the MLA kernels or the counters: nothing to read
    bare = _ctx(a, [steady, dict(traced, counters={})], [work, work],
                dict(trace, kernel_s={}), 1)
    for name in ("mla_decode_roofline.serve", "mla_prefill_roofline.serve",
                 "mla_moe_decode_roofline.serve"):
        assert bench.read_metric(name, bare) is None


def test_the_new_sources_import_nothing_of_the_program():
    from test_portbench_imports import PROGRAM, imported_tops

    for name in ("reference/kimi_vl.py", "lib/kimi_arch.py", "lib/kimi_weights.py",
                 "lib/counts_mla.py", "lib/kimi_traffic.py", "lib/kimi_work.py"):
        assert PROGRAM not in imported_tops(BENCH_DIR / name), name
