"""The readers of the engine's scheduler and decode-loop counters against
values worked out by hand on a synthetic context: the prefix blocks' share
of the prompt tokens, the host's milliseconds a decode step, the idle
milliseconds a step under the decode ranges, and the 30B's decode
roofline at the experts a step read. On a program without those counters
(the records of an older engine) each reads nothing."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench.lib import bench, counts
from portbench.lib.arch import read_arch

BENCH_DIR = Path(__file__).resolve().parents[1]
A30 = read_arch(json.loads((BENCH_DIR / "configs" / "qwen3vl-30b-a3b.json").read_text()))
NAMES = ("prefix_hit_share.serve", "decode_host_ms_per_step.serve",
         "decode_idle_ms_per_step.serve", "moe_decode_roofline.serve")


def _context(counted: bool) -> bench.Context:
    """Two steady calls and a traced third; ``counted``: with the counters
    and stage the readers read."""
    def rec(stages, counters, steps):
        if not counted:
            stages = {k: v for k, v in stages.items() if k != "decode_wait"}
            counters = {}
        return {"stages": stages, "counters": counters, "decode_steps": steps}

    records = [rec({"decode": 2.0, "decode_wait": 1.5, "decode_capture": 0.1},
                   {"prompt_tokens": 100, "prefill_tokens": 60}, 100),
               rec({"decode": 3.0, "decode_wait": 2.6, "decode_capture": 0.2},
                   {"prompt_tokens": 200, "prefill_tokens": 140}, 100),
               rec({"decode": 9.0, "decode_wait": 1.0},
                   {"prompt_tokens": 50, "prefill_tokens": 50, "expert_reads": 48 * 10 * 32,
                    "moe_layer_steps": 48 * 10}, 100)]
    work = [{"prompts": [10, 20], "answers": [3, 2]}, {"prompts": [5], "answers": [1]},
            {"prompts": [7], "answers": [9]}]
    trace = {"busy_s": 1.0, "window_s": 2.0,
             "idle_gaps": [["host", 1.0], ["engine.decode_capture", 0.5],
                           ["engine.decode.wait", 0.3], ["engine.harvest", 0.2],
                           ["engine.decode", 0.1]]}
    return bench.Context("serve.qwen3vl-30b-a3b", A30, {}, [{}] * 3, records, work, 2, trace)


def test_readers_give_the_hand_counts():
    ctx = _context(True)
    read = {n: bench.read_metric(n, ctx) for n in NAMES}
    # (300 - 200) of 300 prompt tokens served by blocks
    assert read["prefix_hit_share.serve"] == pytest.approx(100 / 3)
    # (2.0 - 1.5 - 0.1) + (3.0 - 2.6 - 0.2) seconds over 200 steps
    assert read["decode_host_ms_per_step.serve"] == pytest.approx(3.0)
    # 0.3 + 0.1 s of idle under the decode ranges over 100 steps
    assert read["decode_idle_ms_per_step.serve"] == pytest.approx(4.0)
    # 32 of 128 experts a layer and step: 96 left unread in each of 48
    # layers, each 3 x 2048 x 768 bf16; steps 1 and 2 of the first call
    # read rows of 11 and 21, then 12 tokens of keys and values; the second
    # call has no step after its first token
    weights = counts.text_weight_bytes(A30) - 2 * 48 * 96 * 3 * 2048 * 768
    least = (2 * weights + counts.kv_bytes_per_token(A30) * (11 + 21 + 12)) / 3.35e12
    assert read["moe_decode_roofline.serve"] == pytest.approx(100 * least / 5.0)


def test_readers_read_nothing_without_the_counters():
    ctx = _context(False)
    assert bench.read_metric("prefix_hit_share.serve", ctx) is None
    assert bench.read_metric("decode_host_ms_per_step.serve", ctx) is None
    assert bench.read_metric("moe_decode_roofline.serve", ctx) is None
    ctx.trace = None
    assert bench.read_metric("decode_idle_ms_per_step.serve", ctx) is None
