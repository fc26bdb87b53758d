"""What the port's engine counts for a trace, on the CPU at tiny dims
(weights from ``params.init``, no JAX): the prompt tokens a call admits and
the tokens its prefill forwards compute (left padding, a reused prefix
block's tokens not counted), the decode loop's host ranges under
``torch.profiler`` and the host seconds it spends blocked, and the experts a
mixture model's decode steps read, counted only under a trace: equal to the
distinct experts of ``moe_route``'s routing, and with no profiler nothing
recorded and the decode step's operations those it runs with the recording
taken out."""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.engine import engine as E
from open_o3_video_tpu_torch.models.qwen25vl import config as TC
from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.models.qwen25vl import text as TT
from open_o3_video_tpu_torch.utils.profiling import tracing

GREEDY = SamplingParams(temperature=0.0, repetition_penalty=1.05, max_tokens=4)
CPU = torch.device("cpu")


def _engine(cfg, **kw) -> InferenceEngine:
    return InferenceEngine(TP.init(cfg, 0, CPU), cfg, cache_dtype=torch.float32,
                           prompt_buckets=(32, 64), **kw)


def _ids(seed, *lens):
    r = np.random.default_rng(seed)
    return [r.integers(5, 90, size=n).tolist() for n in lens]


class _Ops(TorchDispatchMode):
    """Appends the name of every aten operation it sees to ``log``."""

    def __init__(self, log: list):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.log.append(str(func))
        return func(*args, **(kwargs or {}))


def _profiled(fn):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert tracing()
        out = fn()
    assert not tracing()
    return out, [(e.name(), e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events() if e.name().startswith("engine.")]


def test_prompt_and_prefill_tokens_of_chunks_and_a_reused_prefix_block():
    """Left-padded rows in 16-token chunks count their real tokens only;
    a prefix family counts its block once (its second wave through the two
    slots finds the block: a hit), and a later call that finds the block
    in the LRU counts only its suffixes."""
    eng = _engine(TC.Qwen25VLConfig.tiny(), max_slots=2, prefill_chunk=16,
                  prefix_cache_min=8, suffix_buckets=(16,))
    plain = [Request(x) for x in _ids(1, 20, 37, 9)]
    eng.generate(plain, GREEDY)
    assert eng.counters["prompt_tokens"] == eng.counters["prefill_tokens"] == 20 + 37 + 9
    shared = _ids(2, 24)[0]
    fam = [Request(shared + t) for t in _ids(3, 3, 5, 2)]
    assert eng._detect_prefixes(fam) == [24] * 3
    eng.counters.clear()
    eng.generate(fam, GREEDY)
    assert eng.counters["prompt_tokens"] == 3 * 24 + 10
    assert eng.counters["prefill_tokens"] == 24 + 10
    assert eng.counters["prefix_blocks"] == eng.counters["prefix_hits"] == 1
    eng.counters.clear()
    eng.generate(fam[:2], GREEDY)
    assert eng.counters["prefill_tokens"] == 3 + 5 and eng.counters["prefix_hits"] == 1


def test_decode_phases_lie_inside_the_decode_stage():
    """Under the CPU profiler every launch, wait and readback range lies in
    an ``engine.decode`` range, the harvest and admission ranges are there,
    and the seconds blocked are part of the decode stage's."""
    eng = _engine(TC.Qwen25VLConfig.tiny(), max_slots=2, decode_segment=2)
    reqs = [Request(x) for x in _ids(4, 12, 20, 7)]
    _, ranges = _profiled(lambda: eng.generate(reqs, GREEDY))
    decode = [(s, e) for n, s, e in ranges if n == "engine.decode"]
    names = collections.Counter(n for n, _, _ in ranges)
    for phase in ("engine.decode.launch", "engine.decode.wait", "engine.decode.readback"):
        assert names[phase] > 0, phase
        for n, s, e in ranges:
            if n == phase:
                assert any(a <= s and e <= b for a, b in decode), (phase, s, e)
    assert names["engine.decode.launch"] == eng.decode_steps + eng.decode_steps_wasted
    assert names["engine.harvest"] == eng.counters["segments"] and names["engine.admit"] >= 2
    assert 0 < eng.stage_seconds["decode_wait"] <= eng.stage_seconds["decode"]
    assert "expert_reads" not in eng.counters  # a dense model counts none


def _moe_call(monkeypatch, traced: bool, steps: list):
    """A tiny MoE call of 3 requests through 2 slots; ``steps`` collects
    each decode step's aten operations."""
    eng = _engine(TC.tiny_qwen3_moe(), max_slots=2, decode_segment=3)
    step = eng._decode_step

    def logged(*a):
        steps.append([])
        with _Ops(steps[-1]):
            step(*a)

    monkeypatch.setattr(eng, "_decode_step", logged)
    reqs = [Request(x) for x in _ids(5, 10, 14, 6)]
    run = lambda: eng.generate(reqs, SamplingParams(temperature=0.0, max_tokens=5))
    return eng, (_profiled(run)[0] if traced else run())


def test_expert_reads_are_the_routings_distinct_experts_and_cost_nothing_untraced(monkeypatch):
    routed = []
    real = TT.moe_route

    def route(*a):
        idx, w = real(*a)
        if getattr(TT._ROUTES, "ring", None) is not None:  # a recorded decode step
            routed.append(idx)
        return idx, w

    monkeypatch.setattr(TT, "moe_route", route)
    off_steps, on_steps = [], []
    off, out_off = _moe_call(monkeypatch, False, off_steps)
    assert not routed and "expert_reads" not in off.counters
    on, out_on = _moe_call(monkeypatch, True, on_steps)
    assert out_on == out_off
    layers = TC.tiny_qwen3_moe().text.num_hidden_layers
    assert len(routed) == on.counters["moe_layer_steps"] == layers * len(on_steps)
    assert on.counters["expert_reads"] == sum(len(torch.unique(i)) for i in routed)
    # the recording, per MoE layer of a step, is its only difference
    ring = TT.RouteRing(1, 2, 2, 2, torch.zeros((), dtype=torch.long))
    idx, one = torch.zeros((2, 2), dtype=torch.long), []
    with _Ops(one):
        ring.add(idx, 4)
    assert any("index_copy_" in op for op in one)
    assert len(on_steps) == len(off_steps) > 0
    for a, b in zip(off_steps, on_steps):
        want = collections.Counter(a)
        for op, n in collections.Counter(one).items():
            want[op] += layers * n
        assert collections.Counter(b) == want


@pytest.mark.parametrize("local", [4, 2])
def test_distinct_experts_counts_this_ranks_experts(local):
    ids = np.array([[[[0, 1], [1, 3]], [[2, 2], [2, 2]]],
                    [[[3, 0], [0, 3]], [[1, 2], [3, 0]]]])  # (layers 2, steps 2, rows 2, k 2)
    want = {4: 3 + 1 + 2 + 4, 2: 2 + 0 + 1 + 2}[local]
    assert E._distinct_experts(ids, local) == want
