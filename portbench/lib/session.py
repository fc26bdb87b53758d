"""One run of a serving cell, with the cell's pieces given: its arch
reader, weight maker, program, traffic, work and check. The loop is
``runners/serve.py``'s (weights and traffic from the seed, a warm-up call
at the cell's shapes, the closed loop of whole calls for the window, with
``--trace 1`` one more call under the profiler, then the check of a sample
of the answers against the plain reference), for the runners whose cells
need other pieces than the Qwen cells'."""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable

import torch

from . import bench
from .trace import summarize, traced


@dataclasses.dataclass(frozen=True)
class Pieces:
    read_arch: Callable
    make_weights: Callable
    program: Callable  # (config, mix, weights) -> a ServeProgram
    make_call: Callable  # (mix, arch, seed, index) -> a call
    call_work: Callable  # (call, answers, arch) -> work.call_work's dict
    check: Callable  # serve_check.check's signature
    check_call: Callable = lambda call, arch: None  # raises on a call the cell must not make


def run(pieces: Pieces, workload: str, files: dict, metrics: list, seed: int, seconds: float,
        trace: bool, device, t_start: float, judge: str | None = None) -> dict:
    config, mix, limits = files["config"], files["mix"], files["limits"]
    arch = pieces.read_arch(config)

    def make_call(index):
        call = pieces.make_call(mix, arch, seed, index)
        pieces.check_call(call, arch)
        return call

    marks = {"imports": time.perf_counter() - t_start}
    weights = pieces.make_weights(arch, seed, device)
    prog = pieces.program(config, mix, weights)
    del weights
    marks["weights_and_program"] = time.perf_counter() - t_start
    prog.call(make_call(-1), max_tokens=mix["warmup_tokens"])
    marks["warm_up"] = time.perf_counter() - t_start
    calls = [make_call(i) for i in range(mix["calls_made_in_setup"])]
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    records = []
    while time.perf_counter() - t0 < seconds:
        if len(records) >= len(calls):
            calls.append(make_call(len(records)))
        records.append(prog.call(calls[len(records)]))
    window_s = time.perf_counter() - t0
    calls = calls[:len(records)]
    summary, traced_index = None, None
    if trace:  # one more call, under the profiler, after the window
        calls.append(make_call(len(records)))
        rec, prof, wall = traced(lambda: prog.call(calls[-1]))
        records.append(rec)
        traced_index = len(records) - 1
        summary = summarize(prof, wall)
        del prof
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    attempted = sum(len(r["tokens"]) for r in records[:len(records) - bool(trace)])
    failed = sum(1 for r in records for t in r["tokens"] if not t)
    ctx = bench.Context(workload, arch, mix, calls, records,
                        [pieces.call_work(c, r["tokens"], arch) for c, r in zip(calls, records)],
                        traced_index, summary)
    prog.close()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if trace:
        out = {m["name"]: {"value": v, "unit": m["unit"]}
               for m in metrics if (v := bench.read_metric(m["name"], ctx)) is not None}
    else:
        out = {"answers_per_s": {"value": attempted / window_s, "unit": "answers/s"},
               "setup_s": {"value": setup_s, "unit": "s"}}
    t_check = time.perf_counter()
    checked = pieces.check(arch, mix, seed, calls, records, device, judge)
    checked["seconds"] = time.perf_counter() - t_check
    checks = bench.compare(limits, checked)
    correct = (bool(checks) and failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    return {"correct": correct, "attempted": attempted, "failed": failed, "metrics": out,
            "peak": peak, "summary": summary, "window_s": window_s, "setup_s": setup_s,
            "calls": len(records), "check": checked, "checks": checks, "setup_marks": marks,
            "call_seconds": [r["seconds"] for r in records],
            "stages": [r["stages"] for r in records],
            "counters": [r["counters"] for r in records]}
