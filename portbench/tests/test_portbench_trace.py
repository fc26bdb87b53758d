"""The reading of a profiler trace on a toy one: kernel time by name, the
union of the device's intervals, and idle gaps by the host range open."""

from __future__ import annotations

import types

import torch

from portbench.lib import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def event(name, start_us, end_us, device):
    return types.SimpleNamespace(name=lambda: name, start_ns=lambda: start_us * 1000,
                                 end_ns=lambda: end_us * 1000, device_type=lambda: device)


def profiler(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def test_busy_union_ops_and_gaps():
    prof = profiler([
        event("engine.decode", 0, 100, CPU), event("engine.decode_capture", 10, 20, CPU),
        event("engine.decode", 0, 100, CUDA),  # the range on the device's timeline: not an op
        event("k1", 5, 12, CUDA), event("k2", 11, 15, CUDA), event("k3", 30, 40, CUDA),
        event("k3", 85, 90, CUDA)])
    s = trace.summarize(prof, 1e-4)
    assert abs(s["busy_s"] - 25e-6) < 1e-12  # [5, 15), [30, 40), [85, 90)
    assert s["ops"] == 4 and s["device_ops"][0][0] == "k3"
    assert abs(s["kernel_s"]["k3"] - 15e-6) < 1e-12
    gaps = dict(s["idle_gaps"])
    assert set(gaps) == {"engine.decode"} and abs(gaps["engine.decode"] - 75e-6) < 1e-12
    assert abs(trace.kernel_seconds(s, ("k1", "k2")) - 11e-6) < 1e-12


def test_innermost_range_takes_the_gap():
    prof = profiler([event("engine.decode", 0, 100, CPU),
                     event("engine.decode_capture", 10, 30, CPU),
                     event("k", 0, 12, CUDA), event("k", 28, 100, CUDA)])
    assert dict(trace.summarize(prof, 1e-4)["idle_gaps"]) == {"engine.decode_capture": 16e-6}
