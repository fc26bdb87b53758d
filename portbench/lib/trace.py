"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over one call
or step of the window, reduced in memory to kernel time by name, the union
of the kernels' intervals on the device, and the device's idle gaps by the
host range (``engine.*`` from the program, ``bench.*`` from the harness)
that was open while the device waited. Nothing is written to disk.

The interval union is ``scripts/profile_slice_torch.py``'s reading of a
trace (busy = time some kernel ran), frozen here over the profiler's events
instead of its Chrome trace.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch


# Names of ranges, not operations: the host's annotations, which the
# profiler also lays on the device's timeline.
RANGES = ("engine.", "bench.", "ProfilerStep")


def _intervals(prof):
    """(device operations [(name, start_us, end_us)]: kernels, copies and
    sets; host ranges [(name, start_us, end_us)]), read from the profiler's
    raw events (building its per-event Python objects would take minutes
    over the ~10^6 kernels of a call)."""
    ops, ranges = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        span = (name, e.start_ns() / 1e3, e.end_ns() / 1e3)
        if name.startswith(RANGES):
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                ranges.append(span)
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            ops.append(span)
    return ops, ranges


def union(starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The merged intervals [start, end) of the spans, sorted."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    first = np.ones(len(s), dtype=bool)
    first[1:] = s[1:] > np.maximum.accumulate(e)[:-1]
    at = np.flatnonzero(first)
    return s[at], np.maximum.reduceat(e, at)


def gaps_by_range(gap_s: np.ndarray, gap_e: np.ndarray, ranges) -> collections.Counter:
    """Seconds of device idle gaps by the innermost host range open at each
    gap's middle ("host" where none is): ranges laid down longest first,
    so a shorter one inside overwrites it."""
    mid = (gap_s + gap_e) / 2
    order = np.argsort(mid)
    mid, dur = mid[order], (gap_e - gap_s)[order]
    label = np.full(len(mid), -1)
    ranges = sorted(ranges, key=lambda r: r[1] - r[2])
    for i, (_, s, e) in enumerate(ranges):
        lo, hi = np.searchsorted(mid, [s, e])
        label[lo:hi] = i
    out: collections.Counter = collections.Counter()
    for i in np.unique(label):
        out[ranges[i][0] if i >= 0 else "host"] += float(dur[label == i].sum()) * 1e-6
    return out


def summarize(prof, wall_s: float) -> dict:
    ops, ranges = _intervals(prof)
    by_name: collections.Counter = collections.Counter()
    for name, s, e in ops:
        by_name[name] += (e - s) * 1e-6
    starts = np.array([s for _, s, _ in ops], dtype=np.float64)
    ends = np.array([e for _, _, e in ops], dtype=np.float64)
    bs, be = union(starts, ends) if len(ops) else (starts, ends)
    gaps: collections.Counter = collections.Counter()
    if ranges and len(bs):
        lo, hi = min(s for _, s, _ in ranges), max(e for _, _, e in ranges)
        gap_s = np.concatenate([[lo], be])
        gap_e = np.concatenate([bs, [hi]])
        keep = gap_e > gap_s
        gaps = gaps_by_range(gap_s[keep], gap_e[keep], ranges)
    return {"busy_s": float((be - bs).sum()) * 1e-6, "window_s": wall_s,
            "kernel_s": dict(by_name), "ops": len(ops),
            "device_ops": [[n, s] for n, s in by_name.most_common(10)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(10)]}


def traced(fn):
    """``fn()`` under the profiler; returns (its result, the profiler, the
    wall seconds of the call). ``summarize`` them once the window has
    closed."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, prof, wall


def kernel_seconds(summary: dict, marks) -> float:
    """Device seconds of the kernels whose names hold any of ``marks``."""
    return sum(s for n, s in summary["kernel_s"].items() if any(m in n for m in marks))
