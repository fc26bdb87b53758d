"""Per-stage wall clock and profiler traces (counterpart of
``open_o3_video_tpu/utils/profiling.py``, whose annotations and traces are
``jax.profiler``'s).

``StageTimer`` has the JAX one's API and its exclusive accounting (a parent
stage's total leaves out the time of the stages opened inside it). A stage
is wall time bounded by ``torch.cuda.synchronize`` on both ends when a CUDA
device is given, so it covers the stage's device work, and it is a
``torch.profiler.record_function`` range (``stage.<name>``) in a trace, as
the engine's ``_stage`` is.

``tracing()`` says whether a ``torch.profiler`` trace records this
thread: what the program counts only under a trace (the engine's expert
reads) asks it. ``trace_annotation(name)`` is a ``record_function``
range; ``start_trace`` and ``stop_trace`` run one
``torch.profiler.profile`` over the CPU and, when there is one, the CUDA
device, and write its Chrome trace (Perfetto opens it) into the log
directory. One trace runs at a time: a second
``start_trace`` raises, as ``jax.profiler.start_trace`` does.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from collections import defaultdict
from typing import Optional

import torch


def tracing() -> bool:
    """Whether a profiler trace (``torch.profiler.profile``, or
    ``start_trace``) records the calling thread's ranges now."""
    return torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def trace_annotation(name: str):
    """Name a region in a profiler trace (a ``record_function`` range;
    next to no cost when no trace runs)."""
    with torch.profiler.record_function(name):
        yield


_trace_lock = threading.Lock()
_trace: dict = {}  # the running trace: its profiler and log directory


def start_trace(log_dir: str) -> None:
    """Start a profiler trace over the CPU and the CUDA device, if any,
    written into ``log_dir`` by ``stop_trace``. Raises RuntimeError while
    another trace runs."""
    with _trace_lock:
        if _trace:
            raise RuntimeError(f"a trace into {_trace['log_dir']} is already running; "
                               "stop_trace() it first")
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        _trace.update(prof=prof, log_dir=log_dir)


def stop_trace() -> str:
    """Stop the running trace and write it into its log directory as
    ``<host>.<pid>.<ms>.pt.trace.json``; returns the file's path. Raises
    RuntimeError when no trace runs."""
    with _trace_lock:
        if not _trace:
            raise RuntimeError("no trace is running; start_trace() first")
        prof, log_dir = _trace.pop("prof"), _trace.pop("log_dir")
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{socket.gethostname()}.{os.getpid()}."
                                     f"{int(time.time() * 1e3)}.pt.trace.json")
        prof.export_chrome_trace(path)
        return path


class StageTimer:
    """Accumulates wall time by stage; ``report()`` returns {stage:
    {total_s, count, mean_ms}}."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self._total = defaultdict(float)
        self._count = defaultdict(int)
        self._child = [0.0]  # per-open-stage accumulated child time

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        self._child.append(0.0)
        try:
            with torch.profiler.record_function(f"stage.{name}"):
                yield
                self._sync()
        finally:
            dt = time.perf_counter() - t0
            child = self._child.pop()
            self._total[name] += dt - child
            self._count[name] += 1
            self._child[-1] += dt

    def report(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_s": round(self._total[name], 4),
                "count": self._count[name],
                "mean_ms": round(1000 * self._total[name] / max(1, self._count[name]), 2),
            }
            for name in self._total
        }

    def reset(self):
        self._total.clear()
        self._count.clear()
        self._child = [0.0]
