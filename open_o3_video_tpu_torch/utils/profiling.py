"""Per-stage wall clock (counterpart of ``open_o3_video_tpu/utils/profiling.py``,
whose trace annotations are ``jax.profiler``'s).

``StageTimer`` has the JAX one's API and its exclusive accounting (a parent
stage's total leaves out the time of the stages opened inside it). A stage
is wall time bounded by ``torch.cuda.synchronize`` on both ends when a CUDA
device is given, so it covers the stage's device work, and it is a
``torch.profiler.record_function`` range (``stage.<name>``) in a trace, as
the engine's ``_stage`` is.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Optional

import torch


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
