"""Training/eval metrics bus.

Replaces the reference's ``_metrics`` defaultdict + wandb-offline plumbing
(grpo_trainer.py:332-333, 744-751): metrics accumulate between log steps,
average on flush, and fan out to sinks (stdout JSONL, wandb when available
and enabled). A copy of ``open_o3_video_tpu/utils/metrics.py``; wandb is
imported only when asked for.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Any, Optional


class MetricsBus:
    def __init__(self, log_path: Optional[str] = None, use_wandb: bool = False,
                 project: str = "video-llm-training", primary: bool = True):
        """``primary=False`` (non-zero process in a multi-host run) still
        accumulates/averages but writes to no sink — the analogue of HF
        Trainer's rank-0-only logging."""
        self._acc: dict[str, list[float]] = defaultdict(list)
        self._log_path = log_path
        self._primary = primary
        self._wandb = None
        if use_wandb and primary:
            try:
                os.environ.setdefault("WANDB_MODE", "offline")
                import wandb

                wandb.init(project=project)
                self._wandb = wandb
            except Exception:
                self._wandb = None

    def push(self, **values: float):
        for key, value in values.items():
            self._acc[key].append(float(value))

    def flush(self, step: int, extra: Optional[dict[str, Any]] = None) -> dict[str, float]:
        """Average accumulated metrics, emit to sinks, clear. Mirrors the
        reference's per-log-step averaging (grpo_trainer.py:744-751)."""
        out = {k: sum(v) / len(v) for k, v in self._acc.items() if v}
        if extra:
            out.update(extra)
        record = {"step": step, "time": time.time(), **out}
        if self._primary:
            line = json.dumps(record)
            print(line, flush=True)
            if self._log_path:
                with open(self._log_path, "a") as f:
                    f.write(line + "\n")
            if self._wandb is not None:
                self._wandb.log(out, step=step)
        self._acc.clear()
        return out
