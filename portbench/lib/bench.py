"""What every run shares: the cell's files found by name, the per-layer
metrics' readers, the runner a mix names, the comparison with the cell's
limits, and the look for modules of JAX. The cell's configuration, traffic
mix, limits, per-layer metrics and runner are files of their own under
``portbench/``, found by the names in ``BENCHMARK.json``, so a new cell,
metric or kind of run is new files, never an edit here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path


BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# Top-level module names that no run may hold once its window has closed:
# JAX, and the JAX package the program was ported from.
FOREIGN = ("jax", "jaxlib", "flax", "open_o3_video_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, workload: str) -> dict:
    """The cell's entry, its configuration (as run), traffic mix and limits."""
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return {"cell": cell, "config": load_json(ROOT / conf["file"]),
            "mix": load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(BENCH_DIR / "limits" / f"{workload}.json")}


def foreign_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


def card() -> dict:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    return {"nvidia_smi": out[0] if out else "not read"}


class Context:
    """What a per-layer metric's reader reads: the cell, its shapes
    (``arch``), the window's calls and their records (stage seconds,
    counters), each call's work (``work.call_work``), and the traced call's
    index and summary (``trace.summarize``)."""

    def __init__(self, workload, arch, mix, calls, records, work, traced_index, trace):
        self.workload, self.arch, self.mix = workload, arch, mix
        self.calls, self.records, self.work = calls, records, work
        self.traced_index, self.trace = traced_index, trace

    def steady(self) -> list:
        """Indices of the window's calls (those that ran without the
        profiler)."""
        return [i for i in range(len(self.records)) if i != self.traced_index]


def read_metric(name: str, ctx: Context):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def cell_per_layer(bench: dict, workload: str) -> list:
    """The per-layer metrics the cell reports: those listing it."""
    return [m for m in bench["per_layer"] if workload in m["workloads"]]


def load_runner(name: str):
    """The runner module ``portbench/runners/<name>.py`` that a mix names:
    its ``run`` makes one run of a cell of that kind."""
    return importlib.import_module(f"portbench.runners.{name}")


def compare(limits: dict, checked: dict) -> dict:
    """Each number a cell's limits file gives a limit, with its value."""
    return {name: {"value": checked[name], "limit": lim["limit"]}
            for name, lim in limits.items() if lim.get("limit") is not None}
