"""What the benchmark loads: no module of JAX or of the JAX package the
program was ported from, anywhere (top-level names compared whole, since
the program's name begins with the JAX package's), and nothing of the
program in the reference."""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FOREIGN = {"jax", "jaxlib", "flax", "open_o3_video_tpu"}
PROGRAM = "open_o3_video_tpu_torch"


def imported_tops(path: Path) -> set:
    """Top-level names of the absolute imports in a file (relative imports
    stay inside portbench)."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        assert not imported_tops(path) & FOREIGN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in [*(BENCH_DIR / "reference").glob("*.py"), BENCH_DIR / "lib" / "arch.py",
                 BENCH_DIR / "lib" / "weights.py"]:
        assert PROGRAM not in imported_tops(path), path


def run_python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_the_reference_loads_no_module_of_the_program_or_of_jax():
    out = run_python(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        import portbench.reference.qwen_vl, portbench.reference.inputs, portbench.lib.weights
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """)
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert not loaded & (FOREIGN | {PROGRAM})


def test_a_run_loads_no_module_of_jax_with_jax_installed_beside_it():
    """A tiny run on the CPU with imports of JAX refused, as the card's
    machine (which has JAX) must never need it; then the run's own check."""
    out = run_python(f"""
        import sys, time, importlib.abc
        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {sorted(FOREIGN)!r}:
                    raise ImportError("refused: " + name)
        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {str(ROOT)!r})
        sys.path.insert(0, {str(BENCH_DIR / "tests")!r})
        import torch
        from portbench.lib import bench
        from portbench.runners import serve
        import tiny
        files = {{"config": tiny.qwen25(), "mix": tiny.mix("vstar"),
                  "limits": {{"gap_max": {{"limit": 1.0}}}}}}
        r = serve.run("vstar.qwen25vl-7b", files, [], 5, 0.01, False,
                            torch.device("cpu"), time.perf_counter())
        print(r["correct"], bench.foreign_modules())
    """)
    assert out.strip().splitlines()[-1] == "True []"
