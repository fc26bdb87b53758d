"""Runs one cell of the benchmark once and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
                             [--judge fp8]

From the root of a checkout with the program (``open_o3_video_tpu_torch``)
beside ``portbench/``, on a machine with the CUDA cards the cell asks for.
It makes the weights and the traffic from ``--seed``, warms up the cell's
shapes, runs the closed loop of calls for ``--seconds`` (whole calls: the
window ends when the last call it started returns), checks a sample of the
answers against the plain float32 reference, and prints, as the last line
of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` (each number compared, with its limit), last.
The numbers compared are also the last lines of standard error.
``--judge fp8`` puts the check's control in the program's place (the
reference computed in float8 e4m3), which must come out not correct.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--judge", choices=("fp8",), default=None)
    args = ap.parse_args(argv)
    # The program's build and kernel caches stay inside the checkout.
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".cache" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".cache" / "triton"))

    import torch

    from portbench.lib import bench

    spec = bench.load_json(ROOT / "BENCHMARK.json")
    files = bench.cell_files(spec, args.workload)
    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    runner = bench.load_runner(files["mix"]["runner"])
    metrics = bench.cell_per_layer(spec, args.workload)
    r = runner.run(args.workload, files, metrics, args.seed, args.seconds, bool(args.trace), dev,
                   T_START, judge=args.judge)
    card = bench.card()  # after the run, so that set-up does not wait for nvidia-smi
    foreign = bench.foreign_modules()
    if foreign:
        print(f"portbench: modules of JAX or the JAX package were loaded: {foreign}",
              file=sys.stderr)
        return 3
    print(json.dumps({"card": card, "calls": r["calls"], "window_s": r["window_s"],
                      "setup_s": r["setup_s"], "setup_marks": r["setup_marks"],
                      "call_seconds": r["call_seconds"],
                      "stages": r["stages"], "counters": r["counters"],
                      "peak_gib": r["peak"] / 2**30, "check": r["check"],
                      "judge": args.judge}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
              "memory_peak_bytes": int(r["peak"])}
    line = {"correct": r["correct"], "attempted": r["attempted"], "failed": r["failed"],
            "metrics": r["metrics"], "device": device}
    if args.trace:
        s = r["summary"]
        device.update(busy_s=s["busy_s"], window_s=s["window_s"])
        line["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    line["checks"] = r["checks"]
    for name, c in r["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
