"""One phase of chip_smoke.py in several checkouts, one after another, on one GPU.

    python3 scripts/ab_chip_phase_torch.py --phase vstar|sched|spec DIR [DIR ...]

Compares two commits on the same card within one run: unpack the parent
(``git archive``) into a directory that ``.gitignore`` lists and pass it
with this checkout as ``PARENT . . PARENT``. For each DIR in order, a
process started in DIR imports that checkout's own ``chip_smoke.py``,
builds its kernels, draws the 7B's random weights from ``--seed`` and runs
one phase:

- ``vstar``: phase 16a's V-STAR step (``vstar_phase``: 3 items, 2 engine
  calls of 5 queries, graphed, then eagerly), whose ``[eval]`` line gives
  the seconds and stage seconds of each engine call;
- ``sched``: phase 17 (``scheduler_phase``), in checkouts that have it;
- ``spec``: phase 18 (``spec_phase``), in checkouts that have it, with 18c
  held to a plain run of its own instead of run (a)'s tokens.

Each process's output goes to this one's standard output after a line
``tree DIR``; the exit code is the first nonzero one of the processes.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

PHASE = {
    "vstar": "c.vstar_phase(params, cfg, c.eval_data(seed))",
    "sched": "c.scheduler_phase(params, cfg, c.O3VideoProcessor(), seed)",
    "spec": ("c.spec_phase(params, cfg, c.make_requests(c.O3VideoProcessor(), cfg, seed), "
             "c.O3VideoProcessor(), None, seed, {})"),
}

CHILD = """
import os, shutil, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
seed = {seed}
c.kernels.library()
cfg = c.Qwen25VLConfig()
params = c.P.init(cfg, seed, torch.device("cuda"))
try:
    {call}
finally:
    shutil.rmtree(c.EVAL_DIR, ignore_errors=True)
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", choices=sorted(PHASE), required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("trees", nargs="+", help="checkouts, each holding chip_smoke.py")
    args = ap.parse_args()
    code = CHILD.format(seed=args.seed, call=PHASE[args.phase])
    rc = 0
    for tree in args.trees:
        print(f"tree {os.path.abspath(tree)}", flush=True)
        done = subprocess.run([sys.executable, "-c", code], cwd=tree)
        print(f"tree {os.path.abspath(tree)} rc={done.returncode}", flush=True)
        rc = rc or done.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
