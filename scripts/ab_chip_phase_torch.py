"""One phase of chip_smoke.py in several checkouts, one after another, on one GPU.

    python3 scripts/ab_chip_phase_torch.py --phase vstar|sched|spec|frames|a8|families|train_families|moe_families|train_moe_families|mesh|train_mesh \
        DIR [DIR ...]

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
  held to a plain run of its own instead of run (a)'s tokens;
- ``frames``: phase 19a (``frames_phase``), the uint8 frame path;
- ``a8``: phases 19b and 19c (``quant_phase``, ``quant_long_phase``), the
  quantized modes and w8a8 at run (b)'s length;
- ``families``: phase 20 (``families_phase``), K2 at head_dim 72, then
  Qwen3-VL-8B and Qwen2-VL-7B served from their published configs (the 7B
  drawn first stays resident, as in the whole script);
- ``train_families``: phase 21 (``training_families_phase``), K2's exact
  mode and K6 at head_dim 72, then the training of Qwen3-VL-8B (full
  fine-tune, PEFT, GSPO) and Qwen2-VL-7B (the 7B released first, as in the
  whole script);
- ``moe_families``: phase 22 (``moe_families_phase``), Qwen3-VL-30B-A3B and
  Aria served from their published configs (the 7B released first, as in
  the whole script).
- ``train_moe_families``: phase 23 (``train_moe_families_phase``), the
  training of Qwen3-VL-30B-A3B and Aria (PEFT at full width and depth, a
  full fine-tune at a cut; the 7B released first, as in the whole script).

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
    "frames": "c.frames_phase(params, cfg, c.O3VideoProcessor(), seed)",
    "a8": ("c.quant_phase(params, cfg, c.O3VideoProcessor(), seed); "
           "c.quant_long_phase(params, cfg, seed)"),
    "families": "c.families_phase(torch.device('cuda'), seed, {})",
    "train_families": ("del params; c.gc.collect(); torch.cuda.empty_cache(); "
                       "c.training_families_phase(torch.device('cuda'), seed, {})"),
    "moe_families": ("del params; c.gc.collect(); torch.cuda.empty_cache(); "
                     "c.moe_families_phase(torch.device('cuda'), seed, {})"),
    "train_moe_families": ("del params; c.gc.collect(); torch.cuda.empty_cache(); "
                           "c.train_moe_families_phase(torch.device('cuda'), seed, {})"),
    "mesh": ("del params; c.gc.collect(); torch.cuda.empty_cache(); "
             "c.mesh_phase(torch.device('cuda'), seed, {})"),
    "train_mesh": ("del params; c.gc.collect(); torch.cuda.empty_cache(); "
                   "c.train_mesh_phase(torch.device('cuda'), seed, {})"),
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
    for d in (c.EVAL_DIR, getattr(c, "FRAMES_DIR", c.EVAL_DIR)):
        shutil.rmtree(d, ignore_errors=True)
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
