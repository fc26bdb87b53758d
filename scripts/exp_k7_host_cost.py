"""Host time per K7 call (ops/int4.py:int4_matmul) at decode shapes, on one GPU.

    python3 scripts/exp_k7_host_cost.py [--root PATH]

Decode is host-bound (PERF.md section 5): each K7 call's Python wrapper,
ctypes call and launches cost host time that the device then waits for. This
times 200 back-to-back calls at each shape, five times: the host clock until
the last call returns (host us per call) and until the device has finished
(wall us per call), medians printed. ``--root`` imports the port from another
checkout (e.g. a parent commit unpacked beside this one), so two versions
can be timed in one run, in turns.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (M, K, N): the 7B q_w and k_w at the slice's batch of 2, the 72B gate_w at 4
SHAPES = ((2, 3584, 3584), (2, 3584, 512), (4, 8192, 29568))
CALLS, REPS = 200, 5


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO, help="import the port from this checkout")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from open_o3_video_tpu_torch.ops import int4 as i4
    from open_o3_video_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        raise SystemExit("exp_k7_host_cost: needs a CUDA device")
    dev = torch.device("cuda")
    kernels.library()
    print(f"port={kernels.PACKAGE_DIR}", flush=True)
    for M, K, N in SHAPES:
        w = i4.quantize_weight_int4(0.01 * torch.randn(K, N, device=dev))
        x = torch.randn(M, K, device=dev, dtype=torch.bfloat16)
        for _ in range(20):
            i4.int4_matmul(x, w.w_p, w.scale, w.group)
        torch.cuda.synchronize()
        host, wall = [], []
        for _ in range(REPS):
            t0 = time.perf_counter()
            for _ in range(CALLS):
                i4.int4_matmul(x, w.w_p, w.scale, w.group)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host.append(1e6 * (t1 - t0) / CALLS)
            wall.append(1e6 * (t2 - t0) / CALLS)
        print(f"[host] M={M} K={K} N={N} host_us_per_call={statistics.median(host):.1f} "
              f"wall_us_per_call={statistics.median(wall):.1f}", flush=True)


if __name__ == "__main__":
    main()
