"""Times the parts of the w8a8 product (``ops/quant.py`` ``dense`` under
``a8_acts``) on one GPU at the 7B's prefill shapes, beside the bf16 product
and the w8 product:

    python3 scripts/exp_int8_matmul_torch.py [--rows 2939 8192]

Per (rows, K, N): the bf16 matmul; ``torch._int_mm`` with the padded
weight row-major (a contiguous (K', N') tensor) and column-major (the
transpose of a contiguous (N', K') tensor, the layout ``QuantizedLinear``
stores in ``w_mm``); ``quant.quantize_acts``; the float32 epilogue; the
whole a8 ``dense``; the w8 ``dense``. CUDA events, median of
20 after 3 warm-ups, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from open_o3_video_tpu_torch.ops import quant  # noqa: E402

# (name, K, N) of the 7B's decoder and tower matmuls
SHAPES = (("q_w", 3584, 3584), ("gate_w", 3584, 18944), ("down_w", 18944, 3584),
          ("vit qkv_w", 1280, 3840), ("vit gate_w", 1280, 3420), ("vit down_w", 3420, 1280))


def ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[2939, 8192])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for M in args.rows:
        for name, K, N in SHAPES:
            x = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
            w = (0.02 * torch.randn(K, N, device=dev, generator=gen)).to(torch.bfloat16)
            qw = quant.quantize_weight(w)
            xq, sx = quant.quantize_acts(x)
            row = {"bf16": ms(lambda: x @ w)}
            Kp = qw.w_mm.shape[0]
            xp = torch.nn.functional.pad(xq, (0, Kp - K))
            w_row, w_col = qw.w_mm.contiguous(), qw.w_mm.t().contiguous().t()
            row["int_mm B row-major"] = ms(lambda: torch._int_mm(xp, w_row))
            row["int_mm B col-major"] = ms(lambda: torch._int_mm(xp, w_col))
            row["quantize_acts"] = ms(lambda: quant.quantize_acts(x))
            y = torch._int_mm(xp, w_col)[:, :N]
            row["epilogue"] = ms(lambda: (y * sx).mul_(qw.scale).to(x.dtype))
            with quant.a8_acts(True):
                row["a8 dense"] = ms(lambda: quant.dense(x, qw))
            row["w8 dense"] = ms(lambda: quant.dense(x, qw))
            tops = 2 * M * K * N / 1e9
            print(f"[int8] M={M} {name} K={K} N={N} "
                  + " ".join(f"{k}={v:.4f}ms" for k, v in row.items())
                  + f" int_mm_row_TOPS={tops / row['int_mm B row-major']:.1f}"
                  + f" int_mm_col_TOPS={tops / row['int_mm B col-major']:.1f}"
                  + f" bf16_TFLOPS={tops / row['bf16']:.1f}", flush=True)


if __name__ == "__main__":
    main()
