"""K2 and K7's decode plans, timed against their yardsticks on one GPU.

    python3 scripts/exp_k2_k7_plans.py

K2 (csrc/window_attention.cu, both modes) at the slice's 16 frames of 18x24
patches (W = 448, K/V resident) and of 32x32 patches (W = 1024, streamed),
16 heads of 80, against SDPA with the boolean segment mask.

K7's decode route (csrc/int4_matmul.cu) at the decode shapes of the 7B and
72B models and the K7a probes' shape: the plan of ops/int4.py:decode_plan
aiming at 1, 2 (the default) and 4 CTAs per SM, and one split of 128-column
tiles (the grid before split-K), against torch._weight_int4pack_mm on the
same codes and the bf16 matmul on the dequantized weight.

Each time is chip_smoke.py's time_ms (CUDA events, median of 20, a spin
queued first); each output is held to its plain version with chip_smoke's
bound. Prints one line per case.
"""

from __future__ import annotations

import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from open_o3_video_tpu_torch.models.qwen25vl import Qwen25VLConfig  # noqa: E402
from open_o3_video_tpu_torch.ops import int4 as i4  # noqa: E402
from open_o3_video_tpu_torch.ops import kernels  # noqa: E402
from open_o3_video_tpu_torch.ops import window_attention as wa  # noqa: E402

# (M, K, N) of the decode matmuls (q/o share q_w's shape, v_w k_w's, up_w
# gate_w's), and the probes' shape
K7_SHAPES = {
    "7B k_w": (2, 3584, 512), "7B q_w": (2, 3584, 3584), "7B gate_w": (2, 3584, 18944),
    "7B down_w": (2, 18944, 3584), "7B lm_head": (2, 3584, 152064),
    "72B k_w": (4, 8192, 1024), "72B q_w": (4, 8192, 8192), "72B gate_w": (4, 8192, 29568),
    "72B down_w": (4, 29568, 8192), "probe": (cs.PROBE_M, cs.PROBE_K, cs.PROBE_N),
}


def median_ms(fn) -> float:
    return statistics.median(cs.time_ms(fn))


def k2_cases(dev, gen) -> None:
    for grid_hw in cs.K2_FRAME_GRIDS:
        ids, q, k, vv, _ = cs.frame_inputs(dev, gen, Qwen25VLConfig().vision, grid_hw)
        n, w = ids.shape
        seg = cs.segment_mask(ids)
        keep = ids != 0
        lib = median_ms(lambda: cs.sdpa_masked(q, k, vv, seg))
        for name, call, plain in (
                ("window_attention", lambda: wa.window_attention(q, k, vv, ids),
                 lambda: wa.window_attention_torch(q, k, vv, ids)),
                ("window_attention_exact", lambda: wa.window_attention_exact(q, k, vv, ids)[0],
                 lambda: wa.window_attention_exact_torch(q, k, vv, ids)[0])):
            ok = cs.agreement(call(), plain(), keep)["ok"]
            print(f"[k2] {name} W={w} frames={n} ms={median_ms(call):.4f} sdpa_ms={lib:.4f} "
                  f"agrees={ok}", flush=True)
        del q, k, vv
        torch.cuda.empty_cache()


def k7_plans(sms: int) -> dict:
    """name -> a function (M, K, N) -> (block_n, splits)."""
    def aiming(per_sm):
        return lambda M, K, N: i4.decode_plan(M, K, N, sms * per_sm // i4.DECODE_CTAS_PER_SM)

    return {"one_split_128": lambda M, K, N: (128, 1), "per_sm_1": aiming(1),
            "per_sm_2": aiming(2), "per_sm_4": aiming(4)}


def k7_cases(dev, gen) -> None:
    plans = k7_plans(i4.sm_count(dev.index or 0))
    for case, (M, K, N) in K7_SHAPES.items():
        x, w = cs.int4_case(dev, gen, M, K, N)
        ref = i4.int4_matmul_torch(x, w.w_p, w.scale, w.group)
        wd = i4.dequantize(w, torch.bfloat16)
        bf16_ms = median_ms(lambda: torch.matmul(x, wd))
        del wd
        pack, note = cs.int4pack_yardstick(x, w)
        pack_ms = median_ms(pack) if pack is not None else None
        del pack
        bound, _ = cs.bound_ms(2 * M * K * N, K * N // 2 + 4 * N * K // 128 + 2 * M * K + 2 * M * N)
        for plan, fn in plans.items():
            block_n, splits = fn(M, K, N)
            out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
            ws = torch.empty((splits, M, N), dtype=torch.float32, device=dev)
            counters = torch.zeros(N // block_n, dtype=torch.int32, device=dev)

            def call(out=out, ws=ws, counters=counters, block_n=block_n, splits=splits):
                kernels.launch("int4_matmul", x.data_ptr(), w.w_p.data_ptr(), w.scale.data_ptr(),
                               out.data_ptr(), ws.data_ptr(), counters.data_ptr(), M, K, N,
                               w.group, block_n, splits)

            call()
            torch.cuda.synchronize()
            ok = cs.agreement(out, ref, None)["ok"]
            print(f"[k7] {case} M={M} K={K} N={N} plan={plan} block_n={block_n} splits={splits} "
                  f"ctas={N // block_n * splits} ms={median_ms(call):.4f} bound_ms={bound:.4f} "
                  f"int4pack_ms={pack_ms if pack_ms is None else round(pack_ms, 4)} ({note}) "
                  f"bf16_ms={bf16_ms:.4f} agrees={ok}", flush=True)
        del x, w, ref
        torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("exp_k2_k7_plans: needs a CUDA device")
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k2_cases(dev, gen)
    k7_cases(dev, gen)


if __name__ == "__main__":
    main()
