"""Where K7's wgmma route (csrc/int4_matmul_sm90.cu) loses time, on one GPU.

    python3 scripts/exp_int4_wgmma_variants.py

Builds the kernel as it is and three variants of its source, each into its
own library under open_o3_video_tpu_torch/_build/variants/, and times each
(CUDA events, chip_smoke.py's time_ms) at the 7B prefill gate_w (M = 5878,
3584 -> 18944) and the 72B prefill down_w (M = 3984, 29568 -> 8192):

- kernel: the source as committed;
- no_conversion: the producers skip the nibble conversion (the output is
  wrong; the time is the pipeline's without the conversion's work);
- no_scale_add: the consumers skip the per-group scale-and-add into the
  sum (wrong output likewise);
- one_producer: one producer warpgroup instead of two (registers 128/184);
- three_and_three: 3 loaded and 3 converted stages instead of 4 and 2.

Prints, per variant and shape, ms, TFLOP/s and whether the output agrees
with K7's plain version (chip_smoke.py's bound).
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from open_o3_video_tpu_torch.ops import int4 as i4  # noqa: E402
from open_o3_video_tpu_torch.ops import kernels  # noqa: E402

SOURCE = os.path.join(REPO, "open_o3_video_tpu_torch", "csrc", "int4_matmul_sm90.cu")
OUT = os.path.join(REPO, "open_o3_video_tpu_torch", "_build", "variants")
SHAPES = ((5878, 3584, 18944), (3984, 29568, 8192))
CONVERT = "      convert_stage(gbase + (wsm(r) - base), gbase + (bs(b) - base), pt);\n"
SCALE_ADD = ("#pragma unroll\n      for (int nt = 0; nt < 16; ++nt) {\n        const float2 v",
             "      mbar_arrive(empty(r));")


def variants(src: str) -> dict[str, str]:
    def sub(text, old, new):
        if old not in text:
            raise SystemExit(f"the source no longer holds {old!r}")
        return text.replace(old, new)

    one = sub(sub(src, "constexpr int kProducers = 2;", "constexpr int kProducers = 1;"),
              "kProducerRegs = 64, kConsumerRegs = 192;", "kProducerRegs = 128, kConsumerRegs = 184;")
    three = sub(sub(src, "constexpr int kRawStages = 4;", "constexpr int kRawStages = 3;"),
                "constexpr int kBStages = 2;", "constexpr int kBStages = 3;")
    a = src.index(SCALE_ADD[0])
    no_scale_add = src[:a] + src[src.index(SCALE_ADD[1], a):]
    return {"kernel": src, "no_conversion": sub(src, CONVERT, ""), "no_scale_add": no_scale_add,
            "one_producer": one, "three_and_three": three}


def build(srcs: dict[str, str]) -> dict:
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for name, src in srcs.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", os.path.join(OUT, f"{name}.so"), path]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in jobs.items():
        log = proc.communicate()[0]
        spills = [line.strip() for line in log.splitlines() if "spill" in line]
        print(f"[build] {name} rc={proc.returncode} {spills}", flush=True)
        if proc.returncode:
            raise SystemExit(log[-4000:])
        fn = ctypes.CDLL(os.path.join(OUT, f"{name}.so")).o3v_int4_matmul_wgmma
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("exp_int4_wgmma_variants: needs a CUDA device")
    print(cs.card_line(), flush=True)
    with open(SOURCE) as f:
        fns = build(variants(f.read()))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for M, K, N in SHAPES:
        x, w = cs.int4_case(dev, gen, M, K, N)
        ref = i4.int4_matmul_torch(x, w.w_p, w.scale, w.group)
        for name, fn in fns.items():
            out = torch.empty_like(ref)

            def call(fn=fn, out=out):
                rc = fn(x.data_ptr(), w.w_p.data_ptr(), w.scale.data_ptr(), out.data_ptr(), M, K, N,
                        i4.KERNEL_GROUP, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: cudaError {rc}")

            call()
            torch.cuda.synchronize()
            ok = cs.agreement(out, ref, None)["ok"]
            ms = statistics.median(cs.time_ms(call))
            print(f"[variant] {name} M={M} K={K} N={N} ms={ms:.4f} "
                  f"tflops={2 * M * K * N / ms / 1e9:.1f} agrees={ok}", flush=True)
        del x, w, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
