"""Where K3 and K4 spend their time, on one GPU.

    python3 scripts/exp_k3_k4_variants.py

Builds csrc/flash_attention.cu (K3) and csrc/decode_attention.cu (K4) as
they are and variants of their sources, each into its own library under
open_o3_video_tpu_torch/_build/variants/, and times each (CUDA events,
chip_smoke.py's time_ms):

K3 at the 7B slice's prefill (inference) and the SFT step (exact):
- kernel: the source as committed;
- two_stages: a ring of 2 K/V slots instead of 3;
- no_exp: the inference softmax without its exponentials (p = s; wrong
  output; the time without the SFU's work);
- no_pv: without the P V products (wrong output; the time of Q K^T and the
  softmax).
K4 at run (b)'s decode step (T = 81920, fp8) and run (a)'s (32768, bf16):
- kernel;
- no_products: the consumers wait for each tile and release it without
  computing (wrong output; the time of the loads, the split sum and the
  launches);
- three_per_sm: registers capped for 3 CTAs per SM, with SPLIT_CTAS at 396.

Prints, per variant and case, ms and whether the output agrees with the
plain version (chip_smoke.py's bound).
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
from open_o3_video_tpu_torch.ops import decode_attention as da  # noqa: E402
from open_o3_video_tpu_torch.ops import flash_attention as fa  # noqa: E402
from open_o3_video_tpu_torch.ops import kernels  # noqa: E402

OUT = os.path.join(REPO, "open_o3_video_tpu_torch", "_build", "variants")
D = 128


def sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"the source no longer holds {old!r}")
    return text.replace(old, new)


def k3_variants(src: str) -> dict[str, str]:
    pv = "      wg::m64n128k16_rs_mn(acc, pa[kk], wg::sw128_mn_desc(v_slot(st) + kk * 2048, kKVBox));\n"
    return {
        "kernel": src,
        "two_stages": sub(src, "constexpr int kStages = 3;", "constexpr int kStages = 2;"),
        "no_exp": sub(src, "const float p = ok ? ex2(fminf(s[4 * nt + e], kClamp) * kLog2e) : 0.f;",
                      "const float p = ok ? s[4 * nt + e] : 0.f;"),
        "no_pv": sub(src, pv, ""),
    }


def k4_variants(src: str) -> dict[str, str]:
    return {
        "kernel": src,
        "no_products": sub(src, "    if (busy && kind != 0) {", "    if (false) {"),
        "three_per_sm": sub(src, "__launch_bounds__(kThreads5, 2)", "__launch_bounds__(kThreads5, 3)"),
    }


def build(prefix: str, srcs: dict[str, str], entries: tuple[str, ...]) -> dict:
    """name -> {entry point -> ctypes function}."""
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for name, src in srcs.items():
        path = os.path.join(OUT, f"{prefix}_{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.SOURCE_DIR),
               "-Xcompiler", "-fno-gnu-unique", "-shared", "-o",
               os.path.join(OUT, f"{prefix}_{name}.so"), path]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log = proc.communicate()[0]
        regs = [line.split("Used ")[1].split(",")[0] for line in log.splitlines() if "Used " in line]
        spills = sorted({line.strip() for line in log.splitlines() if "spill" in line})
        print(f"[build] {prefix} {name} rc={proc.returncode} registers={regs} {spills}", flush=True)
        if proc.returncode:
            raise SystemExit(log[-4000:])
        lib = ctypes.CDLL(os.path.join(OUT, f"{prefix}_{name}.so"))
        fns = {}
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = list(kernels._SIGNATURES[entry])
            fn.restype = ctypes.c_int
            fns[entry] = fn
        libs[name] = fns
    return libs


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def k3_cases(dev, gen, libs) -> None:
    rows = (2939, 2931)
    L = max(rows)
    for case, B, S, T, valid_rows, exact in (
            ("slice prefill", 2, L, L + 64, [(L - n, L) for n in rows], False),
            ("sft step", 1, 3136, 3136, [(0, 3082)], True)):
        q = torch.randn((B, S, 28, D), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((B, T, 4, D), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S).contiguous()
        valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
        for b, (first, end) in enumerate(valid_rows):
            valid[b, first:end] = 1
        plain = fa.flash_attention_gqa_exact_torch if exact else fa.flash_attention_gqa_torch
        ref = plain(q, k, v, pos, valid)
        ref = ref[0] if exact else ref
        qs, ps, vs = fa._kernel_operands("k3", q, k, v, pos, valid)
        out = torch.empty_like(qs)
        lse = torch.empty((B, 28, S), dtype=torch.float32, device=dev)
        entry = "o3v_flash_attention_gqa_exact" if exact else "o3v_flash_attention_gqa"
        for name, fns in libs.items():
            if exact and name == "no_exp":
                continue  # the variant removes the inference mode's exponentials only

            def call(fn=fns[entry]):
                extra = (lse.data_ptr(),) if exact else ()
                rc = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), ps.data_ptr(), vs.data_ptr(),
                        out.data_ptr(), *extra, B, S, T, 28, 4, D, k.stride(0), k.stride(1),
                        v.stride(0), v.stride(1), stream())
                if rc:
                    raise RuntimeError(f"{name}: cudaError {rc}")

            call()
            torch.cuda.synchronize()
            ok = cs.agreement(out, ref, None)["ok"]
            ms = statistics.median(cs.time_ms(call))
            print(f"[k3] {case} exact={exact} variant={name} ms={ms:.4f} agrees={ok}", flush=True)
        del q, k, v, ref
        torch.cuda.empty_cache()


def k4_cases(dev, gen, libs) -> None:
    for case, T, last, dtype in (("run (b) step", 81920, 81887, torch.float8_e4m3fn),
                                 ("run (a) step", 32768, 32735, torch.bfloat16)):
        B, S, Hq, Hkv = 1, 1, 28, 4
        cache = torch.full((2, B, T, Hkv, D), float("nan"), dtype=torch.bfloat16, device=dev)
        cache[:, :, :last + 1] = torch.randn(cache[:, :, :last + 1].shape, generator=gen,
                                             device=dev).to(torch.bfloat16)
        cache = cache.to(dtype)
        k, v = cache[0], cache[1]
        q = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
        qs = fa._prescale(q).contiguous()
        pos = torch.full((B, S), last, dtype=torch.int32, device=dev)
        valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
        valid[:, :last + 1] = 1
        ref = da.decode_attention_gqa_torch(q, k[:, :last + 1], v[:, :last + 1], pos,
                                            valid[:, :last + 1])
        out = torch.empty_like(qs)
        for name, fns in libs.items():
            ctas = 396 if name == "three_per_sm" else da.SPLIT_CTAS
            splits = max(1, min(ctas // (B * Hkv), -(-T // da.MIN_SPLIT_KEYS)))
            part_acc = torch.empty((B, Hkv, splits, S * Hq // Hkv, D), dtype=torch.float32,
                                   device=dev)
            part_l = torch.empty((B, Hkv, splits, S * Hq // Hkv), dtype=torch.float32, device=dev)

            def call(fn=fns["o3v_decode_attention_gqa"], splits=splits, pa=part_acc, pl=part_l):
                rc = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), valid.data_ptr(),
                        out.data_ptr(), pa.data_ptr(), pl.data_ptr(), B, S, T, Hq, Hkv, D,
                        int(dtype == torch.float8_e4m3fn), splits, k.stride(0), k.stride(1),
                        v.stride(0), v.stride(1), stream())
                if rc:
                    raise RuntimeError(f"{name}: cudaError {rc}")

            call()
            torch.cuda.synchronize()
            ok = cs.agreement(out, ref, None)["ok"]
            ms = statistics.median(cs.time_ms(call))
            print(f"[k4] {case} variant={name} splits={splits} ms={ms:.4f} agrees={ok}", flush=True)
        del cache, k, v, ref
        torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("exp_k3_k4_variants: needs a CUDA device")
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with open(kernels.SOURCE_DIR / "flash_attention.cu") as f:
        k3 = build("k3", k3_variants(f.read()),
                   ("o3v_flash_attention_gqa", "o3v_flash_attention_gqa_exact"))
    with open(kernels.SOURCE_DIR / "decode_attention.cu") as f:
        k4 = build("k4", k4_variants(f.read()), ("o3v_decode_attention_gqa",))
    k3_cases(dev, gen, k3)
    k4_cases(dev, gen, k4)


if __name__ == "__main__":
    main()
