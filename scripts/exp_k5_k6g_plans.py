"""K5's dq (causal GQA backward) and K6's global-block backward (dq; dk, dv
over whole frames) against earlier kernels and variants, on one GPU.

    python3 scripts/exp_k5_k6g_plans.py [--before DIR]

Builds csrc/flash_attention_bwd.cu and csrc/window_attention_bwd.cu as they
are and variants of their sources, each into its own library under
open_o3_video_tpu_torch/_build/variants/, and times with CUDA events
(chip_smoke.py's time_ms), at chip_smoke.py's shapes:

- K5 dq at the SFT step's decoder shape: 1 x 3136 rows, the first 3082 keys
  valid (the packed example of PERF.md section 4), 28/4 heads of 128;
- K6 dq and dk/dv at the slice's frames (16 frames of 18x24 patches, W =
  448, resident) and at 32x32 patches (W = 1024, streamed).

Variants (source patches, not knobs of the kernels):

- kernel: the sources as committed;
- k5_stages_2, k5_stages_3: K5 dq's K/V ring of 2 or 3 slots (4 committed);
- k5_no_overlap: K5 dq awaits each tile's ds K product before forming the
  next tile's ds (no product in flight under the exponentials);
- k6_warps_N (N = 7, 8, 10, 14): N consumer warps a CTA in both of K6's
  kernels (committed: 8 for dq, 7 for dk/dv; 14 is K2's, under a cap of
  136 registers);
- k6_one_launch: K6's dq and dk/dv as one launch with two CTA roles (the
  resident frames only: blockIdx.x picks the role; 7 consumer warps in
  both), timed against the two launches of the others;
- no_products: the products left out (mma.sync in every kernel and K5's
  wgmma; wrong output: the time of the loads, the exponentials and the
  stores).

--before DIR also builds DIR/open_o3_video_tpu_torch/csrc (an earlier tree,
e.g. the parent commit unpacked by git archive) and times its kernels of the
same entry points in the same run.

Prints per variant the registers and spills of the kernels (ptxas -v), then
per case and variant the ms and whether the output agrees with the plain
version (chip_smoke.py's bound), beside SDPA's forward and backward on the
same inputs.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from open_o3_video_tpu_torch.models.qwen25vl.config import Qwen25VLConfig  # noqa: E402
from open_o3_video_tpu_torch.ops import flash_attention as fa  # noqa: E402
from open_o3_video_tpu_torch.ops import kernels  # noqa: E402
from open_o3_video_tpu_torch.ops import window_attention as wa  # noqa: E402

OUT = os.path.join(REPO, "open_o3_video_tpu_torch", "_build", "variants")
SOURCES = ("flash_attention_bwd.cu", "window_attention_bwd.cu")
ENTRIES = ("o3v_flash_attention_gqa_bwd_dq", "o3v_window_attention_bwd_dq",
           "o3v_window_attention_bwd_dkv")
ONE_LAUNCH = "o3v_window_attention_bwd_both"
ONE_LAUNCH_ARGS = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 4 + (ctypes.c_float, ctypes.c_void_p)
SFT_ROWS, SFT_VALID = 3136, 3082  # the SFT example: 3082 tokens padded to 3136


def sub(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise SystemExit(f"the source no longer holds {old!r} {count} time(s)")
    return text.replace(old, new)


def no_products(files: dict) -> None:
    """mma.sync's instruction out of attention_tile.cuh's mma_16816 and the
    wgmma instructions out of wgmma.cuh (their operands stay live)."""
    files["attention_tile.cuh"] = sub(
        files["attention_tile.cuh"],
        '"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
        '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"', '""')
    if "wgmma.cuh" in files:
        files["wgmma.cuh"] = re.sub(r'"wgmma\.mma_async[^"]*" O3V_WG_R(64|32)\n\s*"[^"]*"',
                                    r'"}\\n"', files["wgmma.cuh"])


# K6's dq and dk/dv as one launch: the committed kernel's body becomes a
# device function of its two tensor maps, and a kernel of two CTA roles
# (blockIdx.x 0: dq, 1: dk/dv) calls it, resident frames only.
ONE_LAUNCH_SRC = r"""
template <int D>
__global__ void __launch_bounds__(frame_threads(true), 1)
    window_bwd_both_kernel(const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do, FrameBwd f_dq,
                           FrameBwd f_dkv) {
  if (blockIdx.x == 0) window_bwd_frame_body<D, false, true>(tm_k, tm_v, f_dq);
  else window_bwd_frame_body<D, true, true>(tm_q, tm_do, f_dkv);
}

}  // namespace o3v

extern "C" int o3v_window_attention_bwd_both(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse, const void* delta,
                                             const void* ids, void* dq, void* dk, void* dv, int n,
                                             int w, int heads, int head_dim, float scale,
                                             void* stream) {
  using namespace o3v;
  if (head_dim != 80) return static_cast<int>(cudaErrorInvalidValue);
  const frame::Plan pl = frame::plan<80>(w, frame_warps(true), row_words(true));
  if (!pl.resident) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm[4];
  const void* src[4] = {k, v, q, dout};
  for (int i = 0; i < 4; ++i)
    if (!frame::encode<80>(&tm[i], src[i], n, w, heads)) return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = allow_smem(window_bwd_both_kernel<80>, kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  FrameBwd f = frame_args(q, k, v, dout, lse, delta, ids, w, heads, scale);
  f.n_tiles = f.ring = pl.tiles;
  FrameBwd f_dq = f, f_dkv = f;
  f_dq.dq = static_cast<bf16*>(dq);
  f_dkv.dk = static_cast<bf16*>(dk);
  f_dkv.dv = static_cast<bf16*>(dv);
  window_bwd_both_kernel<80><<<dim3(2, heads, n), frame_threads(true), pl.smem,
                               static_cast<cudaStream_t>(stream)>>>(tm[0], tm[1], tm[2], tm[3],
                                                                    f_dq, f_dkv);
  return static_cast<int>(cudaGetLastError());
}
"""


def warps(src: str, n: int) -> str:
    """n consumer warps a CTA in both of K6's global kernels."""
    return sub(src, "return dkv ? 7 : 8;", f"return {n};")


def one_launch(files: dict) -> None:
    src = files["window_attention_bwd.cu"]
    src = warps(src, 7)
    src = sub(src, """template <int D, bool DKV, bool RESIDENT>
__global__ void __launch_bounds__(frame_threads(DKV), 1)
    window_bwd_frame_kernel(const __grid_constant__ CUtensorMap tm_a,
                            const __grid_constant__ CUtensorMap tm_b, FrameBwd f) {""",
              """template <int D, bool DKV, bool RESIDENT>
__device__ __forceinline__ void window_bwd_frame_body(const CUtensorMap& tm_a,
                                                      const CUtensorMap& tm_b, FrameBwd f) {""")
    marker = "// The tensor maps of the two slices a CTA keeps"
    src = sub(src, marker, """template <int D, bool DKV, bool RESIDENT>
__global__ void __launch_bounds__(frame_threads(DKV), 1)
    window_bwd_frame_kernel(const __grid_constant__ CUtensorMap tm_a,
                            const __grid_constant__ CUtensorMap tm_b, FrameBwd f) {
  window_bwd_frame_body<D, DKV, RESIDENT>(tm_a, tm_b, f);
}

""" + marker)
    head, tail = ONE_LAUNCH_SRC.split("}  // namespace o3v")  # after the file's end
    files["window_attention_bwd.cu"] = src + "\nnamespace o3v {\n" + head + "}  // namespace o3v\n" + tail


def new_variants(files: dict) -> dict[str, dict]:
    out = {"kernel": dict(files)}
    for stages in (2, 3):
        f = dict(files)
        f["flash_attention_bwd.cu"] = sub(f["flash_attention_bwd.cu"],
                                          "constexpr int kStages = 4;",
                                          f"constexpr int kStages = {stages};")
        out[f"k5_stages_{stages}"] = f
    f = dict(files)
    f["flash_attention_bwd.cu"] = sub(
        f["flash_attention_bwd.cu"],
        "      dq_product(prev);\n      wg::wait<1>();",
        "      dq_product(prev);\n      wg::wait<0>();")
    out["k5_no_overlap"] = f
    for n in (7, 8, 10, 14):
        f = dict(files)
        f["window_attention_bwd.cu"] = warps(f["window_attention_bwd.cu"], n)
        out[f"k6_warps_{n}"] = f
    f = dict(files)
    one_launch(f)
    out["k6_one_launch"] = f
    f = dict(files)
    no_products(f)
    out["no_products"] = f
    return out


def old_variants(files: dict) -> dict[str, dict]:
    out = {"kernel": dict(files)}
    f = dict(files)
    no_products(f)
    out["no_products"] = f
    return out


def build(variants: dict[tuple[str, str], dict]) -> dict:
    """Compile every (tree, variant) at once; tree -> name -> {entry point
    -> ctypes function}."""
    jobs = {}
    for (tree, name), files in variants.items():
        d = os.path.join(OUT, f"{tree}_{name}")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for fname, text in files.items():
            with open(os.path.join(d, fname), "w") as fh:
                fh.write(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", "-shared",
               "-o", os.path.join(d, "lib.so"), *(os.path.join(d, s) for s in SOURCES)]
        jobs[tree, name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True))
    libs: dict = {}
    for (tree, name), (d, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{tree} {name}: nvcc failed\n{log[-4000:]}")
        kernel, report = None, []
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '\w*?(causal_dq_kernel|window_bwd_\w+?_kernel|"
                          r"attention_bwd_d\w+?_kernel)(\w*)'", line)
            if "Compiling entry function" in line:
                kernel = m and f"{m.group(1)}<{','.join(re.findall(r'L[ib](\d+)', m.group(2)))}>"
            elif kernel and ("spill" in line or "Used" in line):
                report.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
        print(f"[build] {tree} {name}", *report, sep="\n  ", flush=True)
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        fns = {}
        for entry in ENTRIES + (ONE_LAUNCH,):
            fn = getattr(lib, entry, None)
            if fn is None:
                continue
            fn.argtypes = list(kernels._SIGNATURES.get(entry, ONE_LAUNCH_ARGS))
            fn.restype = ctypes.c_int
            fns[entry] = fn
        libs.setdefault(tree, {})[name] = fns
    return libs


def read_sources(csrc: str) -> dict:
    return {f: open(os.path.join(csrc, f)).read() for f in os.listdir(csrc)
            if f.endswith((".cu", ".cuh"))}


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def checked(fn, *args) -> None:
    rc = fn(*args, stream())
    if rc:
        raise RuntimeError(f"cudaError {rc}")


def time_variants(libs_by_tree, label, entry, call, out, ref, keep=None) -> None:
    for tree, libs in libs_by_tree.items():
        for name, fns in libs.items():
            if entry not in fns:
                continue
            try:
                call(fns[entry])
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"[{tree}] {label} variant={name} refused: {e}", flush=True)
                continue
            ok = cs.agreement(out(), ref, keep)["ok"]
            ms = statistics.median(cs.time_ms(lambda: call(fns[entry])))
            print(f"[{tree}] {label} variant={name} ms={ms:.4f} agrees={ok}", flush=True)


def k5_case(dev, gen, libs_by_tree) -> None:
    t = Qwen25VLConfig().text
    Hq, Hkv, D, L = t.num_attention_heads, t.num_key_value_heads, t.head_dim, SFT_ROWS
    q = torch.randn((1, L, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((1, L, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    do = (cs.DOUT_SCALE * torch.randn((1, L, Hq, D), generator=gen, device=dev)).to(torch.bfloat16)
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None].contiguous()
    valid = torch.zeros((1, L), dtype=torch.int32, device=dev)
    valid[:, :SFT_VALID] = 1
    out, lse = fa.flash_attention_gqa_exact(q, k, v, pos, valid)
    ops = fa.bwd_operands(q, k, v, pos, valid, out, lse, do)
    ref = fa.flash_attention_gqa_bwd_torch(q, k, v, pos, valid, out, lse, do)[0]
    ms = statistics.median(cs.time_ms(lambda: cs.sdpa_fwd_bwd(q, k, v, do, is_causal=True)))
    print(f"[sdpa] K5 dq S={L} fwd+bwd ms={ms:.4f}", flush=True)
    dq = torch.empty_like(ops[0])
    time_variants(libs_by_tree, f"K5 dq S={L}", ENTRIES[0],
                  lambda fn: checked(fn, *(x.data_ptr() for x in ops), dq.data_ptr(),
                                     1, L, L, Hq, Hkv, D),
                  lambda: dq, ref)


def k6_cases(dev, gen, libs_by_tree) -> None:
    v = Qwen25VLConfig().vision
    H, D = v.num_heads, v.head_dim
    for grid_hw in cs.K2_FRAME_GRIDS:
        ids, q, k, vv, do = cs.frame_inputs(dev, gen, v, grid_hw, cs.DOUT_SCALE)
        n, w = ids.shape
        out, lse = wa.window_attention_exact(q, k, vv, ids)
        ops = wa.bwd_operands(q, k, vv, ids, out, lse, do)
        ref = wa.window_attention_bwd_torch(q, k, vv, ids, do)
        seg = cs.segment_mask(ids)
        ms = statistics.median(cs.time_ms(lambda: cs.sdpa_fwd_bwd(q, k, vv, do, attn_mask=seg)))
        print(f"[sdpa] K6 W={w} fwd+bwd ms={ms:.4f}", flush=True)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        args = (n, w, H, D, D**-0.5)
        ptrs = [x.data_ptr() for x in ops]
        time_variants(libs_by_tree, f"K6 dq W={w}", ENTRIES[1],
                      lambda fn: checked(fn, *ptrs, dq.data_ptr(), *args), lambda: dq, ref[0])
        time_variants(libs_by_tree, f"K6 dkv W={w}", ENTRIES[2],
                      lambda fn: checked(fn, *ptrs, dk.data_ptr(), dv.data_ptr(), *args),
                      lambda: (dk, dv), ref[1:])

        def both(libs):  # the two launches of each variant, or its one
            if ONE_LAUNCH in libs:
                return lambda: checked(libs[ONE_LAUNCH], *ptrs, dq.data_ptr(), dk.data_ptr(),
                                       dv.data_ptr(), *args)
            return lambda: (checked(libs[ENTRIES[1]], *ptrs, dq.data_ptr(), *args),
                            checked(libs[ENTRIES[2]], *ptrs, dk.data_ptr(), dv.data_ptr(), *args))

        for tree, libs in libs_by_tree.items():
            for name, fns in libs.items():
                call = both(fns)
                try:
                    call()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    print(f"[{tree}] K6 dq+dkv W={w} variant={name} refused: {e}", flush=True)
                    continue
                ok = cs.agreement((dq, dk, dv), ref, None)["ok"]
                ms = statistics.median(cs.time_ms(call))
                print(f"[{tree}] K6 dq+dkv W={w} variant={name} ms={ms:.4f} agrees={ok}",
                      flush=True)
        del ids, q, k, vv, do, out, lse, ops, ref, dq, dk, dv
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", help="root of an earlier tree whose kernels to time too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exp_k5_k6g_plans: needs a CUDA device")
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    os.makedirs(OUT, exist_ok=True)
    variants = {("now", name): files
                for name, files in new_variants(read_sources(str(kernels.SOURCE_DIR))).items()}
    if args.before:
        csrc = os.path.join(args.before, "open_o3_video_tpu_torch", "csrc")
        variants.update({("before", name): files
                         for name, files in old_variants(read_sources(csrc)).items()})
    libs = build(variants)
    k5_case(dev, gen, libs)
    k6_cases(dev, gen, libs)


if __name__ == "__main__":
    main()
