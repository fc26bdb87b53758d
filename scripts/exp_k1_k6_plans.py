"""What holds K1 (fused rope + window attention, both modes) and K6's fused
backward, on one GPU.

    python3 scripts/exp_k1_k6_plans.py [--before DIR]

Builds csrc/window_attention.cu and csrc/window_attention_bwd.cu as they are
and variants of their sources, each into its own library under
open_o3_video_tpu_torch/_build/variants/, and times K1 (inference and
exact) and K6 fused at the tower's packed window rows (chip_smoke.py's
inputs: 16 frames of 18x24 patches, W = 64, and of 18x26, W = 128; 16 heads
of 80) with CUDA events (chip_smoke.py's time_ms):

- kernel: the sources as committed;
- ring_H_S: the row kernels (one head of one row a CTA, its slabs on one
  mbarrier) patched into rings: a CTA takes H heads of its row one after
  another, their slabs coming by TMA into S slots (fewer where they do not
  fit in shared memory), each head's refill issued once every warp is done
  with the head S before it (RING_K1 and RING_K6 below, around the
  committed per-head functions);
- no_min_ctas: K1 without its register cap (k1_min_ctas at 1);
- k6_no_min_ctas: K6 without its minimum of one CTA an SM in its
  __launch_bounds__ (ptxas' own register count);
- no_rope: without the rope and its transpose, and without their cos/sin
  reads (wrong output);
- no_products: the mma.sync products left out (wrong output; the time of
  the loads, the softmax and the stores);
- no_exp: the exponentials replaced by their argument (wrong output).

--before DIR also builds DIR/open_o3_video_tpu_torch/csrc (an earlier tree,
e.g. the parent commit unpacked by git archive) and its no_rope,
no_products and no_exp variants, and times them in the same run.

Prints per variant the registers and spills of K1's and K6's kernels (ptxas
-v), then per variant and case the ms, and whether the output agrees with
the plain version (chip_smoke.py's bound), beside SDPA's time on the same
roped q, k, v (forward and backward for K6).
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
from open_o3_video_tpu_torch.ops import kernels  # noqa: E402
from open_o3_video_tpu_torch.ops import window_attention as wa  # noqa: E402

OUT = os.path.join(REPO, "open_o3_video_tpu_torch", "_build", "variants")
SOURCES = ("window_attention.cu", "window_attention_bwd.cu")
ENTRIES = ("o3v_fused_window_attention", "o3v_fused_window_attention_exact",
           "o3v_fused_window_attention_bwd")
RINGS = ((2, 1), (2, 2), (4, 1), (4, 2), (8, 2), (16, 2))


def sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"the source no longer holds {old!r}")
    return text.replace(old, new)


def no_products(files: dict) -> None:
    """mma.sync's instruction out of attention_tile.cuh's mma_16816 (its
    operands stay live)."""
    files["attention_tile.cuh"] = sub(
        files["attention_tile.cuh"],
        '"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
        '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"', '""')


# A ring of HEADS heads per CTA in SLOTS slots, as a patch of the committed
# row kernels: their __global__ functions (RING_K1 for K1's in
# window_attention.cu, RING_K6 for K6's in window_attention_bwd.cu) are
# replaced around the same per-head functions, and the launchers' grid and
# shared memory follow (ring).
RING_COMMON = r"""
constexpr int kRingHeads = HEADS, kRingSlots = SLOTS;

// The slots that fit: SLABS slabs and a barrier each, EXTRA bytes besides.
template <int D, int W, int SLABS, int EXTRA>
constexpr int ring_slots() {
  int s = kRingSlots < kRingHeads ? kRingSlots : kRingHeads;
  while (s > 1 && row::smem_bytes<D, W>(SLABS * s, EXTRA + 8 * s) > kSmemMax) --s;
  return s;
}
template <int D, int W, int SLABS, int EXTRA>
constexpr int kFitSlots = ring_slots<D, W, SLABS, EXTRA>();  // usable in device code
"""

RING_K1 = RING_COMMON + r"""
template <int D, int W, bool EXACT>
__global__ void __launch_bounds__(2 * W, row::k1_min_ctas(W))
    fused_window_rows_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                             const float* __restrict__ cos, const float* __restrict__ sin,
                             const int* __restrict__ ids, bf16* __restrict__ out, int heads,
                             float scale) {
  constexpr int kSlots = kFitSlots<D, W, 3, 0>;
  extern __shared__ uint8_t smem_raw[];
  row::Slab<D, W>* slab = row::slabs<D, W>(smem_raw);
  int* tag = reinterpret_cast<int*>(slab + 3 * kSlots);
  const uint32_t bars = async::smem_u32(tag + W);
  const int groups = (heads + kRingHeads - 1) / kRingHeads;
  const int n = blockIdx.x / groups, h0 = blockIdx.x % groups * kRingHeads;
  const int nh = min(kRingHeads, heads - h0), hd = heads * D, r0 = (threadIdx.x >> 5) * 16;
  const long long row0 = static_cast<long long>(n) * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) tag[i] = ids[row0 + i];
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSlots; ++i) async::mbar_init(bars + 8 * i, 1);
    async::mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int j) {
    const int slot = j % kSlots;
    async::mbar_expect_tx(bars + 8 * slot, 3 * row::kSlabBytes<D, W>);
    for (int part = 0; part < 3; ++part)
      async::tma_load_2d(async::smem_u32(slab + 3 * slot + part), &tm_qkv, bars + 8 * slot,
                         part * hd + (h0 + j) * D, n * W);
  };
  if (threadIdx.x == 0)
    for (int j = 0; j < min(kSlots, nh); ++j) issue(j);
  for (int j = 0; j < nh; ++j) {
    float2 c[2][D / 8], s[2][D / 8];
    row::load_tab<D>(c, cos + row0 * D, r0);
    row::load_tab<D>(s, sin + row0 * D, r0);
    async::mbar_wait(bars + 8 * (j % kSlots), (j / kSlots) & 1);
    fused_row_head<D, W, EXACT>(slab + 3 * (j % kSlots), c, s, tag,
                                out + row0 * hd + (h0 + j) * D, hd, scale);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // k's rope before a refill
    __syncthreads();  // the slot is free
    if (threadIdx.x == 0 && j + kSlots < nh) issue(j + kSlots);
  }
}
"""

RING_K6 = RING_COMMON + r"""
template <int D, int W>
__global__ void __launch_bounds__(2 * W, 1)
    fused_window_bwd_rows_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                                 const __grid_constant__ CUtensorMap tm_dout,
                                 const float* __restrict__ cos, const float* __restrict__ sin,
                                 const int* __restrict__ ids, bf16* __restrict__ dqkv, int heads,
                                 float scale) {
  constexpr int kSlots = kFitSlots<D, W, 4, 2 * sizeof(Square<W>)>;
  extern __shared__ uint8_t smem_raw[];
  row::Slab<D, W>* slab = row::slabs<D, W>(smem_raw);
  Square<W>& sp = *reinterpret_cast<Square<W>*>(slab + 4 * kSlots);
  Square<W>& sds = *(&sp + 1);
  int* tag = reinterpret_cast<int*>(&sds + 1);
  const uint32_t bars = async::smem_u32(tag + W);
  const int groups = (heads + kRingHeads - 1) / kRingHeads;
  const int n = blockIdx.x / groups, h0 = blockIdx.x % groups * kRingHeads;
  const int nh = min(kRingHeads, heads - h0), hd = heads * D, r0 = (threadIdx.x >> 5) * 16;
  const long long row0 = static_cast<long long>(n) * W;
  const float* cs = cos + row0 * D;
  const float* sn = sin + row0 * D;
  for (int i = threadIdx.x; i < W; i += blockDim.x) tag[i] = ids[row0 + i];
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSlots; ++i) async::mbar_init(bars + 8 * i, 1);
    async::mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int j) {
    const int slot = j % kSlots, h = h0 + j;
    async::mbar_expect_tx(bars + 8 * slot, 4 * row::kSlabBytes<D, W>);
    for (int part = 0; part < 3; ++part)
      async::tma_load_2d(async::smem_u32(slab + 4 * slot + part), &tm_qkv, bars + 8 * slot,
                         part * hd + h * D, n * W);
    async::tma_load_2d(async::smem_u32(slab + 4 * slot + 3), &tm_dout, bars + 8 * slot, h * D,
                       n * W);
  };
  if (threadIdx.x == 0)
    for (int j = 0; j < min(kSlots, nh); ++j) issue(j);
  for (int j = 0; j < nh; ++j) {
    float2 c[2][D / 8], s[2][D / 8];
    row::load_tab<D>(c, cs, r0);
    row::load_tab<D>(s, sn, r0);
    async::mbar_wait(bars + 8 * (j % kSlots), (j / kSlots) & 1);
    fused_bwd_row_head<D, W>(slab + 4 * (j % kSlots), sp, sds, c, s, cs, sn, tag,
                             dqkv + row0 * 3 * hd, h0 + j, hd, scale);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the rope's writes before a refill
    __syncthreads();  // the slot, p and ds are free
    if (threadIdx.x == 0 && j + kSlots < nh) issue(j + kSlots);
  }
}
"""

# The committed __global__ row kernels, each to the end of its body.
K1_KERNEL = re.compile(r"template <int D, int W, bool EXACT>\n__global__ void __launch_bounds__\("
                       r"2 \* W, row::k1_min_ctas\(W\)\)\n    fused_window_rows_kernel\(.*?\n}\n",
                       re.S)
K6_KERNEL = re.compile(r"template <int D, int W>\n__global__ void __launch_bounds__\(2 \* W, 1\)\n"
                       r"    fused_window_bwd_rows_kernel\(.*?\n}\n", re.S)


def ring(files: dict, heads: int, slots: int) -> dict:
    """The row kernels as rings of `heads` heads per CTA in `slots` slots."""
    f = dict(files)
    for name, kernel, text, slabs, extra in (
            ("window_attention.cu", K1_KERNEL, RING_K1, 3, "0"),
            ("window_attention_bwd.cu", K6_KERNEL, RING_K6, 4, "2 * sizeof(Square<W>)")):
        patch = text.replace("HEADS", str(heads)).replace("SLOTS", str(slots))
        src, count = kernel.subn(lambda _: patch, f[name])
        if count != 1:
            raise SystemExit(f"{name}: the row kernel was not found")
        n_slots = f"kFitSlots<D, W, {slabs}, {extra}>"
        f[name] = sub(src, f"n * heads, row::smem_bytes<D, W>({slabs}, {extra})",
                      f"n * ((heads + kRingHeads - 1) / kRingHeads), "
                      f"row::smem_bytes<D, W>({slabs} * {n_slots}, {extra} + 8 * {n_slots})")
    return f


def new_variants(files: dict) -> dict[str, dict]:
    """Variants of the row kernels (window_row.cuh and its callers)."""
    out = {"kernel": dict(files)}
    for h, s in RINGS:
        out[f"ring_{h}_{s}"] = ring(files, h, s)
    f = dict(files)
    f["window_row.cuh"] = re.sub(r"(constexpr int k1_min_ctas\(int w\) \{ return ).*?;",
                                 r"\g<1>1;", f["window_row.cuh"])
    out["no_min_ctas"] = f
    f = dict(files)
    f["window_attention_bwd.cu"] = sub(f["window_attention_bwd.cu"],
                                       "__launch_bounds__(2 * W, 1)", "__launch_bounds__(2 * W)")
    out["k6_no_min_ctas"] = f
    f = dict(files)
    for name in SOURCES:  # the rope, its transpose and the table reads
        f[name] = re.sub(r"\n *row::(rope|rope_transpose|load_tab)<D>\([^;]*\);", "", f[name])
    out["no_rope"] = f
    f = dict(files)
    no_products(f)
    out["no_products"] = f
    f = dict(files)
    f["window_row.cuh"] = sub(f["window_row.cuh"], 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
                              "y = x;")
    out["no_exp"] = f
    return out


def old_variants(files: dict) -> dict[str, dict]:
    """The same ablations of the earlier kernels (rope while staging tiles,
    f32 staging and a rope-transpose pass in K6, expf)."""
    out = {"kernel": dict(files)}
    f = dict(files)
    f["attention_tile.cuh"] = sub(
        f["attention_tile.cuh"],
        "y[j] = __float2bfloat16_rn(\n"
        "            __fadd_rn(__fmul_rn(__bfloat162float(x[j]), cr[j]), __fmul_rn(rot, sr[j])));",
        "y[j] = x[j];\n        (void)rot;")
    f["window_attention_bwd.cu"] = sub(
        f["window_attention_bwd.cu"],
        "      const float y = __fmul_rn(f[row][col], cs[col]);\n"
        "      o[j] = col < kHalf ? __fadd_rn(y, __fmul_rn(f[row][col + kHalf], sn[col + kHalf]))\n"
        "                         : __fsub_rn(y, __fmul_rn(f[row][col - kHalf], sn[col - kHalf]));",
        "      o[j] = f[row][col];")
    out["no_rope"] = f
    f = dict(files)
    no_products(f)
    out["no_products"] = f
    f = dict(files)
    for name in (*SOURCES, "attention_tile.cuh"):
        f[name] = f[name].replace("expf(", "(")
    out["no_exp"] = f
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
            m = re.search(r"Compiling entry function '\w*?(fused_window\w*?kernel)I(\w*?)EEv", line)
            if "Compiling entry function" in line:
                kernel = f"{m.group(1)}<{','.join(re.findall(r'L[ib](\d+)', m.group(2)))}>" if m else None
            elif kernel and ("spill" in line or "Used" in line):
                report.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
        print(f"[build] {tree} {name}", *report, sep="\n  ", flush=True)
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        fns = {}
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = list(kernels._SIGNATURES[entry])
            fn.restype = ctypes.c_int
            fns[entry] = fn
        libs.setdefault(tree, {})[name] = fns
    return libs


def read_sources(csrc: str) -> dict:
    return {f: open(os.path.join(csrc, f)).read() for f in os.listdir(csrc)
            if f.endswith((".cu", ".cuh"))}


def run_cases(dev, gen, libs_by_tree) -> None:
    v = Qwen25VLConfig().vision
    H, D = v.num_heads, v.head_dim
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for grid_hw in cs.WINDOW_ROW_GRIDS:
        ids, cos, sin, qkv = cs.window_row_inputs(dev, gen, v, grid_hw)
        n, w = ids.shape
        do = (cs.DOUT_SCALE * torch.randn((n, w, H * D), generator=gen, device=dev)).to(torch.bfloat16)
        do[ids == 0] = 0
        rq, rk, rv = wa._rope_qk(qkv, cos, sin, H)
        seg = cs.segment_mask(ids)
        refs = {"inference": wa.fused_window_attention_torch(qkv, cos, sin, ids, H),
                "exact": wa.fused_window_attention_exact_torch(qkv, cos, sin, ids, H),
                "bwd": wa.fused_window_attention_bwd_torch(qkv, cos, sin, ids, H, do)}
        sdpa = {"inference": lambda: cs.sdpa_masked(rq, rk, rv, seg),
                "bwd": lambda: cs.sdpa_fwd_bwd(rq, rk, rv, do.view(*rq.shape), attn_mask=seg)}
        sdpa["exact"] = sdpa["inference"]
        for mode, fn_sdpa in sdpa.items():
            ms = statistics.median(cs.time_ms(fn_sdpa))
            print(f"[sdpa] W={w} mode={mode} ms={ms:.4f}", flush=True)
        out = torch.empty((n, w, H * D), dtype=torch.bfloat16, device=dev)
        dqkv = torch.empty_like(qkv)
        for tree, libs in libs_by_tree.items():
            for name, fns in libs.items():
                for mode, entry in zip(refs, ENTRIES):
                    dst = dqkv if mode == "bwd" else out
                    extra = (do.data_ptr(),) if mode == "bwd" else ()

                    def call(fn=fns[entry], dst=dst, extra=extra):
                        rc = fn(qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), ids.data_ptr(),
                                *extra, dst.data_ptr(), n, w, H, D, D**-0.5, stream())
                        if rc:
                            raise RuntimeError(f"{tree} {name} {mode}: cudaError {rc}")

                    call()
                    torch.cuda.synchronize()
                    keep = None if mode == "bwd" else ids != 0
                    ok = cs.agreement(dst, refs[mode], keep)["ok"]
                    ms = statistics.median(cs.time_ms(call))
                    print(f"[{tree}] W={w} mode={mode} variant={name} ms={ms:.4f} agrees={ok}",
                          flush=True)
        del qkv, do, rq, rk, rv, seg, refs, out, dqkv
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", help="root of an earlier tree whose kernels to time too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exp_k1_k6_plans: needs a CUDA device")
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
    run_cases(dev, gen, build(variants))


if __name__ == "__main__":
    main()
