// ViT window-attention backward for Hopper (sm_90a): K6.
//
// fused_window_attention_bwd replaces open_o3_video_tpu/ops/window_attention.py
// _fused_bwd_kernel (the 28 windowed blocks), at the packed row widths W = 64
// and 128. Per (row, head) it re-ropes q and k from the raw qkv row in f32
// with no FMA contraction, as K1 does, rounds them to bf16, and recomputes
// the exact in-window softmax p = exp(s - m) / l in registers (a pad row, id
// 0, attends uniformly, as JAX's all-NEG_INF row does). Then, as JAX does,
// ds = p * (dp - rowsum(dp * p)) * D^-1/2 with dp = dout @ v^T, dq = ds @ k,
// dk = ds^T @ q, dv = p^T @ dout, and the rope transpose dx = dy * cos +
// [a2, -a1] (a = dy * sin, halves D / 2 apart) on dq and dk, written with dv
// into one (N, W, 3 * H * D) dqkv row at the lane offsets h * D, H * D + h *
// D and 2 * H * D + h * D of the qkv layout.
//
// What bounds it on the H100: per (row, head) at W = 64 five 64 x 64 x 80
// products (~3.3 MFLOP) against ~60 KB of qkv, dout and dqkv: ~44 FLOP per
// byte, under the ~295 FLOP/byte where bf16 tensor cores become the limit,
// so it is bound by device-memory bytes, and by latency where each load is
// awaited in turn. The design (window_row.cuh):
// - a CTA takes one head of one row, its q, k, v and dout slabs coming by
//   TMA at once, so every SM holds several (row, head) items with their
//   loads in flight;
// - each warp owns 16 rows: as query rows it forms s, dp, p and ds in
//   registers and dq = ds @ k; as key rows, dk = ds^T @ q and dv = p^T @
//   dout, with p and ds staged in shared memory as bf16 (read transposed by
//   ldmatrix), the one exchange between warps;
// - the rope of q and k and its transpose on dq and dk run on each thread's
//   own fragment positions in registers, cos/sin read at those positions
//   through L1: no f32 staging, no table reads per element.
//
// window_attention_bwd_{dq,dkv} replace _bwd_kernel (the 4 global blocks,
// W = 448 whole frames): attention_bwd.cuh's kernels in segment mode, with
// the keys tiled, so rowsum(dp * p) comes as delta = rowsum(dout * out) and
// p from the forward's lse (FlashAttention-2 form). They re-read each
// frame's tiles from L2 per query or key tile.
#include "attention_bwd.cuh"
#include "window_row.cuh"

namespace o3v {

template <int W>
using Square = bf16[W][W + kPad];  // p or ds of the row's W x W scores

// One head of one row, its q, k, v, dout slabs landed (sl[0..3]) and this
// thread's cos/sin in hand (read again, from `cs` and `sn`, for the rope
// transposes): q and k roped in place (q as dk's operand), then this warp's
// 16 rows as query rows (p, ds, dq) and as key rows (dk, dv), p and ds
// staged in sp and sds between the two. dq, dk, dv go to the head's lanes
// h * D, hd + h * D, 2 hd + h * D of the dqkv row `out`.
template <int D, int W>
__device__ __forceinline__ void fused_bwd_row_head(row::Slab<D, W>* sl, Square<W>& sp,
                                                   Square<W>& sds, float2 (&c)[2][D / 8],
                                                   float2 (&s)[2][D / 8], const float* cs,
                                                   const float* sn, const int* tag, bf16* out,
                                                   int h, int hd, float scale) {
  using Slab = row::Slab<D, W>;
  const long long row_stride = 3LL * hd;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3, r8 = lane & 7;
  Slab &sq = sl[0], &sk = sl[1], &sv = sl[2], &sdo = sl[3];
  auto out_row = [&](int col) { return [=](int r) { return out + r * row_stride + col; }; };
  uint32_t qa[D / 16][4];
  {
    float2 x[2][D / 8];
    row::read_own<D, W>(x, sq, r0);
    row::rope<D>(x, c, s);
    row::own_to_a<D>(qa, x);
    row::write_own<D, W>(sq, x, r0);  // roped q: dk's operand
    row::read_own<D, W>(x, sk, r0);
    row::rope<D>(x, c, s);
    row::write_own<D, W>(sk, x, r0);
  }
  __syncthreads();  // q and k roped

  // This warp's 16 query rows against all W keys: p, ds, dq.
  {
    const int row_tag[2] = {tag[r0 + g], tag[r0 + g + 8]};
    float p[W / 8][4], dp[W / 8][4];
    row::scores<D, W>(p, qa, sk);
    {
      uint32_t da[D / 16][4];
      row::slab_a<D, W>(da, sdo, r0);
      row::scores<D, W>(dp, da, sv);
    }
    row::exact_softmax<W>(p, tag, row_tag, scale);
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < W / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[e >> 1] += dp[nt][e] * p[nt][e];
    rs[0] = quad_sum(rs[0]);
    rs[1] = quad_sum(rs[1]);
#pragma unroll
    for (int nt = 0; nt < W / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = p[nt][e] * (dp[nt][e] - rs[e >> 1]) * scale;
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(&sp[r0 + g][col]) = pack_bf16x2(p[nt][0], p[nt][1]);
      *reinterpret_cast<uint32_t*>(&sp[r0 + g + 8][col]) = pack_bf16x2(p[nt][2], p[nt][3]);
      *reinterpret_cast<uint32_t*>(&sds[r0 + g][col]) = pack_bf16x2(dp[nt][0], dp[nt][1]);
      *reinterpret_cast<uint32_t*>(&sds[r0 + g + 8][col]) = pack_bf16x2(dp[nt][2], dp[nt][3]);
    }
    float dq[D / 8][4] = {};
    row::times_slab<D, W>(dq, dp, sk);  // dq = ds @ k
    row::load_tab<D>(c, cs, r0);
    row::load_tab<D>(s, sn, r0);
    row::rope_transpose<D>(dq, c, s);
    store_frags<D>(dq, 1.f, r0, W, out_row(h * D));
  }
  __syncthreads();  // p and ds of every row staged

  // This warp's 16 key rows: dk = ds^T @ q, dv = p^T @ dout.
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
#pragma unroll
  for (int kt = 0; kt < W / 16; ++kt) {
    uint32_t ads[4], ap[4];
    ldsm_x4<true>(ads, &sds[kt * 16 + (mat >> 1) * 8 + r8][r0 + (mat & 1) * 8]);
    ldsm_x4<true>(ap, &sp[kt * 16 + (mat >> 1) * 8 + r8][r0 + (mat & 1) * 8]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t f[4];
      ldsm_x4<true>(f, &sq[kt * 16 + (mat & 1) * 8 + r8][(2 * dp + (mat >> 1)) * 8]);
      mma_16816(dk[2 * dp], ads, f[0], f[1]);
      mma_16816(dk[2 * dp + 1], ads, f[2], f[3]);
      ldsm_x4<true>(f, &sdo[kt * 16 + (mat & 1) * 8 + r8][(2 * dp + (mat >> 1)) * 8]);
      mma_16816(dv[2 * dp], ap, f[0], f[1]);
      mma_16816(dv[2 * dp + 1], ap, f[2], f[3]);
    }
  }
  store_frags<D>(dv, 1.f, r0, W, out_row(2 * hd + h * D));
  row::load_tab<D>(c, cs, r0);
  row::load_tab<D>(s, sn, r0);
  row::rope_transpose<D>(dk, c, s);
  store_frags<D>(dk, 1.f, r0, W, out_row(hd + h * D));
}

// A CTA per (row n, head h): blockIdx.x = n * heads + h. The head's q, k, v
// and dout slabs come by TMA on one mbarrier while each thread reads its
// cos/sin. A minimum of one CTA an SM lets ptxas take ~240 registers, where
// left to itself it takes 137 at W = 64 and runs 13% slower
// (scripts/exp_k1_k6_plans.py, PERF.md).
template <int D, int W>
__global__ void __launch_bounds__(2 * W, 1)
    fused_window_bwd_rows_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                                 const __grid_constant__ CUtensorMap tm_dout,
                                 const float* __restrict__ cos, const float* __restrict__ sin,
                                 const int* __restrict__ ids, bf16* __restrict__ dqkv, int heads,
                                 float scale) {
  static_assert(D + kPad == row::kBoxCols, "the TMA box is built for D = 80");
  extern __shared__ uint8_t smem_raw[];
  row::Slab<D, W>* slab = row::slabs<D, W>(smem_raw);  // q, k, v, dout
  Square<W>& sp = *reinterpret_cast<Square<W>*>(slab + 4);
  Square<W>& sds = *(&sp + 1);
  int* tag = reinterpret_cast<int*>(&sds + 1);
  const uint32_t bar = async::smem_u32(tag + W);
  const int n = blockIdx.x / heads, h = blockIdx.x % heads, hd = heads * D;
  const long long row0 = static_cast<long long>(n) * W;
  row::begin<W>(tag, ids + row0, bar);
  if (threadIdx.x == 0) {
    async::mbar_expect_tx(bar, 4 * row::kSlabBytes<D, W>);
    for (int part = 0; part < 3; ++part)
      async::tma_load_2d(async::smem_u32(slab + part), &tm_qkv, bar, part * hd + h * D, n * W);
    async::tma_load_2d(async::smem_u32(slab + 3), &tm_dout, bar, h * D, n * W);
  }
  const float* cs = cos + row0 * D;
  const float* sn = sin + row0 * D;
  float2 c[2][D / 8], s[2][D / 8];
  const int r0 = (threadIdx.x >> 5) * 16;
  row::load_tab<D>(c, cs, r0);
  row::load_tab<D>(s, sn, r0);
  async::mbar_wait(bar, 0);
  fused_bwd_row_head<D, W>(slab, sp, sds, c, s, cs, sn, tag, dqkv + row0 * 3 * hd, h, hd, scale);
}

// Tensor maps over qkv as (N * W, 3 * H * D) and dout as (N * W, H * D), a
// CTA per (row, head).
template <int D, int W>
cudaError_t launch_fused_bwd(const void* qkv, const void* cos, const void* sin, const void* ids,
                             const void* dout, void* dqkv, int n, int heads, float scale,
                             cudaStream_t stream) {
  CUtensorMap tm[2];
  const long long rows = static_cast<long long>(n) * W;
  if (!row::encode_rows(&tm[0], qkv, rows, 3LL * heads * D, W) ||
      !row::encode_rows(&tm[1], dout, rows, static_cast<long long>(heads) * D, W))
    return cudaErrorInvalidValue;
  return row::launch<fused_window_bwd_rows_kernel<D, W>, W>(
      n * heads, row::smem_bytes<D, W>(4, 2 * sizeof(Square<W>)), stream, tm[0], tm[1],
      static_cast<const float*>(cos), static_cast<const float*>(sin), static_cast<const int*>(ids),
      static_cast<bf16*>(dqkv), heads, scale);
}

BwdArgs segment_args(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* ids, int w, int heads,
                     float scale) {
  BwdArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.q_tag = static_cast<const int*>(ids);
  a.k_tag = static_cast<const int*>(ids);
  a.s_len = a.t_len = w;
  a.hq = a.hkv = heads;
  a.s_scale = a.dq_scale = a.dk_scale = scale;
  return a;
}

}  // namespace o3v

// Plain C interface (loaded with ctypes); each returns cudaGetLastError()
// after its launch. Built for the vision head_dim of 80 only; the fused
// kernel for row widths 64 and 128.
extern "C" int o3v_fused_window_attention_bwd(const void* qkv, const void* cos, const void* sin,
                                              const void* ids, const void* dout, void* dqkv,
                                              int n, int w, int heads, int head_dim, float scale,
                                              void* stream) {
  if (head_dim != 80) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == 64) return o3v::launch_fused_bwd<80, 64>(qkv, cos, sin, ids, dout, dqkv, n, heads, scale, s);
  if (w == 128) return o3v::launch_fused_bwd<80, 128>(qkv, cos, sin, ids, dout, dqkv, n, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q/k/v/dout/dq/dk/dv (N, W, H, D) contiguous bf16; lse, delta (N, H, W)
// float32; ids (N, W) int32 segment ids.
extern "C" int o3v_window_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           const void* ids, void* dq, int n, int w, int heads,
                                           int head_dim, float scale, void* stream) {
  if (head_dim != 80) return static_cast<int>(cudaErrorInvalidValue);
  o3v::BwdArgs a = o3v::segment_args(q, k, v, dout, lse, delta, ids, w, heads, scale);
  a.dq = static_cast<o3v::bf16*>(dq);
  return o3v::launch_bwd_dq<80, o3v::kSegment>(a, n, static_cast<cudaStream_t>(stream));
}

extern "C" int o3v_window_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            const void* ids, void* dk, void* dv, int n, int w,
                                            int heads, int head_dim, float scale, void* stream) {
  if (head_dim != 80) return static_cast<int>(cudaErrorInvalidValue);
  o3v::BwdArgs a = o3v::segment_args(q, k, v, dout, lse, delta, ids, w, heads, scale);
  a.dk = static_cast<o3v::bf16*>(dk);
  a.dv = static_cast<o3v::bf16*>(dv);
  return o3v::launch_bwd_dkv<80, o3v::kSegment>(a, n, static_cast<cudaStream_t>(stream));
}
