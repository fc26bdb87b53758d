// ViT window-attention backward for Hopper (sm_90a): K6.
//
// fused_window_attention_bwd replaces open_o3_video_tpu/ops/window_attention.py
// _fused_bwd_kernel (the 28 windowed blocks). One CTA per window row of W =
// 64 or 128 tokens (W / 16 warps), heads looped. Per head it re-ropes q and
// k from the raw qkv row in f32 with no FMA contraction, as K1 does, rounds
// them to bf16, and recomputes the exact in-window softmax p = exp(s - m) / l
// in registers (a pad row, id 0, attends uniformly, as JAX's all-NEG_INF row
// does). Then, as JAX does, ds = p * (dp - rowsum(dp * p)) * D^-1/2 with
// dp = dout @ v^T, dq = ds @ k, dk = ds^T @ q, dv = p^T @ dout, and the rope
// transpose dx = dy * cos + [a2, -a1] (a = dy * sin, halves D / 2 apart) on
// dq and dk, written with dv into one (N, W, 3 * H * D) dqkv row at the lane
// offsets h * D, H * D + h * D and 2 * H * D + h * D of the qkv layout. p and
// ds are staged in shared memory as bf16 for the transposed products; dq and
// dk in f32, for the rope transpose, whose partners sit in other threads.
//
// window_attention_bwd_{dq,dkv} replace _bwd_kernel (the 4 global blocks,
// W = 448 whole frames): attention_bwd.cuh's kernels in segment mode, with
// the keys tiled, so rowsum(dp * p) comes as delta = rowsum(dout * out) and
// p from the forward's lse (FlashAttention-2 form).
//
// What bounds them on the H100: per W = 64 row (16 heads of 80) the fused
// kernel does five 64 x 64 x 80 products per head, ~52 MFLOP, and moves
// ~1.2 MB (qkv, dout and cos/sin read once, dqkv written once): ~44 FLOP per
// byte, under the ~295 FLOP/byte where bf16 tensor cores become the limit,
// so it is bound by device-memory bytes; the design touches each byte once.
// The global-block pair at W = 448 re-reads each frame's tiles from L2 per
// query or key tile.
#include "attention_bwd.cuh"

namespace o3v {

template <int D, int W>
struct FusedBwdSmem {
  bf16 q[W][D + kPad];
  bf16 k[W][D + kPad];
  bf16 v[W][D + kPad];
  bf16 dout[W][D + kPad];
  bf16 p[W][W + kPad];
  bf16 ds[W][W + kPad];
  float f[W][D];
  int id[W];
};

// This warp's 16 x D f32 fragments into f (rows row0 + g, row0 + g + 8).
template <int D, int W>
__device__ __forceinline__ void stage_frags(float (*f)[D], const float (&acc)[D / 8][4],
                                            int row0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      f[row0 + g + 8 * half][dt * 8 + 2 * t] = acc[dt][2 * half];
      f[row0 + g + 8 * half][dt * 8 + 2 * t + 1] = acc[dt][2 * half + 1];
    }
}

// dx = dy * cos + [a2, -a1], a = dy * sin, per row of f (W rows of D f32),
// rounded to bf16 and stored at out + row * row_stride.
template <int D, int W>
__device__ __forceinline__ void rope_transpose_store(float (*f)[D], const float* cos,
                                                     const float* sin, bf16* out,
                                                     long long row_stride) {
  constexpr int kHalf = D / 2;
  for (int i = threadIdx.x; i < W * kHalf; i += blockDim.x) {
    const int row = i / kHalf, c = (i % kHalf) * 2;
    float o[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = c + j;
      const float* cs = cos + static_cast<long long>(row) * D;
      const float* sn = sin + static_cast<long long>(row) * D;
      const float y = __fmul_rn(f[row][col], cs[col]);
      o[j] = col < kHalf ? __fadd_rn(y, __fmul_rn(f[row][col + kHalf], sn[col + kHalf]))
                         : __fsub_rn(y, __fmul_rn(f[row][col - kHalf], sn[col - kHalf]));
    }
    *reinterpret_cast<uint32_t*>(out + row * row_stride + c) = pack_bf16x2(o[0], o[1]);
  }
}

template <int D, int W>
__global__ void __launch_bounds__(2 * W)
    fused_window_attention_bwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ cos,
                                      const float* __restrict__ sin, const int* __restrict__ ids,
                                      const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                                      int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sm = *reinterpret_cast<FusedBwdSmem<D, W>*>(smem);
  const int n = blockIdx.x;
  const int hd = heads * D;
  const long long row_stride = 3LL * hd;
  const bf16* base = qkv + static_cast<long long>(n) * W * row_stride;
  const float* cs = cos + static_cast<long long>(n) * W * D;
  const float* sn = sin + static_cast<long long>(n) * W * D;
  const bf16* dob = dout + static_cast<long long>(n) * W * hd;
  bf16* out = dqkv + static_cast<long long>(n) * W * row_stride;
  for (int i = threadIdx.x; i < W; i += blockDim.x) sm.id[i] = ids[static_cast<long long>(n) * W + i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r = warp * 16 + g;
  constexpr int kN = W / 8;

  for (int h = 0; h < heads; ++h) {
    __syncthreads();
    load_rope_tile<D, 2 * W>(sm.q, base + h * D, row_stride, cs, sn, 0, W, W);
    load_rope_tile<D, 2 * W>(sm.k, base + hd + h * D, row_stride, cs, sn, 0, W, W);
    load_tile<D, 2 * W>(sm.v, base + 2 * hd + h * D, row_stride, 0, W, W);
    load_tile<D, 2 * W>(sm.dout, dob + h * D, hd, 0, W, W);
    __syncthreads();

    // This warp's 16 query rows against all W keys.
    const int rtag[2] = {sm.id[r], sm.id[r + 8]};
    float s[kN][4], dp[kN][4];
    scores_smem<D, kN>(s, sm.q, warp * 16, sm.k);
    scores_smem<D, kN>(dp, sm.dout, warp * 16, sm.v);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1), half = e >> 1;
        s[nt][e] = visible<kSegment>(rtag[half], sm.id[c], c)
                       ? score<kSegment>(s[nt][e], rtag[half], scale) : kNegInf;
        mx[half] = fmaxf(mx[half], s[nt][e]);
      }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) mx[half] = quad_max(mx[half]);
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1), half = e >> 1;
        s[nt][e] = visible<kSegment>(rtag[half], sm.id[c], c) ? expf(s[nt][e] - mx[half]) : 0.f;
        l[half] += s[nt][e];
      }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) l[half] = quad_sum(l[half]);
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = s[nt][e] / l[e >> 1];
        rs[e >> 1] += dp[nt][e] * s[nt][e];
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) rs[half] = quad_sum(rs[half]);
#pragma unroll
    for (int nt = 0; nt < kN; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - rs[e >> 1]) * scale;
      const int c = nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(&sm.p[r][c]) = pack_bf16x2(s[nt][0], s[nt][1]);
      *reinterpret_cast<uint32_t*>(&sm.p[r + 8][c]) = pack_bf16x2(s[nt][2], s[nt][3]);
      *reinterpret_cast<uint32_t*>(&sm.ds[r][c]) = pack_bf16x2(dp[nt][0], dp[nt][1]);
      *reinterpret_cast<uint32_t*>(&sm.ds[r + 8][c]) = pack_bf16x2(dp[nt][2], dp[nt][3]);
    }
    {
      float dq[D / 8][4] = {};
      accumulate_xb<D, kN>(dq, dp, sm.k);  // dq = ds @ k
      stage_frags<D, W>(sm.f, dq, warp * 16);
    }
    __syncthreads();
    rope_transpose_store<D, W>(sm.f, cs, sn, out + h * D, row_stride);
    __syncthreads();

    // This warp's 16 key rows: dk = ds^T @ q, dv = p^T @ dout.
    float dk[D / 8][4] = {}, dv[D / 8][4] = {};
#pragma unroll
    for (int kt = 0; kt < W / 16; ++kt) {
      const int i0 = kt * 16 + 2 * t;
      const uint32_t ads[4] = {ld_pair(&sm.ds[i0][r], &sm.ds[i0 + 1][r]),
                               ld_pair(&sm.ds[i0][r + 8], &sm.ds[i0 + 1][r + 8]),
                               ld_pair(&sm.ds[i0 + 8][r], &sm.ds[i0 + 9][r]),
                               ld_pair(&sm.ds[i0 + 8][r + 8], &sm.ds[i0 + 9][r + 8])};
      const uint32_t ap[4] = {ld_pair(&sm.p[i0][r], &sm.p[i0 + 1][r]),
                              ld_pair(&sm.p[i0][r + 8], &sm.p[i0 + 1][r + 8]),
                              ld_pair(&sm.p[i0 + 8][r], &sm.p[i0 + 9][r]),
                              ld_pair(&sm.p[i0 + 8][r + 8], &sm.p[i0 + 9][r + 8])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int col = dt * 8 + g;
        mma_16816(dk[dt], ads, ld_pair(&sm.q[i0][col], &sm.q[i0 + 1][col]),
                  ld_pair(&sm.q[i0 + 8][col], &sm.q[i0 + 9][col]));
        mma_16816(dv[dt], ap, ld_pair(&sm.dout[i0][col], &sm.dout[i0 + 1][col]),
                  ld_pair(&sm.dout[i0 + 8][col], &sm.dout[i0 + 9][col]));
      }
    }
    store_frags<D>(dv, 1.f, warp * 16, W,
                   [&](int row) { return out + row * row_stride + 2 * hd + h * D; });
    stage_frags<D, W>(sm.f, dk, warp * 16);
    __syncthreads();
    rope_transpose_store<D, W>(sm.f, cs, sn, out + hd + h * D, row_stride);
  }
}

template <int D, int W>
cudaError_t launch_fused_bwd(const void* qkv, const void* cos, const void* sin, const void* ids,
                             const void* dout, void* dqkv, int n, int heads, float scale,
                             cudaStream_t stream) {
  constexpr size_t smem = sizeof(FusedBwdSmem<D, W>);
  cudaError_t err = allow_smem(fused_window_attention_bwd_kernel<D, W>, smem);
  if (err != cudaSuccess) return err;
  fused_window_attention_bwd_kernel<D, W><<<n, 2 * W, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<const int*>(ids),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv), heads, scale);
  return cudaGetLastError();
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
