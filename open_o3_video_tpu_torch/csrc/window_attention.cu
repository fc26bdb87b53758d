// ViT window (segment) attention for Hopper (sm_90a): K1 and K2, in their
// inference (fixed-m) and training (exact) modes.
//
// K1 fused_window_attention replaces open_o3_video_tpu/ops/window_attention.py
// _fused_fwd_kernel (the 28 windowed blocks of the Qwen2.5-VL tower). It reads
// the raw qkv projection (N, W, 3*H*D) bf16 once, applies the 2D rotary
// embedding to q and k in f32 (cos/sin (N, W, D) f32) and rounds them to bf16
// as it stages them in shared memory, runs masked bidirectional attention
// where ids_q == ids_k != 0 (several packed edge windows share a row), and
// writes (N, W, H*D) bf16 at lane offset h*D: the layout the output
// projection reads. Nothing but qkv in and attn out touches device memory.
//
// K2 window_attention replaces ops/window_attention.py _fwd_kernel (the 4
// global blocks, over whole frames). Same masked attention on q/k/v
// (N, W, H, D) bf16, no rope. The TPU kernel holds the whole W x W score tile
// and falls back to XLA past a size limit; here the keys stream through
// shared memory in 64-row tiles, and with the fixed-m softmax no rescale is
// needed, so every width W runs.
//
// What bounds them on the H100: at the slice's shapes they move little and
// compute little. K1 at W = 64 does about 33 FLOP per byte of qkv read, far
// under the ~295 FLOP/byte at which bf16 tensor cores become the limit, so it
// is bound by device-memory bytes; the design reads qkv exactly once, fuses
// the rope, and keeps scores in registers. K2 at W = 448 re-reads each
// frame's K/V once per 64-row query tile, from L2 (a frame's K/V is ~1.8 MB).
// One CTA per (query tile, head, row); mma.sync bf16 tiles, no TMA or wgmma.
#include "attention_tile.cuh"

namespace o3v {

template <int D>
__global__ void __launch_bounds__(kThreads)
    fused_window_attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ cos,
                                  const float* __restrict__ sin, const int* __restrict__ ids,
                                  bf16* __restrict__ out, int w, int heads, float scale) {
  __shared__ __align__(16) Tile<D> sk;
  __shared__ __align__(16) Tile<D> sv;
  __shared__ int skey[kKeys];
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, n = blockIdx.z;
  const int hd = heads * D;
  const long long row_stride = 3LL * hd;
  const bf16* base = qkv + static_cast<long long>(n) * w * row_stride + h * D;
  const float* cs = cos + static_cast<long long>(n) * w * D;
  const float* sn = sin + static_cast<long long>(n) * w * D;
  const int* id = ids + static_cast<long long>(n) * w;

  load_rope_tile<D>(sk, base, row_stride, cs, sn, q0, w);  // q, staged in the key buffer
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, sk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = q0 + warp * 16 + (lane >> 2);
  const int row_tag[2] = {r < w ? id[r] : 0, r + 8 < w ? id[r + 8] : 0};

  float acc[D / 8][4] = {};
  float l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < w; k0 += kKeys) {
    __syncthreads();
    load_rope_tile<D>(sk, base + hd, row_stride, cs, sn, k0, w);
    load_tile<D>(sv, base + 2 * hd, row_stride, k0, w);
    if (threadIdx.x < kKeys) skey[threadIdx.x] = k0 + threadIdx.x < w ? id[k0 + threadIdx.x] : 0;
    __syncthreads();
    attend_tile<D, false>(qa, sk, sv, skey, k0, row_tag, scale, acc, l);
  }
  bf16* ob = out + static_cast<long long>(n) * w * hd + h * D;
  store_rows<D>(acc, l, q0, w, [&](int row) { return ob + static_cast<long long>(row) * hd; });
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    window_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const int* __restrict__ ids,
                            bf16* __restrict__ out, int w, int heads, float scale) {
  __shared__ __align__(16) Tile<D> sk;
  __shared__ __align__(16) Tile<D> sv;
  __shared__ int skey[kKeys];
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, n = blockIdx.z;
  const long long row_stride = static_cast<long long>(heads) * D;
  const long long off = static_cast<long long>(n) * w * row_stride + h * D;
  const int* id = ids + static_cast<long long>(n) * w;

  load_tile<D>(sk, q + off, row_stride, q0, w);
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, sk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = q0 + warp * 16 + (lane >> 2);
  const int row_tag[2] = {r < w ? id[r] : 0, r + 8 < w ? id[r + 8] : 0};

  float acc[D / 8][4] = {};
  float l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < w; k0 += kKeys) {
    __syncthreads();
    load_tile<D>(sk, k + off, row_stride, k0, w);
    load_tile<D>(sv, v + off, row_stride, k0, w);
    if (threadIdx.x < kKeys) skey[threadIdx.x] = k0 + threadIdx.x < w ? id[k0 + threadIdx.x] : 0;
    __syncthreads();
    attend_tile<D, false>(qa, sk, sv, skey, k0, row_tag, scale, acc, l);
  }
  bf16* ob = out + off;
  store_rows<D>(acc, l, q0, w, [&](int row) { return ob + row * row_stride; });
}

// Exact mode (training): the JAX kernels with exact=True, p = exp(s - m) / l
// normalized BEFORE its cast to bf16 for the PV product. Two passes over the
// key tiles: the first finds each row's max m and sum l (online, rescaling l
// by exp(m_old - m_new)), the second forms p / l -> bf16 -> PV, so the
// rounding of p matches JAX's at any row width (one tile at W = 64, whose
// keys then stay in shared memory for both passes). Scores are masked to
// NEG_INF; a pad row (id 0) scores 0 on all W keys of its row, the uniform
// softmax that JAX's all-NEG_INF row gives.
template <int D, typename LoadKV>
__device__ __forceinline__ void window_exact_rows(const uint32_t (&qa)[D / 16][4], Tile<D>& sk,
                                                  Tile<D>& sv, const int* skey, int w,
                                                  const int (&row_tag)[2], float scale,
                                                  float (&acc)[D / 8][4], float (&m)[2],
                                                  float (&l)[2], LoadKV load_kv) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int kN = kKeys / 8;
  const int n_tiles = (w + kKeys - 1) / kKeys;
  for (int pass = 0; pass < 2; ++pass) {
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kKeys;
      if (n_tiles > 1 || pass == 0) {
        __syncthreads();
        load_kv(k0);
        __syncthreads();
      }
      float s[kN][4];
#pragma unroll
      for (int nt = 0; nt < kN; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const bf16* krow = &sk[nt * 8 + g][kk * 16 + 2 * t];
          mma_16816(s[nt], qa[kk], ld_u32(krow), ld_u32(krow + 8));
        }
      }
      float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kN; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t + (e & 1), half = e >> 1;
          s[nt][e] = visible<kSegment>(row_tag[half], skey[c], k0 + c)
                         ? score<kSegment>(s[nt][e], row_tag[half], scale) : kNegInf;
          tmax[half] = fmaxf(tmax[half], s[nt][e]);
        }
      }
      if (pass == 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float m_new = fmaxf(m[half], quad_max(tmax[half]));
          l[half] *= expf(m[half] - m_new);
          m[half] = m_new;
        }
#pragma unroll
        for (int nt = 0; nt < kN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = nt * 8 + 2 * t + (e & 1), half = e >> 1;
            if (visible<kSegment>(row_tag[half], skey[c], k0 + c))
              l[half] += expf(s[nt][e] - m[half]);
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < kN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = nt * 8 + 2 * t + (e & 1), half = e >> 1;
            s[nt][e] = visible<kSegment>(row_tag[half], skey[c], k0 + c)
                           ? expf(s[nt][e] - m[half]) / l[half] : 0.f;
          }
        accumulate_xb<D, kN>(acc, s, sv);
      }
    }
    if (pass == 0) {
      l[0] = quad_sum(l[0]);
      l[1] = quad_sum(l[1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    fused_window_attention_exact_kernel(const bf16* __restrict__ qkv,
                                        const float* __restrict__ cos,
                                        const float* __restrict__ sin,
                                        const int* __restrict__ ids, bf16* __restrict__ out,
                                        int w, int heads, float scale) {
  __shared__ __align__(16) Tile<D> sk;
  __shared__ __align__(16) Tile<D> sv;
  __shared__ int skey[kKeys];
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, n = blockIdx.z;
  const int hd = heads * D;
  const long long row_stride = 3LL * hd;
  const bf16* base = qkv + static_cast<long long>(n) * w * row_stride + h * D;
  const float* cs = cos + static_cast<long long>(n) * w * D;
  const float* sn = sin + static_cast<long long>(n) * w * D;
  const int* id = ids + static_cast<long long>(n) * w;

  load_rope_tile<D>(sk, base, row_stride, cs, sn, q0, w);
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, sk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = q0 + warp * 16 + (lane >> 2);
  const int row_tag[2] = {r < w ? id[r] : -2, r + 8 < w ? id[r + 8] : -2};

  float acc[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  window_exact_rows<D>(qa, sk, sv, skey, w, row_tag, scale, acc, m, l, [&](int k0) {
    load_rope_tile<D>(sk, base + hd, row_stride, cs, sn, k0, w);
    load_tile<D>(sv, base + 2 * hd, row_stride, k0, w);
    if (threadIdx.x < kKeys) skey[threadIdx.x] = k0 + threadIdx.x < w ? id[k0 + threadIdx.x] : -1;
  });
  bf16* ob = out + static_cast<long long>(n) * w * hd + h * D;
  store_frags<D>(acc, 1.f, q0 + warp * 16, w,
                 [&](int row) { return ob + static_cast<long long>(row) * hd; });
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    window_attention_exact_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const int* __restrict__ ids,
                                  bf16* __restrict__ out, float* __restrict__ lse, int w,
                                  int heads, float scale) {
  __shared__ __align__(16) Tile<D> sk;
  __shared__ __align__(16) Tile<D> sv;
  __shared__ int skey[kKeys];
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, n = blockIdx.z;
  const long long row_stride = static_cast<long long>(heads) * D;
  const long long off = static_cast<long long>(n) * w * row_stride + h * D;
  const int* id = ids + static_cast<long long>(n) * w;

  load_tile<D>(sk, q + off, row_stride, q0, w);
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, sk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = q0 + warp * 16 + (lane >> 2);
  const int row_tag[2] = {r < w ? id[r] : -2, r + 8 < w ? id[r + 8] : -2};

  float acc[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  window_exact_rows<D>(qa, sk, sv, skey, w, row_tag, scale, acc, m, l, [&](int k0) {
    load_tile<D>(sk, k + off, row_stride, k0, w);
    load_tile<D>(sv, v + off, row_stride, k0, w);
    if (threadIdx.x < kKeys) skey[threadIdx.x] = k0 + threadIdx.x < w ? id[k0 + threadIdx.x] : -1;
  });
  bf16* ob = out + off;
  store_frags<D>(acc, 1.f, q0 + warp * 16, w, [&](int row) { return ob + row * row_stride; });
  if ((lane & 3) == 0) {
    float* lb = lse + (static_cast<long long>(n) * heads + h) * w;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (r + 8 * half < w) lb[r + 8 * half] = m[half] + logf(l[half]);
  }
}

template <int D>
cudaError_t launch_fused(const void* qkv, const void* cos, const void* sin, const void* ids,
                         void* out, int n, int w, int heads, float scale, cudaStream_t stream) {
  const dim3 grid((w + kRows - 1) / kRows, heads, n);
  fused_window_attention_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<const int*>(ids), static_cast<bf16*>(out), w,
      heads, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_window(const void* q, const void* k, const void* v, const void* ids, void* out,
                          int n, int w, int heads, float scale, cudaStream_t stream) {
  const dim3 grid((w + kRows - 1) / kRows, heads, n);
  window_attention_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(ids), static_cast<bf16*>(out), w, heads, scale);
  return cudaGetLastError();
}


template <int D>
cudaError_t launch_fused_exact(const void* qkv, const void* cos, const void* sin, const void* ids,
                               void* out, int n, int w, int heads, float scale,
                               cudaStream_t stream) {
  const dim3 grid((w + kRows - 1) / kRows, heads, n);
  fused_window_attention_exact_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<const int*>(ids), static_cast<bf16*>(out), w,
      heads, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_window_exact(const void* q, const void* k, const void* v, const void* ids,
                                void* out, void* lse, int n, int w, int heads, float scale,
                                cudaStream_t stream) {
  const dim3 grid((w + kRows - 1) / kRows, heads, n);
  window_attention_exact_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(ids), static_cast<bf16*>(out), static_cast<float*>(lse), w, heads,
      scale);
  return cudaGetLastError();
}

}  // namespace o3v

// Plain C interface (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success. Both are built for the vision tower's
// head_dim of 80 only.
extern "C" int o3v_fused_window_attention(const void* qkv, const void* cos, const void* sin,
                                          const void* ids, void* out, int n, int w, int heads,
                                          int head_dim, float scale, void* stream) {
  if (head_dim != 80) return static_cast<int>(cudaErrorInvalidValue);
  return o3v::launch_fused<80>(qkv, cos, sin, ids, out, n, w, heads, scale,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int o3v_window_attention(const void* q, const void* k, const void* v, const void* ids,
                                    void* out, int n, int w, int heads, int head_dim, float scale,
                                    void* stream) {
  if (head_dim != 80) return static_cast<int>(cudaErrorInvalidValue);
  return o3v::launch_window<80>(q, k, v, ids, out, n, w, heads, scale,
                                static_cast<cudaStream_t>(stream));
}

// Exact modes (training). window_attention_exact also writes lse (N, H, W)
// float32, the log-sum-exp of each row's masked scores, for K6.
extern "C" int o3v_fused_window_attention_exact(const void* qkv, const void* cos,
                                                const void* sin, const void* ids, void* out,
                                                int n, int w, int heads, int head_dim,
                                                float scale, void* stream) {
  if (head_dim != 80) return static_cast<int>(cudaErrorInvalidValue);
  return o3v::launch_fused_exact<80>(qkv, cos, sin, ids, out, n, w, heads, scale,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" int o3v_window_attention_exact(const void* q, const void* k, const void* v,
                                          const void* ids, void* out, void* lse, int n, int w,
                                          int heads, int head_dim, float scale, void* stream) {
  if (head_dim != 80) return static_cast<int>(cudaErrorInvalidValue);
  return o3v::launch_window_exact<80>(q, k, v, ids, out, lse, n, w, heads, scale,
                                      static_cast<cudaStream_t>(stream));
}
