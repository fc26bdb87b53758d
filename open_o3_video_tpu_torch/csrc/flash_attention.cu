// Causal GQA flash attention forward for Hopper (sm_90a): K3, in its
// inference (fixed-m) and training (exact, with lse) modes.
//
// Replaces open_o3_video_tpu/ops/flash_attention.py _fwd_kernel, the decoder
// prefill at the inference (fixed-m) setting. q (B, S, Hq, D) bf16 arrives
// prescaled by D^-1/2 and rounded to bf16 (the wrapper does that, as the JAX
// wrapper does). k/v are (B, T, Hkv, D) bf16 read through their batch and
// token strides, so a layer view of the stacked (L, B, T, Hkv, D) KV cache is
// consumed in place: no repeat over the GQA group, no transpose copy. A key t
// is visible to a query row iff t <= q_pos and kv_valid[b, t] != 0; pad rows
// carry q_pos = -1 and see nothing (output 0).
//
// What bounds it on the H100: at the slice's prefill (S ~ 2k, D = 128) it is
// compute-bound (~56 GFLOP of products for B = 2), and the K/V of one batch
// row (~4 MB) stays in L2 across the query tiles that re-read it. The design
// skips every key tile past the tile's largest q_pos (causal skip: about half
// the products), keeps scores and probabilities in registers, and runs the
// products on bf16 tensor cores through mma.sync. One CTA per (query tile,
// q-head, batch row) - simpler than the TPU kernel's GQA-grouped program,
// which shares each K/V tile across the 7 heads of a group; the group's heads
// find the tile in L2 instead. TMA, wgmma and warp specialisation are later
// work.
#include "attention_tile.cuh"

namespace o3v {

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const int* __restrict__ q_pos,
                           const int* __restrict__ kv_valid, bf16* __restrict__ out, int s_len,
                           int t_len, int hq, int group, long long k_stride_b,
                           long long k_stride_t, long long v_stride_b, long long v_stride_t) {
  __shared__ __align__(16) Tile<D> sk;
  __shared__ __align__(16) Tile<D> sv;
  __shared__ int skey[kKeys];
  __shared__ int spos[kRows];
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const long long q_stride = static_cast<long long>(hq) * D;
  const long long q_off = static_cast<long long>(b) * s_len * q_stride + h * D;
  const bf16* kb = k + b * k_stride_b + hk * D;
  const bf16* vb = v + b * v_stride_b + hk * D;
  const int* valid = kv_valid + static_cast<long long>(b) * t_len;
  const int* pos = q_pos + static_cast<long long>(b) * s_len;

  if (threadIdx.x < kRows) spos[threadIdx.x] = q0 + threadIdx.x < s_len ? pos[q0 + threadIdx.x] : -1;
  load_tile<D>(sk, q + q_off, q_stride, q0, s_len);
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, sk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = warp * 16 + (lane >> 2);
  const int row_tag[2] = {spos[r], spos[r + 8]};
  int max_pos = -1;
  for (int i = 0; i < kRows; ++i) max_pos = max(max_pos, spos[i]);
  // Causal skip: key tiles past the largest query position do no work.
  const int k_end = min(t_len, max_pos + 1);

  float acc[D / 8][4] = {};
  float l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    __syncthreads();
    load_tile<D>(sk, kb, k_stride_t, k0, t_len);
    load_tile<D>(sv, vb, v_stride_t, k0, t_len);
    if (threadIdx.x < kKeys)
      skey[threadIdx.x] = k0 + threadIdx.x < t_len ? valid[k0 + threadIdx.x] : 0;
    __syncthreads();
    attend_tile<D, true>(qa, sk, sv, skey, k0, row_tag, 1.0f, acc, l);
  }
  bf16* ob = out + q_off;
  store_rows<D>(acc, l, q0, s_len, [&](int row) { return ob + row * q_stride; });
}

// Exact mode (training): the JAX _fwd_kernel with exact_softmax=True. Per
// 64-key tile: the tile's row max (NEG_INF where masked), m_new = max(m,
// tile max), acc and l rescaled by exp(m - m_new), p = exp(s - m_new) where
// visible (0 elsewhere: a fully masked row keeps l == 0), acc += bf16(p) @ v.
// At the end out = acc / l (0 where l == 0) and lse = m + log(l), NEG_INF
// where l == 0, for K5's recompute.
template <int D>
__device__ __forceinline__ void attend_tile_online(const uint32_t (&qa)[D / 16][4],
                                                   Tile<D>& sk, Tile<D>& sv,
                                                   const int* key_tag, int k0,
                                                   const int (&row_pos)[2],
                                                   float (&acc)[D / 8][4], float (&m)[2],
                                                   float (&l)[2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int kN = kKeys / 8;
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
      const int c = nt * 8 + 2 * t + (e & 1);
      if (!visible<kCausal>(row_pos[e >> 1], key_tag[c], k0 + c)) s[nt][e] = kNegInf;
      tmax[e >> 1] = fmaxf(tmax[e >> 1], s[nt][e]);
    }
  }
  float alpha[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float m_new = fmaxf(m[half], quad_max(tmax[half]));
    alpha[half] = expf(m[half] - m_new);
    m[half] = m_new;
    l[half] *= alpha[half];
  }
#pragma unroll
  for (int nt = 0; nt < kN; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = nt * 8 + 2 * t + (e & 1);
      const int half = e >> 1;
      const float p = visible<kCausal>(row_pos[half], key_tag[c], k0 + c)
                          ? expf(s[nt][e] - m[half]) : 0.f;
      l[half] += p;
      s[nt][e] = p;
    }
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] *= alpha[0];
    acc[dt][1] *= alpha[0];
    acc[dt][2] *= alpha[1];
    acc[dt][3] *= alpha[1];
  }
  accumulate_xb<D, kN>(acc, s, sv);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_exact_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const int* __restrict__ q_pos,
                                 const int* __restrict__ kv_valid, bf16* __restrict__ out,
                                 float* __restrict__ lse, int s_len, int t_len, int hq, int group,
                                 long long k_stride_b, long long k_stride_t,
                                 long long v_stride_b, long long v_stride_t) {
  __shared__ __align__(16) Tile<D> sk;
  __shared__ __align__(16) Tile<D> sv;
  __shared__ int skey[kKeys];
  __shared__ int spos[kRows];
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const long long q_stride = static_cast<long long>(hq) * D;
  const long long q_off = static_cast<long long>(b) * s_len * q_stride + h * D;
  const bf16* kb = k + b * k_stride_b + hk * D;
  const bf16* vb = v + b * v_stride_b + hk * D;
  const int* valid = kv_valid + static_cast<long long>(b) * t_len;
  const int* pos = q_pos + static_cast<long long>(b) * s_len;

  if (threadIdx.x < kRows) spos[threadIdx.x] = q0 + threadIdx.x < s_len ? pos[q0 + threadIdx.x] : -1;
  load_tile<D>(sk, q + q_off, q_stride, q0, s_len);
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, sk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = warp * 16 + (lane >> 2);
  const int row_pos[2] = {spos[r], spos[r + 8]};
  int max_pos = -1;
  for (int i = 0; i < kRows; ++i) max_pos = max(max_pos, spos[i]);
  const int k_end = min(t_len, max_pos + 1);

  float acc[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    __syncthreads();
    load_tile<D>(sk, kb, k_stride_t, k0, t_len);
    load_tile<D>(sv, vb, v_stride_t, k0, t_len);
    if (threadIdx.x < kKeys)
      skey[threadIdx.x] = k0 + threadIdx.x < t_len ? valid[k0 + threadIdx.x] : 0;
    __syncthreads();
    attend_tile_online<D>(qa, sk, sv, skey, k0, row_pos, acc, m, l);
  }
  bf16* ob = out + q_off;
  store_rows<D>(acc, l, q0, s_len, [&](int row) { return ob + row * q_stride; });
  if ((lane & 3) == 0) {  // store_rows has summed l over the quad
    float* lb = lse + (static_cast<long long>(b) * hq + h) * s_len;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + r + 8 * half;
      if (row < s_len) lb[row] = l[half] == 0.f ? kNegInf : m[half] + logf(l[half]);
    }
  }
}

template <int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, const void* q_pos,
                         const void* kv_valid, void* out, int b, int s_len, int t_len, int hq,
                         int hkv, long long k_stride_b, long long k_stride_t,
                         long long v_stride_b, long long v_stride_t, cudaStream_t stream) {
  const dim3 grid((s_len + kRows - 1) / kRows, hq, b);
  flash_attention_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_valid), static_cast<bf16*>(out),
      s_len, t_len, hq, hq / hkv, k_stride_b, k_stride_t, v_stride_b, v_stride_t);
  return cudaGetLastError();
}


template <int D>
cudaError_t launch_flash_exact(const void* q, const void* k, const void* v, const void* q_pos,
                               const void* kv_valid, void* out, void* lse, int b, int s_len,
                               int t_len, int hq, int hkv, long long k_stride_b,
                               long long k_stride_t, long long v_stride_b, long long v_stride_t,
                               cudaStream_t stream) {
  const dim3 grid((s_len + kRows - 1) / kRows, hq, b);
  flash_attention_exact_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_valid), static_cast<bf16*>(out),
      static_cast<float*>(lse), s_len, t_len, hq, hq / hkv, k_stride_b, k_stride_t, v_stride_b,
      v_stride_t);
  return cudaGetLastError();
}

}  // namespace o3v

// Plain C interface (loaded with ctypes); returns cudaGetLastError() after the
// launch. Strides are in elements. Built for the decoder's head_dim of 128 only.
extern "C" int o3v_flash_attention_gqa(const void* q, const void* k, const void* v,
                                       const void* q_pos, const void* kv_valid, void* out, int b,
                                       int s_len, int t_len, int hq, int hkv, int head_dim,
                                       long long k_stride_b, long long k_stride_t,
                                       long long v_stride_b, long long v_stride_t,
                                       void* stream) {
  if (head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  return o3v::launch_flash<128>(q, k, v, q_pos, kv_valid, out, b, s_len, t_len, hq, hkv,
                                k_stride_b, k_stride_t, v_stride_b, v_stride_t,
                                static_cast<cudaStream_t>(stream));
}

// Exact mode: as above, plus lse (B, Hq, S) float32.
extern "C" int o3v_flash_attention_gqa_exact(const void* q, const void* k, const void* v,
                                             const void* q_pos, const void* kv_valid, void* out,
                                             void* lse, int b, int s_len, int t_len, int hq,
                                             int hkv, int head_dim, long long k_stride_b,
                                             long long k_stride_t, long long v_stride_b,
                                             long long v_stride_t, void* stream) {
  if (head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  return o3v::launch_flash_exact<128>(q, k, v, q_pos, kv_valid, out, lse, b, s_len, t_len, hq,
                                      hkv, k_stride_b, k_stride_t, v_stride_b, v_stride_t,
                                      static_cast<cudaStream_t>(stream));
}
