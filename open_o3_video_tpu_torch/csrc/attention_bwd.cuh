// Backward of exact-softmax attention, FlashAttention-2 form, for Hopper
// (sm_90a): the dq kernel shared by K5 (decoder, causal GQA) and K6's window
// backward (the ViT's 4 global blocks, segment ids over whole frames), and
// K6's dk/dv kernel (K5's causal dk/dv has its own pair of kernels in
// flash_attention_bwd.cu).
//
// Both recompute p = exp(score - lse) from the forward's log-sum-exp, with
// dp = dout @ v^T and delta = rowsum(dout * out) (computed by the caller):
//     ds = bf16(p * (dp - delta))
//     dq = dq_scale * ds @ k              (kernel 1: one CTA per query tile)
//     dk = dk_scale * ds^T @ q            (kernel 2: one CTA per key tile)
//     dv = bf16(p)^T @ dout
// K5 (flash_attention.py _bwd): q arrives prescaled by D^-1/2 and rounded,
// score = q.k, dq_scale = D^-1/2, dk_scale = 1. K6 (window_attention.py
// _bwd_kernel, which holds the whole W x W tile and takes rowsum(dp * p)
// directly): score = D^-1/2 q.k, dq_scale = dk_scale = D^-1/2; with the keys
// tiled, the rowsum comes as delta, equal to it in exact arithmetic.
//
// Kernel 2 loops over every query head of its kv head's group (1 in K6) and
// over the query tiles, so dk/dv are summed over the group in registers and each
// CTA writes its own rows: deterministic, no atomics. Products are bf16
// mma.sync with f32 accumulation; p and ds are rounded to bf16 as operands
// (JAX rounds ds to bf16 in K5; K6's f32 products on the TPU run as bf16
// passes at default precision).
//
// What bounds them on the H100: at the SFT slice's decoder shape (S = T ~
// 3.4k, 28/4 heads of 128) the causal products are ~2.5x the forward's, so
// the pair is compute-bound on paper; the design keeps scores in registers
// and q/dout/k/v tiles in shared memory, and skips causal tiles. No TMA or
// wgmma yet.
#pragma once

#include "attention_tile.cuh"

namespace o3v {

struct BwdArgs {
  const bf16* q;       // (B, S, Hq, D)
  const bf16* k;       // (B, T, Hkv, D)
  const bf16* v;       // (B, T, Hkv, D)
  const bf16* dout;    // (B, S, Hq, D)
  const float* lse;    // (B, Hq, S)
  const float* delta;  // (B, Hq, S)
  const int* q_tag;    // (B, S): positions (causal) or segment ids
  const int* k_tag;    // (B, T): kv validity (causal) or segment ids
  bf16* dq;            // (B, S, Hq, D)
  bf16* dk;            // (B, T, Hkv, D)
  bf16* dv;
  int s_len, t_len, hq, hkv;
  float s_scale, dq_scale, dk_scale;
};

constexpr int kQRows = 32;  // query rows per step of the dk/dv kernel

template <int D>
using QTile = bf16[kQRows][D + kPad];

template <int MODE>
__device__ __forceinline__ int row_tag_at(const int* tags, int i, int n) {
  return i < n ? tags[i] : (MODE == kCausal ? -1 : -2);
}

template <int MODE>
__device__ __forceinline__ int key_tag_at(const int* tags, int j, int n) {
  return j < n ? tags[j] : (MODE == kCausal ? 0 : -1);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return 4 * sizeof(Tile<D>) + (kKeys + kRows) * sizeof(int);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return 2 * sizeof(Tile<D>) + 2 * sizeof(QTile<D>) + kKeys * sizeof(int) +
         kQRows * (sizeof(int) + 2 * sizeof(float));
}

// dq: one CTA per (64-row query tile, query head, batch row); each warp owns
// 16 query rows and walks the key tiles (up to the tile's largest position
// in the causal case).
template <int D, int MODE>
__global__ void __launch_bounds__(kThreads) attention_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile<D>* tiles = reinterpret_cast<Tile<D>*>(smem);
  Tile<D>& sq = tiles[0];
  Tile<D>& sdo = tiles[1];
  Tile<D>& sk = tiles[2];
  Tile<D>& sv = tiles[3];
  int* skey = reinterpret_cast<int*>(tiles + 4);
  int* srow = skey + kKeys;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const long long q_stride = static_cast<long long>(a.hq) * D;
  const long long kv_stride = static_cast<long long>(a.hkv) * D;
  const long long q_off = static_cast<long long>(b) * a.s_len * q_stride + h * D;
  const long long kv_off = static_cast<long long>(b) * a.t_len * kv_stride + hk * D;
  const int* qt = a.q_tag + static_cast<long long>(b) * a.s_len;
  const int* kt = a.k_tag + static_cast<long long>(b) * a.t_len;
  const long long stat = (static_cast<long long>(b) * a.hq + h) * a.s_len;

  load_tile<D>(sq, a.q + q_off, q_stride, q0, a.s_len);
  load_tile<D>(sdo, a.dout + q_off, q_stride, q0, a.s_len);
  if (threadIdx.x < kRows) srow[threadIdx.x] = row_tag_at<MODE>(qt, q0 + threadIdx.x, a.s_len);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r = warp * 16 + g;
  const int rtag[2] = {srow[r], srow[r + 8]};
  float rlse[2], rdelta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r + 8 * half;
    rlse[half] = row < a.s_len ? a.lse[stat + row] : 0.f;
    rdelta[half] = row < a.s_len ? a.delta[stat + row] : 0.f;
  }
  int k_end = a.t_len;
  if (MODE == kCausal) {
    int max_pos = -1;
    for (int i = 0; i < kRows; ++i) max_pos = max(max_pos, srow[i]);
    k_end = min(a.t_len, max_pos + 1);
  }

  constexpr int kN = kKeys / 8;
  float acc[D / 8][4] = {};
  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    __syncthreads();
    load_tile<D>(sk, a.k + kv_off, kv_stride, k0, a.t_len);
    load_tile<D>(sv, a.v + kv_off, kv_stride, k0, a.t_len);
    if (threadIdx.x < kKeys) skey[threadIdx.x] = key_tag_at<MODE>(kt, k0 + threadIdx.x, a.t_len);
    __syncthreads();
    float s[kN][4], dp[kN][4];
    scores_smem<D, kN>(s, sq, warp * 16, sk);
    scores_smem<D, kN>(dp, sdo, warp * 16, sv);
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1), half = e >> 1;
        const float p = visible<MODE>(rtag[half], skey[c], k0 + c)
                            ? expf(score<MODE>(s[nt][e], rtag[half], a.s_scale) - rlse[half])
                            : 0.f;
        s[nt][e] = p * (dp[nt][e] - rdelta[half]);
      }
    accumulate_xb<D, kN>(acc, s, sk);
  }
  store_frags<D>(acc, a.dq_scale, q0 + warp * 16, a.s_len,
                 [&](int row) { return a.dq + q_off + row * q_stride; });
}

// dk, dv: one CTA per (64-key tile, kv head, batch row); each warp owns 16
// keys and computes the transposed blocks s^T = k q^T and dp^T = v dout^T
// against 32 query rows at a time, over every head of the group.
template <int D, int MODE>
__global__ void __launch_bounds__(kThreads) attention_bwd_dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile<D>& sk = *reinterpret_cast<Tile<D>*>(smem);
  Tile<D>& sv = *reinterpret_cast<Tile<D>*>(smem + sizeof(Tile<D>));
  QTile<D>& sq = *reinterpret_cast<QTile<D>*>(smem + 2 * sizeof(Tile<D>));
  QTile<D>& sdo = *reinterpret_cast<QTile<D>*>(smem + 2 * sizeof(Tile<D>) + sizeof(QTile<D>));
  int* skey = reinterpret_cast<int*>(smem + 2 * sizeof(Tile<D>) + 2 * sizeof(QTile<D>));
  int* srow = skey + kKeys;
  float* slse = reinterpret_cast<float*>(srow + kQRows);
  float* sdelta = slse + kQRows;
  const int k0 = blockIdx.x * kKeys, hk = blockIdx.y, b = blockIdx.z;
  const int group = a.hq / a.hkv;
  const long long q_stride = static_cast<long long>(a.hq) * D;
  const long long kv_stride = static_cast<long long>(a.hkv) * D;
  const long long kv_off = static_cast<long long>(b) * a.t_len * kv_stride + hk * D;
  const int* qt = a.q_tag + static_cast<long long>(b) * a.s_len;
  const int* kt = a.k_tag + static_cast<long long>(b) * a.t_len;

  load_tile<D>(sk, a.k + kv_off, kv_stride, k0, a.t_len);
  load_tile<D>(sv, a.v + kv_off, kv_stride, k0, a.t_len);
  if (threadIdx.x < kKeys) skey[threadIdx.x] = key_tag_at<MODE>(kt, k0 + threadIdx.x, a.t_len);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, jr = warp * 16 + g;
  const int ktag[2] = {skey[jr], skey[jr + 8]};

  constexpr int kN = kQRows / 8;
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  for (int gh = 0; gh < group; ++gh) {
    const int h = hk * group + gh;
    const long long q_off = static_cast<long long>(b) * a.s_len * q_stride + h * D;
    const long long stat = (static_cast<long long>(b) * a.hq + h) * a.s_len;
    for (int i0 = 0; i0 < a.s_len; i0 += kQRows) {
      __syncthreads();
      load_tile<D>(sq, a.q + q_off, q_stride, i0, a.s_len, kQRows);
      load_tile<D>(sdo, a.dout + q_off, q_stride, i0, a.s_len, kQRows);
      if (threadIdx.x < kQRows) {
        const int i = i0 + threadIdx.x;
        srow[threadIdx.x] = row_tag_at<MODE>(qt, i, a.s_len);
        slse[threadIdx.x] = i < a.s_len ? a.lse[stat + i] : 0.f;
        sdelta[threadIdx.x] = i < a.s_len ? a.delta[stat + i] : 0.f;
      }
      __syncthreads();
      if (MODE == kCausal) {  // the same decision in every thread
        int max_pos = -1;
        for (int i = 0; i < kQRows; ++i) max_pos = max(max_pos, srow[i]);
        if (max_pos < k0) continue;  // every key of the tile is in these queries' future
      }
      float st[kN][4], dpt[kN][4];
      scores_smem<D, kN>(st, sk, warp * 16, sq);
      scores_smem<D, kN>(dpt, sv, warp * 16, sdo);
#pragma unroll
      for (int nt = 0; nt < kN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = nt * 8 + 2 * t + (e & 1), half = e >> 1;
          const int rt = srow[i];
          const float p = visible<MODE>(rt, ktag[half], k0 + jr + 8 * half)
                              ? expf(score<MODE>(st[nt][e], rt, a.s_scale) - slse[i])
                              : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - sdelta[i]);
        }
      accumulate_xb<D, kN>(dv, st, sdo);
      accumulate_xb<D, kN>(dk, dpt, sq);
    }
  }
  store_frags<D>(dk, a.dk_scale, k0 + warp * 16, a.t_len,
                 [&](int row) { return a.dk + kv_off + row * kv_stride; });
  store_frags<D>(dv, 1.f, k0 + warp * 16, a.t_len,
                 [&](int row) { return a.dv + kv_off + row * kv_stride; });
}

template <int D, int MODE>
cudaError_t launch_bwd_dq(const BwdArgs& a, int b, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = allow_smem(attention_bwd_dq_kernel<D, MODE>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s_len + kRows - 1) / kRows, a.hq, b);
  attention_bwd_dq_kernel<D, MODE><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, int MODE>
cudaError_t launch_bwd_dkv(const BwdArgs& a, int b, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = allow_smem(attention_bwd_dkv_kernel<D, MODE>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + kKeys - 1) / kKeys, a.hkv, b);
  attention_bwd_dkv_kernel<D, MODE><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace o3v
