// Long-context GQA decode attention for Hopper (sm_90a): K4.
//
// Replaces open_o3_video_tpu/ops/decode_attention.py _decode_kernel: S <= 8
// query rows (a decode step) against a long KV buffer held in its STORED
// dtype, bf16 or fp8 e4m3, read through the batch and token strides of a
// layer view of the stacked (L, B, T, Hkv, D) cache. q (B, S, Hq, D) bf16
// arrives prescaled by D^-1/2 and rounded to bf16 (the wrapper does that, as
// for K3). A key t is visible to a query row iff t <= q_pos and
// kv_valid[b, t] != 0; rows with q_pos = -1, or with no visible key, write 0.
// The softmax is the fixed-m one of attention_tile.cuh: p = exp(min(s, 60)),
// bf16(p) @ v accumulated in f32, one division by l at the end.
//
// What bounds it on the H100: HBM bytes. A decode step reads each written
// key and value once, 2 * t * Hkv * D * itemsize per layer (84 MB at
// t = 81920 in fp8, ~25 us at 3.35 TB/s), and does ~2 FLOP per byte. The
// design:
// - All G * S query rows of one kv head (G = 7, S <= 8: at most 56 of the
//   tile's 64 rows) live in one CTA, so each K/V tile is read from HBM once
//   for the whole GQA group. Warps whose 16 rows are all padding skip the
//   products.
// - B * Hkv is 4 at the serving shape, so the key range is split (split-K)
//   over gridDim.x CTAs to fill the 132 SMs. Each CTA reads its batch row's
//   largest q_pos and divides the 64-key tiles of [0, max_pos] evenly among
//   the splits itself, so a step reads only the written part of the cache.
// - Because the softmax is fixed-m, the splits combine by plain addition of
//   their partial acc (R, D) and l (R) in f32, with no max rescale: each
//   split writes its partials to scratch, and a second small kernel sums
//   them in a fixed order and divides. No atomics: the result is the same
//   bits on every run.
// - fp8 is read at 1 byte per element and converted in registers with
//   Hopper's native e4m3 -> f16x2 conversion, then to bf16 into the shared
//   tile. Every e4m3 value, denormals included, is exact in f16 and in
//   bf16 (3 mantissa bits), so the conversion is exact; the TPU kernel's
//   bit-moving decode and its 2^120 rebase have no counterpart here.
// - Slots past max_pos, or invalid, are never read from HBM: their shared
//   rows are zero-filled, so garbage in the cache tail cannot reach the
//   product (0 * NaN would), and their p is 0 by the mask.
// - Each thread issues all its loads of a K/V tile before it stores any, so
//   a tile costs about one HBM round trip, not one per 16-byte load.
// cp.async double-buffering, TMA and a tuned split count are later work.
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "attention_tile.cuh"

namespace o3v {

using fp8 = __nv_fp8_storage_t;  // one e4m3 byte

// Two e4m3 values (low byte first) -> two bf16 packed as in pack_bf16x2.
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t two) {
  const __half2_raw h =
      __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  return pack_bf16x2(f.x, f.y);
}

// Eight e4m3 values (two words, low byte first) -> eight bf16.
__device__ __forceinline__ uint4 widen(uint32_t lo, uint32_t hi) {
  return make_uint4(e4m3x2_to_bf16x2(lo), e4m3x2_to_bf16x2(lo >> 16), e4m3x2_to_bf16x2(hi),
                    e4m3x2_to_bf16x2(hi >> 16));
}

// The K and V rows [k0, k0 + kKeys) of one kv head (row i at src + i *
// row_stride, D contiguous values) into bf16 shared tiles. Every 16-byte
// load of both tiles is issued before the first store, so a thread has all
// of them in flight at once. Rows whose skey is 0 (past max_pos, past T, or
// an invalid slot) are zero-filled and not read.
template <int D, typename KV>
__device__ __forceinline__ void load_kv_tiles(Tile<D>& dk, Tile<D>& dv, const KV* ksrc,
                                              long long k_stride, const KV* vsrc,
                                              long long v_stride, int k0, const int* skey) {
  constexpr int kElems = 16 / sizeof(KV);        // stored values per 16-byte load
  constexpr int kVec = D / kElems;               // loads per row
  constexpr int kPer = kKeys * kVec / kThreads;  // loads per thread per tile
  uint4 kr[kPer], vr[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / kVec, c = (i % kVec) * kElems;
    kr[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);
    if (skey[r]) {
      kr[j] = *reinterpret_cast<const uint4*>(ksrc + (k0 + r) * k_stride + c);
      vr[j] = *reinterpret_cast<const uint4*>(vsrc + (k0 + r) * v_stride + c);
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / kVec, c = (i % kVec) * kElems;
    if constexpr (sizeof(KV) == 2) {
      *reinterpret_cast<uint4*>(&dk[r][c]) = kr[j];
      *reinterpret_cast<uint4*>(&dv[r][c]) = vr[j];
    } else {  // 16 e4m3 -> two 16-byte bf16 stores
      *reinterpret_cast<uint4*>(&dk[r][c]) = widen(kr[j].x, kr[j].y);
      *reinterpret_cast<uint4*>(&dk[r][c + 8]) = widen(kr[j].z, kr[j].w);
      *reinterpret_cast<uint4*>(&dv[r][c]) = widen(vr[j].x, vr[j].y);
      *reinterpret_cast<uint4*>(&dv[r][c + 8]) = widen(vr[j].z, vr[j].w);
    }
  }
}

// One (split, kv head, batch row). Tile row r < n_rows = G * S is query row
// (g, s) = (r / S, r % S) of q-head hk * G + g. Writes the split's partial
// acc (n_rows, D) and l (n_rows) to part_acc / part_l at
// [b][hk][split].
template <int D, typename KV>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const bf16* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v, const int* __restrict__ q_pos,
                        const int* __restrict__ kv_valid, float* __restrict__ part_acc,
                        float* __restrict__ part_l, int s_len, int t_len, int hq, int group,
                        int n_rows, long long k_stride_b, long long k_stride_t,
                        long long v_stride_b, long long v_stride_t) {
  __shared__ __align__(16) Tile<D> sk;
  __shared__ __align__(16) Tile<D> sv;
  __shared__ int skey[kKeys];
  __shared__ int spos[kRows];
  const int split = blockIdx.x, splits = gridDim.x, hk = blockIdx.y, hkv = gridDim.y;
  const int b = blockIdx.z;
  const int* pos = q_pos + static_cast<long long>(b) * s_len;
  const int* valid = kv_valid + static_cast<long long>(b) * t_len;
  const KV* kb = k + b * k_stride_b + hk * D;
  const KV* vb = v + b * v_stride_b + hk * D;

  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < kRows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) {
      const long long row = (static_cast<long long>(b) * s_len + r % s_len) * hq + hk * group + r / s_len;
      val = *reinterpret_cast<const uint4*>(q + row * D + c);
    }
    *reinterpret_cast<uint4*>(&sk[r][c]) = val;
  }
  if (threadIdx.x < kRows) spos[threadIdx.x] = threadIdx.x < n_rows ? pos[threadIdx.x % s_len] : -1;
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, sk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
  const int row_tag[2] = {spos[r0], spos[r0 + 8]};
  const bool busy = warp * 16 < n_rows;  // this warp holds a real query row
  int max_pos = -1;
  for (int s = 0; s < s_len; ++s) max_pos = max(max_pos, pos[s]);
  const int k_end = min(t_len, max_pos + 1);  // keys past every row's position are never read
  const int n_tiles = (k_end + kKeys - 1) / kKeys;
  const int tile0 = static_cast<int>(static_cast<long long>(split) * n_tiles / splits);
  const int tile1 = static_cast<int>(static_cast<long long>(split + 1) * n_tiles / splits);

  float acc[D / 8][4] = {};
  float l[2] = {0.f, 0.f};
  for (int tile = tile0; tile < tile1; ++tile) {
    const int k0 = tile * kKeys;
    __syncthreads();  // the previous tile is consumed
    if (threadIdx.x < kKeys)
      skey[threadIdx.x] = k0 + threadIdx.x < k_end ? valid[k0 + threadIdx.x] : 0;
    __syncthreads();
    load_kv_tiles<D, KV>(sk, sv, kb, k_stride_t, vb, v_stride_t, k0, skey);
    __syncthreads();
    if (busy) attend_tile<D, true>(qa, sk, sv, skey, k0, row_tag, 1.0f, acc, l);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
  }
  const long long part = (static_cast<long long>(b * hkv + hk) * splits + split) * n_rows;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= n_rows) continue;
    float* pa = part_acc + (part + r) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<float2*>(pa + dt * 8 + 2 * t) =
          make_float2(acc[dt][2 * half], acc[dt][2 * half + 1]);
    if (t == 0) part_l[part + r] = l[half];
  }
}

// Sums the splits' partials in split order and divides: one CTA of D
// threads per (query row, kv head, batch row).
template <int D>
__global__ void __launch_bounds__(D)
    decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_l,
                          bf16* __restrict__ out, int s_len, int hq, int group, int splits,
                          int n_rows) {
  const int r = blockIdx.x, hk = blockIdx.y, hkv = gridDim.y, b = blockIdx.z;
  const long long first = static_cast<long long>(b * hkv + hk) * splits * n_rows + r;
  float acc = 0.f, l = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) {
    const long long at = first + static_cast<long long>(s) * n_rows;
    acc += part_acc[at * D + threadIdx.x];
    l += part_l[at];
  }
  const long long row = (static_cast<long long>(b) * s_len + r % s_len) * hq + hk * group + r / s_len;
  out[row * D + threadIdx.x] = __float2bfloat16_rn(acc / (l == 0.f ? 1.f : l));
}

template <int D, typename KV>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const void* q_pos,
                          const void* kv_valid, void* out, void* part_acc, void* part_l, int b,
                          int s_len, int t_len, int hq, int hkv, int splits,
                          long long k_stride_b, long long k_stride_t, long long v_stride_b,
                          long long v_stride_t, cudaStream_t stream) {
  const int group = hq / hkv, n_rows = group * s_len;
  decode_split_kernel<D, KV><<<dim3(splits, hkv, b), kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_valid),
      static_cast<float*>(part_acc), static_cast<float*>(part_l), s_len, t_len, hq, group, n_rows,
      k_stride_b, k_stride_t, v_stride_b, v_stride_t);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<D><<<dim3(n_rows, hkv, b), D, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_l),
      static_cast<bf16*>(out), s_len, hq, group, splits, n_rows);
  return cudaGetLastError();
}

}  // namespace o3v

// Plain C interface (loaded with ctypes); returns cudaGetLastError() after
// the two launches. Strides are in elements of the stored dtype (bytes for
// fp8). part_acc (B, Hkv, splits, G*S, D) and part_l (B, Hkv, splits, G*S)
// are f32 scratch. Built for the decoder's head_dim of 128 only, and for at
// most 64 query rows (G * S) per kv head.
extern "C" int o3v_decode_attention_gqa(const void* q, const void* k, const void* v,
                                        const void* q_pos, const void* kv_valid, void* out,
                                        void* part_acc, void* part_l, int b, int s_len, int t_len,
                                        int hq, int hkv, int head_dim, int kv_fp8, int splits,
                                        long long k_stride_b, long long k_stride_t,
                                        long long v_stride_b, long long v_stride_t,
                                        void* stream) {
  if (head_dim != 128 || hkv < 1 || hq % hkv != 0 || (hq / hkv) * s_len > o3v::kRows ||
      s_len < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_fp8)
    return o3v::launch_decode<128, o3v::fp8>(q, k, v, q_pos, kv_valid, out, part_acc, part_l, b,
                                             s_len, t_len, hq, hkv, splits, k_stride_b,
                                             k_stride_t, v_stride_b, v_stride_t, st);
  return o3v::launch_decode<128, o3v::bf16>(q, k, v, q_pos, kv_valid, out, part_acc, part_l, b,
                                            s_len, t_len, hq, hkv, splits, k_stride_b, k_stride_t,
                                            v_stride_b, v_stride_t, st);
}
