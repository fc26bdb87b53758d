// ViT window (segment) attention for Hopper (sm_90a): K1 and K2.
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

// Rows [r0, r0 + kKeys) of one head's q or k slice (row i at
// src + i * row_stride), rotated by the per-row cos/sin tables in f32 and
// rounded to bf16: y = x * cos + rotate_half(x) * sin with
// rotate_half([x1, x2]) = [-x2, x1]. Explicit _rn intrinsics keep the
// compiler from contracting into an FMA, so the rounding matches the plain
// version op for op.
template <int D>
__device__ __forceinline__ void load_rope_tile(Tile<D>& dst, const bf16* src,
                                               long long row_stride, const float* cos,
                                               const float* sin, int r0, int n_rows) {
  constexpr int kVec = D / 8, kHalf = D / 2;
  for (int i = threadIdx.x; i < kKeys * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows) {
      const bf16* row = src + (r0 + r) * row_stride;
      const uint4 xv = *reinterpret_cast<const uint4*>(row + c);
      const uint4 pv = *reinterpret_cast<const uint4*>(row + (c < kHalf ? c + kHalf : c - kHalf));
      const float* cr = cos + static_cast<long long>(r0 + r) * D + c;
      const float* sr = sin + static_cast<long long>(r0 + r) * D + c;
      const bf16* x = reinterpret_cast<const bf16*>(&xv);
      const bf16* partner = reinterpret_cast<const bf16*>(&pv);
      bf16* y = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = __bfloat162float(partner[j]);
        const float rot = c < kHalf ? -pj : pj;
        y[j] = __float2bfloat16_rn(
            __fadd_rn(__fmul_rn(__bfloat162float(x[j]), cr[j]), __fmul_rn(rot, sr[j])));
      }
    }
    *reinterpret_cast<uint4*>(&dst[r][c]) = packed;
  }
}

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
