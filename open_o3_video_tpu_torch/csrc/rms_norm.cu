// RMSNorm for Hopper (sm_90a): one pass a row, for every norm of the port's
// decoders (input, post and final norms, Qwen3's per-head q/k norms, Kimi-VL's
// latent kv_norm) and of Qwen2.5-VL's tower, at inference.
//
// Replaces no TPU kernel: the JAX package's rms_norm is plain jnp, which XLA
// fuses into one loop. Eager PyTorch runs the same formula as nine kernels
// (the cast to float32, pow, mean, + eps, rsqrt, mul, the weight's cast, mul,
// the cast back), each through device memory: ~9 launches and ~20 bytes moved
// for each bf16 value. Bound by bytes (2 read and 2 written a value, under an
// operation a byte) or, at a decode step's 8 rows, by the launch itself. The
// design:
// - A row of D bf16 values (D a multiple of 8, rows 16-byte aligned, any row
//   stride, so a view such as Kimi's ckv[..., :512] is read as it lies) is
//   held in registers by a group of 2^tpr_log2 threads, each holding at most
//   kMaxChunks 16-byte chunks (chunk c on thread c mod group); the host
//   (ops/rms_norm.py:plan) picks the group, the rows a CTA and the grid, which
//   walks the rows. The weight is read as stored (bf16 or float32) and widened
//   in registers; it is a few KB, read again for each row from L1, not HBM.
// - The float32 sum of squares is reduced by warp shuffles within the group
//   and, for groups wider than a warp, through shared memory in warp order;
//   then r = rsqrt(sum * (1 / D) + eps) and each value is
//   (float(x) * r) * float(w), rounded once to bf16: the plain version's
//   operations in its order, so only the sum's order differs, and an output
//   lies within one bf16 ulp of the plain one.
// - Each input byte is read once and each output byte written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace o3v {
namespace rmsnorm {

constexpr int kChunk = 8;         // bf16 values a 16-byte load carries
constexpr int kMaxChunks = 4;     // chunks a thread holds (ops/rms_norm.py: MAX_CHUNKS)
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[kChunk]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kChunk / 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ void load_weight(const __nv_bfloat16* w, int c, float (&f)[kChunk]) {
  unpack(*reinterpret_cast<const uint4*>(w + c * kChunk), f);
}

__device__ __forceinline__ void load_weight(const float* w, int c, float (&f)[kChunk]) {
  const float4* p = reinterpret_cast<const float4*>(w + c * kChunk);
  const float4 a = p[0], b = p[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

template <typename W>
__global__ void __launch_bounds__(kMaxThreads) rms_norm_kernel(
    const __nv_bfloat16* __restrict__ x, const W* __restrict__ w, __nv_bfloat16* __restrict__ out,
    long long rows, int chunks, long long x_stride, float inv_d, float eps, int tpr_log2,
    int rows_per_cta) {
  __shared__ float partial[kMaxThreads / 32];
  const int tpr = 1 << tpr_log2;
  const int lane = threadIdx.x & (tpr - 1);  // this thread's place in its row's group
  const int slot = threadIdx.x >> tpr_log2;  // its row among the CTA's rows
  const long long step = static_cast<long long>(gridDim.x) * rows_per_cta;
  // The loop's trip count is the CTA's, so every thread reaches each barrier.
  for (long long first = static_cast<long long>(blockIdx.x) * rows_per_cta; first < rows;
       first += step) {
    const long long row = first + slot;
    const bool live = row < rows;
    const __nv_bfloat16* xr = x + (live ? row : 0) * x_stride;
    uint4 v[kMaxChunks];
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int c = lane + k * tpr;
      v[k] = (live && c < chunks) ? *reinterpret_cast<const uint4*>(xr + c * kChunk)
                                  : make_uint4(0u, 0u, 0u, 0u);
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      float f[kChunk];
      unpack(v[k], f);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) ss += f[j] * f[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < tpr) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    if (tpr > 32) {  // the group spans warps: their partial sums in warp order
      if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
      __syncthreads();
      const int warps = tpr >> 5;
      const float* mine = partial + slot * warps;
      ss = 0.f;
      for (int i = 0; i < warps; ++i) ss += mine[i];
      __syncthreads();  // read before the next rows overwrite them
    }
    const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
    if (!live) continue;
    __nv_bfloat16* o = out + row * (static_cast<long long>(chunks) * kChunk);
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int c = lane + k * tpr;
      if (c >= chunks) continue;
      float f[kChunk], wf[kChunk];
      unpack(v[k], f);
      load_weight(w, c, wf);
      uint4 packed;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int i = 0; i < kChunk / 2; ++i) {
        h[i] = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(f[2 * i], r), wf[2 * i]),
                                     __fmul_rn(__fmul_rn(f[2 * i + 1], r), wf[2 * i + 1]));
      }
      *reinterpret_cast<uint4*>(o + c * kChunk) = packed;
    }
  }
}

}  // namespace rmsnorm
}  // namespace o3v

// x: rows of d bf16 values, x_stride elements apart; w: d values, bf16 or
// (w_f32) float32; out: rows x d bf16, contiguous. Every pointer 16-byte
// aligned, d and x_stride multiples of 8; the group, rows a CTA and grid from
// ops/rms_norm.py:plan.
extern "C" int o3v_rms_norm(const void* x, const void* w, void* out, long long rows, int d,
                            long long x_stride, int w_f32, float eps, int tpr_log2,
                            int rows_per_cta, int grid, void* stream) {
  using namespace o3v::rmsnorm;
  if (tpr_log2 < 0 || tpr_log2 > 10 || rows_per_cta < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tpr = 1 << tpr_log2;
  const long long threads = static_cast<long long>(tpr) * rows_per_cta;
  const int chunks = d / kChunk;
  if (rows < 1 || d < kChunk || d % kChunk || x_stride % kChunk || threads % 32 ||
      threads > kMaxThreads || grid < 1 || chunks > kMaxChunks * tpr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const float inv_d = 1.0f / static_cast<float>(d);
  if (w_f32) {
    rms_norm_kernel<float><<<grid, static_cast<int>(threads), 0, st>>>(
        xb, static_cast<const float*>(w), ob, rows, chunks, x_stride, inv_d, eps, tpr_log2,
        rows_per_cta);
  } else {
    rms_norm_kernel<__nv_bfloat16><<<grid, static_cast<int>(threads), 0, st>>>(
        xb, static_cast<const __nv_bfloat16*>(w), ob, rows, chunks, x_stride, inv_d, eps,
        tpr_log2, rows_per_cta);
  }
  return static_cast<int>(cudaGetLastError());
}
