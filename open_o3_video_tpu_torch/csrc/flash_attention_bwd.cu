// Causal GQA flash attention backward for Hopper (sm_90a): K5.
//
// Replaces open_o3_video_tpu/ops/flash_attention.py _bwd_dq_kernel and
// _bwd_dkv_kernel, the decoder's FlashAttention-2 backward under training.
// The two kernels are attention_bwd.cuh's, in causal mode: q arrives
// prescaled by D^-1/2 and rounded to bf16 exactly as the forward saw it, so
// the recomputed p = exp(q.k - lse) matches the forward's; dq carries the
// explicit D^-1/2, dk none (the prescale holds it), and dk/dv are reduced
// over the 7 query heads of each kv head inside one CTA. Rows past a row's
// right padding (kv_valid 0) take no part; a query at position -1 gets
// dq = 0. What bounds them, and the design: see attention_bwd.cuh.
#include "attention_bwd.cuh"

namespace {

o3v::BwdArgs causal_args(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, const void* q_pos,
                         const void* kv_valid, int s_len, int t_len, int hq, int hkv) {
  o3v::BwdArgs a{};
  a.q = static_cast<const o3v::bf16*>(q);
  a.k = static_cast<const o3v::bf16*>(k);
  a.v = static_cast<const o3v::bf16*>(v);
  a.dout = static_cast<const o3v::bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.q_tag = static_cast<const int*>(q_pos);
  a.k_tag = static_cast<const int*>(kv_valid);
  a.s_len = s_len;
  a.t_len = t_len;
  a.hq = hq;
  a.hkv = hkv;
  a.s_scale = 1.f;
  a.dq_scale = 1.f / sqrtf(128.f);
  a.dk_scale = 1.f;
  return a;
}

}  // namespace

// Plain C interface (loaded with ctypes); each returns cudaGetLastError()
// after its launch. q (prescaled), dout, dq: (B, S, Hq, D); k, v, dk, dv:
// (B, T, Hkv, D), all contiguous bf16; lse, delta: (B, Hq, S) float32;
// q_pos (B, S), kv_valid (B, T) int32. Built for head_dim 128 only.
extern "C" int o3v_flash_attention_gqa_bwd_dq(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* delta, const void* q_pos,
                                              const void* kv_valid, void* dq, int b, int s_len,
                                              int t_len, int hq, int hkv, int head_dim,
                                              void* stream) {
  if (head_dim != 128 || hq % hkv) return static_cast<int>(cudaErrorInvalidValue);
  o3v::BwdArgs a = causal_args(q, k, v, dout, lse, delta, q_pos, kv_valid, s_len, t_len, hq, hkv);
  a.dq = static_cast<o3v::bf16*>(dq);
  return o3v::launch_bwd_dq<128, o3v::kCausal>(a, b, static_cast<cudaStream_t>(stream));
}

extern "C" int o3v_flash_attention_gqa_bwd_dkv(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse,
                                               const void* delta, const void* q_pos,
                                               const void* kv_valid, void* dk, void* dv, int b,
                                               int s_len, int t_len, int hq, int hkv,
                                               int head_dim, void* stream) {
  if (head_dim != 128 || hq % hkv) return static_cast<int>(cudaErrorInvalidValue);
  o3v::BwdArgs a = causal_args(q, k, v, dout, lse, delta, q_pos, kv_valid, s_len, t_len, hq, hkv);
  a.dk = static_cast<o3v::bf16*>(dk);
  a.dv = static_cast<o3v::bf16*>(dv);
  return o3v::launch_bwd_dkv<128, o3v::kCausal>(a, b, static_cast<cudaStream_t>(stream));
}
