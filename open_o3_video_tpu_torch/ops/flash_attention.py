"""Causal GQA flash attention forward: K3 (decoder prefill).

Counterpart of ``open_o3_video_tpu/ops/flash_attention.py`` at inference.
Layout: q (B, S, Hq, D), k/v (B, T, Hkv, D), q_positions (B, S), kv_valid
(B, T). Key t is visible to a query iff ``t <= q_position`` and
``kv_valid[b, t]``; a query with no visible key (e.g. q_position -1) returns
0. q is prescaled by D^-1/2 and rounded to its dtype before the scores, as
the JAX wrapper does, so the plain version matches JAX bit for bit in f32.

Softmax is the fixed-m inference form of the TPU kernel: ``p = exp(min(s,
60))``, ``out = (p cast to the compute dtype) @ v / l``, float32
accumulation.

k/v may be strided views of the stacked (L, B, T, Hkv, D) cache: the kernel
reads them through their batch and token strides.
"""

from __future__ import annotations

import torch

from . import kernels

CLAMP = 60.0


def _prescale(q):
    return (q * q.shape[-1] ** -0.5).to(q.dtype)


def flash_attention_gqa_torch(q, k, v, q_positions, kv_valid):
    """Plain version of K3 (and of K4, ``decode_attention``), grouped over
    the GQA heads (no KV repeat): k/v in any float dtype, fp8 included, are
    converted to f32 exactly; p is cast to q's dtype before the PV product.
    Returns (B, S, Hq, D) in q's dtype."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = _prescale(q).float().reshape(B, S, Hkv, Hq // Hkv, D)
    s = torch.einsum("bshgd,bthd->bhgst", qg, k.float())
    t = torch.arange(T, device=q.device)
    mask = (t[None, None, :] <= q_positions[:, :, None]) & (kv_valid[:, None, :] != 0)
    p = torch.where(mask[:, None, None], torch.exp(torch.clamp(s, max=CLAMP)), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgst,bthd->bhgsd", p.to(q.dtype).float(), v.float())
    o = o / torch.where(l == 0.0, 1.0, l)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)


def flash_attention_gqa(q, k, v, q_positions, kv_valid, impl: str = "auto"):
    """K3: causal GQA attention forward. Returns (B, S, Hq, D)."""
    if not kernels.use_kernel(q, impl):
        return flash_attention_gqa_torch(q, k, v, q_positions, kv_valid)
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    kernels.check_head_dim("flash_attention_gqa", D, kernels.TEXT_HEAD_DIM)
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    qs = _prescale(q).contiguous()
    pos = q_positions.to(torch.int32).contiguous()
    valid = kv_valid.to(torch.int32).contiguous()
    kernels.check_tensor("q", qs, torch.bfloat16, (B, S, Hq, D))
    kernels.check_tensor("q_positions", pos, torch.int32, (B, S))
    kernels.check_tensor("kv_valid", valid, torch.int32, (B, T))
    kernels.check_kv("k", k, (B, T, Hkv, D), (torch.bfloat16,))
    kernels.check_kv("v", v, (B, T, Hkv, D), (torch.bfloat16,))
    out = torch.empty_like(qs)
    kernels.launch(
        "flash_attention_gqa", qs.data_ptr(), k.data_ptr(), v.data_ptr(),
        pos.data_ptr(), valid.data_ptr(), out.data_ptr(), B, S, T, Hq, Hkv, D,
        k.stride(0), k.stride(1), v.stride(0), v.stride(1),
    )
    return out
