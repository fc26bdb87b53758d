"""ViT window (segment) attention: K1 (fused rope + window) and K2 (window).

Counterpart of ``open_o3_video_tpu/ops/window_attention.py``. The vision
tower attends within same-size segments: packed 8x8-patch windows (W = 64 or
128 tokens) in the 28 windowed blocks, whole frames in the 4 global blocks.
Segments are batched as (N, W, ...) rows with int32 segment ids (0 = pad);
tokens attend iff their ids match and are nonzero, so several small edge
windows can share one row. Pad rows produce unspecified (finite) values.

Both functions compute the inference softmax of the TPU kernels: fixed
m = 0, ``p = exp(min(s * D^-1/2, 60))``, ``l = sum(p)``, ``out = (p cast to
v's dtype) @ v / l`` with 0 where l == 0, accumulated in float32.

``impl="auto"`` launches the CUDA kernel (``csrc/window_attention.cu``) for
CUDA tensors and runs the plain PyTorch version for CPU tensors;
``impl="torch"`` always runs the plain version (tests and the on-card
comparison).
"""

from __future__ import annotations

import torch

from . import kernels
from .rope import rotate_half

CLAMP = 60.0


def _masked_fixed_m_attention(q, k, v, mask):
    """q (..., Wq, D), k/v (..., Wk, D), mask broadcastable to (..., Wq, Wk).
    Fixed-m softmax in float32; returns float32 (..., Wq, D)."""
    d = q.shape[-1]
    s = (q.float() @ k.float().transpose(-1, -2)) * d**-0.5
    p = torch.where(mask, torch.exp(torch.clamp(s, max=CLAMP)), 0.0)
    l = p.sum(-1, keepdim=True)
    o = p.to(v.dtype).float() @ v.float()
    return o / torch.where(l == 0.0, 1.0, l)


def window_attention_torch(q, k, v, valid):
    """Plain version of K2. q/k/v (N, W, H, D); valid (N, W) bool or int32
    segment ids. Returns (N, W, H, D) in q's dtype."""
    g = valid.to(torch.int32)
    mask = ((g[:, :, None] == g[:, None, :]) & (g[:, None, :] != 0))[:, None]
    o = _masked_fixed_m_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask
    )
    return o.transpose(1, 2).to(q.dtype)


def fused_window_attention_torch(qkv, cos, sin, valid, heads: int):
    """Plain version of K1. qkv (N, W, 3*H*D) raw projection output;
    cos/sin (N, W, D) float32; valid (N, W). Rope runs in float32 and is
    cast back to qkv's dtype before the scores, as the TPU kernel does.
    Returns (N, W, H*D) in qkv's dtype."""
    n, w, three_hd = qkv.shape
    d = three_hd // 3 // heads
    x = qkv.view(n, w, 3, heads, d)
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    q, k = (y * c + rotate_half(y) * s for y in (x[:, :, 0].float(), x[:, :, 1].float()))
    q, k = q.to(qkv.dtype), k.to(qkv.dtype)
    out = window_attention_torch(q, k, x[:, :, 2], valid)
    return out.reshape(n, w, heads * d)


def window_attention(q, k, v, valid, impl: str = "auto"):
    """K2: bidirectional masked attention within same-size segments.
    q/k/v (N, W, H, D); valid (N, W) bool or int32 segment ids."""
    if not kernels.use_kernel(q, impl):
        return window_attention_torch(q, k, v, valid)
    n, w, h, d = q.shape
    kernels.check_head_dim("window_attention", d, kernels.VISION_HEAD_DIM)
    ids = valid.to(torch.int32).contiguous()
    for name, x in (("q", q), ("k", k), ("v", v)):
        kernels.check_tensor(name, x, torch.bfloat16, (n, w, h, d))
    kernels.check_tensor("ids", ids, torch.int32, (n, w))
    out = torch.empty_like(q)
    kernels.launch(
        "window_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ids.data_ptr(), out.data_ptr(), n, w, h, d, d**-0.5,
    )
    return out


def fused_window_attention(qkv, cos, sin, valid, heads: int, impl: str = "auto"):
    """K1: rope + bidirectional masked window attention in one kernel.
    qkv (N, W, 3*H*D); cos/sin (N, W, D) float32; valid (N, W).
    Returns (N, W, H*D)."""
    if not kernels.use_kernel(qkv, impl):
        return fused_window_attention_torch(qkv, cos, sin, valid, heads)
    n, w, three_hd = qkv.shape
    d = three_hd // 3 // heads
    kernels.check_head_dim("fused_window_attention", d, kernels.VISION_HEAD_DIM)
    ids = valid.to(torch.int32).contiguous()
    kernels.check_tensor("qkv", qkv, torch.bfloat16, (n, w, 3 * heads * d))
    kernels.check_tensor("cos", cos, torch.float32, (n, w, d))
    kernels.check_tensor("sin", sin, torch.float32, (n, w, d))
    kernels.check_tensor("ids", ids, torch.int32, (n, w))
    out = torch.empty((n, w, heads * d), dtype=qkv.dtype, device=qkv.device)
    kernels.launch(
        "fused_window_attention", qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        ids.data_ptr(), out.data_ptr(), n, w, heads, d, d**-0.5,
    )
    return out
