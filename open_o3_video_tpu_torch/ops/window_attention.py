"""ViT window (segment) attention: K1 (fused rope + window) and K2 (window),
forward and backward (K6).

Counterpart of ``open_o3_video_tpu/ops/window_attention.py``. The vision
tower attends within same-size segments: packed 8x8-patch windows (W = 64 or
128 tokens) in Qwen2.5-VL's 28 windowed blocks, whole frames in its 4 global
blocks and in every block of Qwen2-VL's and Qwen3-VL's towers.
Segments are batched as (N, W, ...) rows with int32 segment ids (0 = pad);
tokens attend iff their ids match and are nonzero, so several small edge
windows can share one row.

K2 (both modes) and K6's whole-frame dq and dk/dv are built for head_dim
72 (Qwen3-VL's tower, where every block attends over whole frames) and 80;
K1 and K6's fused backward, the windowed blocks' kernels, for 80 alone, and
raise ValueError at 72.

Two forward modes, picked as the JAX package's ``custom_vjp`` picks them:

- inference (no input needs a gradient): the fixed-m softmax of the TPU
  kernels, ``p = exp(min(s * D^-1/2, 60))``, ``out = (p cast to v's dtype)
  @ v / l`` with 0 where l == 0 (pad rows);
- training: the exact softmax of the JAX kernels, ``p = exp(s - max) / l``
  normalized BEFORE its cast to v's dtype for the PV product. Scores are
  masked with a finite NEG_INF, so a pad row (id 0), which sees no key,
  attends uniformly to all W keys of its row, as in JAX; its output is
  unspecified but finite, and nothing reads it.

The backward (K6) recomputes the in-window softmax: ``ds = p * (dp -
rowsum(dp * p)) * scale``, ``dq = ds @ k``, ``dk = ds^T @ q``, ``dv = p^T @
dout``. For K1 it also applies the rope transpose and writes one dqkv row.
cos/sin and the ids get no gradient.

``impl="auto"`` launches the CUDA kernels (``csrc/window_attention*.cu``)
for CUDA tensors and runs the plain PyTorch versions for CPU tensors;
``impl="torch"`` always runs the plain versions.
"""

from __future__ import annotations

import torch

from . import kernels
from .flash_attention import NEG_INF, needs_grad
from .rope import rotate_half

CLAMP = 60.0
# Row widths the fused backward kernel is built for (the 7B tower's packed
# window rows: 4x4 merged positions x 4 patches, one or two windows a row).
FUSED_BWD_WIDTHS = (64, 128)


def row_items(n: int, heads: int) -> list[tuple[int, int]]:
    """The (row, head) item of each CTA of K1's and K6's row kernels (W = 64
    and 128; ``csrc/window_row.cuh``), in launch order, as they decode
    ``blockIdx.x``: one head of one row a CTA."""
    return [(b // heads, b % heads) for b in range(n * heads)]


def _segment_mask(valid):
    g = valid.to(torch.int32)
    return ((g[:, :, None] == g[:, None, :]) & (g[:, None, :] != 0))[:, None]


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
    o = _masked_fixed_m_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), _segment_mask(valid)
    )
    return o.transpose(1, 2).to(q.dtype)


def _exact_probs(q, k, mask):
    """(p (N, H, Wq, Wk) float32, m, l) of the JAX exact kernels; q/k are
    (N, H, W, D)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    return e / l, m, l


def window_attention_exact_torch(q, k, v, valid):
    """Plain version of K2's exact mode (JAX ``_fwd_kernel`` with
    ``exact=True``). Returns (out (N, W, H, D) in q's dtype, lse (N, H, W)
    float32, the log-sum-exp of the masked scores, which K6's kernel reads)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    p, m, l = _exact_probs(qt, kt, _segment_mask(valid))
    o = p.to(v.dtype).float() @ vt.float()
    # A pad row scores NEG_INF on every key, i.e. 0 relative to its max: its
    # lse is log(W), as the kernel writes it, so p = exp(0 - lse) stays 1/W.
    lse = torch.where(m == NEG_INF, 0.0, m) + torch.log(l)
    return o.transpose(1, 2).to(q.dtype), lse[..., 0]


def _window_bwd_f32(q, k, v, valid, do):
    """The JAX ``_bwd_kernel`` in float32 on (N, W, H, D) operands; returns
    float32 (dq, dk, dv) (N, W, H, D)."""
    qt, kt, vt = (x.transpose(1, 2).float() for x in (q, k, v))
    dot = do.transpose(1, 2).float()
    scale = q.shape[-1] ** -0.5
    p, _, _ = _exact_probs(qt, kt, _segment_mask(valid))
    dv = p.transpose(-1, -2) @ dot
    dp = dot @ vt.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dq = ds @ kt
    dk = ds.transpose(-1, -2) @ qt
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


def window_attention_bwd_torch(q, k, v, valid, dout):
    """Plain version of K6's window backward (JAX ``_bwd_kernel``, all
    products in float32). Returns (dq, dk, dv) in q's dtype."""
    return tuple(x.to(q.dtype) for x in _window_bwd_f32(q, k, v, valid, dout))


def _rope_qk(qkv, cos, sin, heads):
    """Roped q and k (N, W, H, D) in qkv's dtype (rope in float32), and v."""
    n, w, three_hd = qkv.shape
    d = three_hd // 3 // heads
    x = qkv.view(n, w, 3, heads, d)
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    q, k = (y * c + rotate_half(y) * s for y in (x[:, :, 0].float(), x[:, :, 1].float()))
    return q.to(qkv.dtype), k.to(qkv.dtype), x[:, :, 2]


def fused_window_attention_torch(qkv, cos, sin, valid, heads: int):
    """Plain version of K1. qkv (N, W, 3*H*D) raw projection output;
    cos/sin (N, W, D) float32; valid (N, W). Rope runs in float32 and is
    cast back to qkv's dtype before the scores, as the TPU kernel does.
    Returns (N, W, H*D) in qkv's dtype."""
    n, w, _ = qkv.shape
    q, k, v = _rope_qk(qkv, cos, sin, heads)
    return window_attention_torch(q, k, v, valid).reshape(n, w, -1)


def fused_window_attention_exact_torch(qkv, cos, sin, valid, heads: int):
    """Plain version of K1's exact mode. Returns (N, W, H*D)."""
    n, w, _ = qkv.shape
    q, k, v = _rope_qk(qkv, cos, sin, heads)
    return window_attention_exact_torch(q, k, v, valid)[0].reshape(n, w, -1)


def _rope_transpose(dy, cos, sin):
    """Adjoint of y = x*cos + rotate_half(x)*sin: dx = dy*cos + [a2, -a1]
    with a = dy*sin (float32, (N, W, H, D) against (N, W, 1, D) tables)."""
    a = dy * sin
    a1, a2 = a.chunk(2, dim=-1)
    return dy * cos + torch.cat([a2, -a1], dim=-1)


def fused_window_attention_bwd_torch(qkv, cos, sin, valid, heads: int, dout):
    """Plain version of K6's fused backward (JAX ``_fused_bwd_kernel``):
    recompute the roped q/k, the float32 window backward, the rope transpose
    on dq and dk. Returns dqkv (N, W, 3*H*D) in qkv's dtype."""
    n, w, three_hd = qkv.shape
    d = three_hd // 3 // heads
    q, k, v = _rope_qk(qkv, cos, sin, heads)
    dq, dk, dv = _window_bwd_f32(q, k, v, valid, dout.reshape(n, w, heads, d))
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    dq, dk = _rope_transpose(dq, c, s), _rope_transpose(dk, c, s)
    return torch.stack([dq, dk, dv], dim=2).reshape(n, w, three_hd).to(qkv.dtype)


def _check_window(name, q, k, v, valid):
    n, w, h, d = q.shape
    kernels.check_head_dim(name, d, kernels.WINDOW_HEAD_DIMS)
    ids = valid.to(torch.int32).contiguous()
    for arg, x in (("q", q), ("k", k), ("v", v)):
        kernels.check_tensor(arg, x, torch.bfloat16, (n, w, h, d))
    kernels.check_tensor("ids", ids, torch.int32, (n, w))
    return ids


def _check_fused(name, qkv, cos, sin, valid, heads):
    n, w, three_hd = qkv.shape
    d = three_hd // 3 // heads
    kernels.check_head_dim(name, d, kernels.VISION_HEAD_DIM)
    ids = valid.to(torch.int32).contiguous()
    kernels.check_tensor("qkv", qkv, torch.bfloat16, (n, w, 3 * heads * d))
    kernels.check_tensor("cos", cos, torch.float32, (n, w, d))
    kernels.check_tensor("sin", sin, torch.float32, (n, w, d))
    kernels.check_tensor("ids", ids, torch.int32, (n, w))
    return ids, d


def window_attention_exact(q, k, v, valid, impl: str = "auto"):
    """K2's exact mode: (out (N, W, H, D), lse (N, H, W) float32)."""
    if not kernels.use_kernel(q, impl):
        return window_attention_exact_torch(q, k, v, valid)
    n, w, h, d = q.shape
    ids = _check_window("window_attention_exact", q, k, v, valid)
    out = torch.empty_like(q)
    lse = torch.empty((n, h, w), dtype=torch.float32, device=q.device)
    kernels.launch("window_attention_exact", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   ids.data_ptr(), out.data_ptr(), lse.data_ptr(), n, w, h, d, d**-0.5)
    return out, lse


def bwd_operands(q, k, v, valid, out, lse, dout):
    """K6's window-backward kernel operands (q, k, v, dout, lse, delta,
    ids). The kernels take a frame in 64-row tiles, so rowsum(dp * p) comes
    in FlashAttention-2 form, as ``delta = rowsum(dout * out)`` (a torch
    reduction) with p recomputed from the forward's lse; the plain version
    follows JAX's formula."""
    n, w, h, d = q.shape
    ids = _check_window("window_attention_bwd", q, k, v, valid)
    do = dout.contiguous()
    kernels.check_tensor("dout", do, torch.bfloat16, (n, w, h, d))
    kernels.check_tensor("lse", lse, torch.float32, (n, h, w))
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()  # (N, H, W)
    return q, k, v, do, lse, delta, ids


def window_attention_bwd_dq(ops):
    """K6's window dq kernel on ``bwd_operands``: one CTA per (frame, head),
    the frame-head's K and V in shared memory. Returns dq (N, W, H, D)."""
    n, w, h, d = ops[0].shape
    dq = torch.empty_like(ops[0])
    kernels.launch("window_attention_bwd_dq", *(x.data_ptr() for x in ops), dq.data_ptr(),
                   n, w, h, d, d**-0.5)
    return dq


def window_attention_bwd_dkv(ops):
    """K6's window dk/dv kernel on ``bwd_operands``: one CTA per (frame,
    head), the frame-head's q and dout in shared memory. Returns (dk, dv)."""
    n, w, h, d = ops[0].shape
    dk, dv = torch.empty_like(ops[1]), torch.empty_like(ops[2])
    kernels.launch("window_attention_bwd_dkv", *(x.data_ptr() for x in ops), dk.data_ptr(),
                   dv.data_ptr(), n, w, h, d, d**-0.5)
    return dk, dv


def window_attention_bwd(q, k, v, valid, out, lse, dout, impl: str = "auto"):
    """K6's window backward: (dq, dk, dv)."""
    if not kernels.use_kernel(q, impl):
        return window_attention_bwd_torch(q, k, v, valid, dout)
    ops = bwd_operands(q, k, v, valid, out, lse, dout)
    return (window_attention_bwd_dq(ops), *window_attention_bwd_dkv(ops))


def fused_window_attention_exact(qkv, cos, sin, valid, heads: int, impl: str = "auto"):
    """K1's exact mode. Returns (N, W, H*D)."""
    if not kernels.use_kernel(qkv, impl):
        return fused_window_attention_exact_torch(qkv, cos, sin, valid, heads)
    n, w, _ = qkv.shape
    ids, d = _check_fused("fused_window_attention_exact", qkv, cos, sin, valid, heads)
    out = torch.empty((n, w, heads * d), dtype=qkv.dtype, device=qkv.device)
    kernels.launch("fused_window_attention_exact", qkv.data_ptr(), cos.data_ptr(),
                   sin.data_ptr(), ids.data_ptr(), out.data_ptr(), n, w, heads, d, d**-0.5)
    return out


def fused_window_attention_bwd(qkv, cos, sin, valid, heads: int, dout, impl: str = "auto"):
    """K6's fused backward: dqkv (N, W, 3*H*D), one window row per CTA."""
    if not kernels.use_kernel(qkv, impl):
        return fused_window_attention_bwd_torch(qkv, cos, sin, valid, heads, dout)
    n, w, three_hd = qkv.shape
    if w not in FUSED_BWD_WIDTHS:
        raise ValueError(f"fused_window_attention_bwd: row width {w} not built "
                         f"(built for {FUSED_BWD_WIDTHS})")
    ids, d = _check_fused("fused_window_attention_bwd", qkv, cos, sin, valid, heads)
    do = dout.contiguous()
    kernels.check_tensor("dout", do, torch.bfloat16, (n, w, heads * d))
    dqkv = torch.empty_like(qkv)
    kernels.launch("fused_window_attention_bwd", qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                   ids.data_ptr(), do.data_ptr(), dqkv.data_ptr(), n, w, heads, d, d**-0.5)
    return dqkv


class WindowAttention(torch.autograd.Function):
    """Exact forward (K2) saving (q, k, v, ids, out, lse); backward K6."""

    @staticmethod
    def forward(ctx, q, k, v, valid, impl):
        out, lse = window_attention_exact(q, k, v, valid, impl=impl)
        ctx.save_for_backward(q, k, v, valid, out, lse)
        ctx.impl = impl
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid, out, lse = ctx.saved_tensors
        dq, dk, dv = window_attention_bwd(q, k, v, valid, out, lse, dout, impl=ctx.impl)
        return dq, dk, dv, None, None


class FusedWindowAttention(torch.autograd.Function):
    """Exact forward (K1) saving (qkv, cos, sin, ids); backward K6 (fused),
    which recomputes everything in-window."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, valid, heads, impl):
        out = fused_window_attention_exact(qkv, cos, sin, valid, heads, impl=impl)
        ctx.save_for_backward(qkv, cos, sin, valid)
        ctx.heads, ctx.impl = heads, impl
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, cos, sin, valid = ctx.saved_tensors
        dqkv = fused_window_attention_bwd(qkv, cos, sin, valid, ctx.heads, dout, impl=ctx.impl)
        return dqkv, None, None, None, None, None


def window_attention(q, k, v, valid, impl: str = "auto"):
    """K2: bidirectional masked attention within same-size segments.
    q/k/v (N, W, H, D); valid (N, W) bool or int32 segment ids. Under
    autograd the exact forward and K6 run instead of the fixed-m forward."""
    if needs_grad(q, k, v):
        return WindowAttention.apply(q, k, v, valid, impl)
    if not kernels.use_kernel(q, impl):
        return window_attention_torch(q, k, v, valid)
    n, w, h, d = q.shape
    ids = _check_window("window_attention", q, k, v, valid)
    out = torch.empty_like(q)
    kernels.launch(
        "window_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ids.data_ptr(), out.data_ptr(), n, w, h, d, d**-0.5,
    )
    return out


def fused_window_attention(qkv, cos, sin, valid, heads: int, impl: str = "auto"):
    """K1: rope + bidirectional masked window attention in one kernel.
    qkv (N, W, 3*H*D); cos/sin (N, W, D) float32; valid (N, W).
    Returns (N, W, H*D). Under autograd the exact forward and K6 run."""
    if needs_grad(qkv):
        return FusedWindowAttention.apply(qkv, cos, sin, valid, heads, impl)
    if not kernels.use_kernel(qkv, impl):
        return fused_window_attention_torch(qkv, cos, sin, valid, heads)
    n, w, _ = qkv.shape
    ids, d = _check_fused("fused_window_attention", qkv, cos, sin, valid, heads)
    out = torch.empty((n, w, heads * d), dtype=qkv.dtype, device=qkv.device)
    kernels.launch(
        "fused_window_attention", qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        ids.data_ptr(), out.data_ptr(), n, w, heads, d, d**-0.5,
    )
    return out
