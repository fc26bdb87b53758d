"""Causal GQA flash attention: K3 (forward) and K5 (backward), decoder.

Counterpart of ``open_o3_video_tpu/ops/flash_attention.py``.
Layout: q (B, S, Hq, D), k/v (B, T, Hkv, D), q_positions (B, S), kv_valid
(B, T). Key t is visible to a query iff ``t <= q_position`` and
``kv_valid[b, t]``; a query with no visible key (e.g. q_position -1) returns
0. q is prescaled by D^-1/2 and rounded to its dtype before the scores, as
the JAX wrapper does, so the plain version matches JAX bit for bit in f32.

Two forward modes, picked as the JAX package's ``custom_vjp`` picks them:

- inference (no input needs a gradient): the fixed-m softmax of the TPU
  kernel, ``p = exp(min(s, 60))``, ``out = (p cast to the compute dtype) @ v
  / l``, float32 accumulation;
- training (grad enabled and an input requires grad): the exact online-max
  softmax, which also returns the log-sum-exp ``lse`` (B, Hq, S) float32
  (NEG_INF for a row with no visible key). Its backward (K5) recomputes
  ``p = exp(s - lse)`` FlashAttention-2 style and returns dq, and dk/dv
  summed over each GQA group.

k/v may be strided views of the stacked (L, B, T, Hkv, D) cache: the kernels
read them through their batch and token strides.
"""

from __future__ import annotations

import torch

from . import kernels

CLAMP = 60.0
NEG_INF = -0.7 * torch.finfo(torch.float32).max
# The CTA of K3 and of K5's dq: 128 query rows of one head (two warpgroups of 64).
CTA_ROWS = 128


def _prescale(q):
    return (q * q.shape[-1] ** -0.5).to(q.dtype)


def _acc(x):
    """x in its accumulation dtype: float32, or float64 where x is float64
    (the float64 autograd check of the plain backward)."""
    return x if x.dtype == torch.float64 else x.float()


def _causal_mask(q_positions, kv_valid, T):
    t = torch.arange(T, device=q_positions.device)
    return (t[None, None, :] <= q_positions[:, :, None]) & (kv_valid[:, None, :] != 0)


def flash_attention_gqa_torch(q, k, v, q_positions, kv_valid):
    """Plain version of K3 (and of K4, ``decode_attention``), grouped over
    the GQA heads (no KV repeat): k/v in any float dtype, fp8 included, are
    converted to f32 exactly; p is cast to q's dtype before the PV product.
    Returns (B, S, Hq, D) in q's dtype."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = _prescale(q).float().reshape(B, S, Hkv, Hq // Hkv, D)
    s = torch.einsum("bshgd,bthd->bhgst", qg, k.float())
    mask = _causal_mask(q_positions, kv_valid, T)
    p = torch.where(mask[:, None, None], torch.exp(torch.clamp(s, max=CLAMP)), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgst,bthd->bhgsd", p.to(q.dtype).float(), v.float())
    o = o / torch.where(l == 0.0, 1.0, l)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)


def flash_attention_gqa_exact_torch(q, k, v, q_positions, kv_valid):
    """Plain version of K3's exact mode (the JAX ``_fwd`` with
    ``exact_softmax=True``): max-subtracted softmax, p cast to q's dtype
    before the PV product, division by l after it. Returns (out (B, S, Hq, D)
    in q's dtype, lse (B, Hq, S) float32)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = _acc(_prescale(q)).reshape(B, S, Hkv, Hq // Hkv, D)
    s = torch.einsum("bshgd,bthd->bhgst", qg, _acc(k))
    mask = _causal_mask(q_positions, kv_valid, T)[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhgst,bthd->bhgsd", _acc(p.to(q.dtype)), _acc(v)) / l_safe
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))[..., 0]
    return (o.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype),
            lse.reshape(B, Hq, S))


def flash_attention_gqa_bwd_torch(q, k, v, q_positions, kv_valid, out, lse, dout):
    """Plain version of K5 (the JAX ``_bwd``), written out from the saved
    residuals: ``p = exp(s - lse)`` on the prescaled q, ``delta =
    rowsum(dout * out)``, ``ds = (p * (dp - delta))`` cast to q's dtype,
    ``dq = scale * ds @ k``, ``dk = ds^T @ q_prescaled``, ``dv = p^T @
    dout`` (p cast to dout's dtype), dk/dv summed over the GQA group in
    float32. Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D**-0.5
    delta = (_acc(dout) * _acc(out)).sum(-1)  # (B, S, Hq)
    qs = _acc(_prescale(q)).reshape(B, S, Hkv, G, D)
    do = _acc(dout).reshape(B, S, Hkv, G, D)
    s = torch.einsum("bshgd,bthd->bhgst", qs, _acc(k))
    mask = _causal_mask(q_positions, kv_valid, T)[:, None, None]
    lse_g = lse.reshape(B, Hkv, G, S)[..., None]
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    dp = torch.einsum("bshgd,bthd->bhgst", do, _acc(v))
    delta_g = delta.reshape(B, S, Hkv, G).permute(0, 2, 3, 1)[..., None]
    ds = _acc((p * (dp - delta_g)).to(q.dtype))
    dq = scale * torch.einsum("bhgst,bthd->bshgd", ds, _acc(k))
    dk = torch.einsum("bhgst,bshgd->bthd", ds, qs)
    dv = torch.einsum("bhgst,bshgd->bthd", _acc(p.to(dout.dtype)), do)
    return dq.reshape(B, S, Hq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_operands(name, q, k, v, q_positions, kv_valid):
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    kernels.check_head_dim(name, D, kernels.TEXT_HEAD_DIM)
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
    return qs, pos, valid


def cta_plan(B: int, S: int, Hq: int) -> list[tuple[int, int, int]]:
    """The static schedule of K3 and of K5's dq kernel, as
    ``csrc/causal_cta.cuh:cta_work`` computes it: per CTA in launch order,
    its (batch row, head, first query row). The last query tiles, which see
    the most keys, come first."""
    n_qt, units = -(-S // CTA_ROWS), B * Hq
    return [(*divmod(idx % units, Hq), (n_qt - 1 - idx // units) * CTA_ROWS)
            for idx in range(n_qt * units)]


def _fixed_m(q, k, v, q_positions, kv_valid):
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qs, pos, valid = _kernel_operands("flash_attention_gqa", q, k, v, q_positions, kv_valid)
    out = torch.empty_like(qs)
    kernels.launch(
        "flash_attention_gqa", qs.data_ptr(), k.data_ptr(), v.data_ptr(),
        pos.data_ptr(), valid.data_ptr(), out.data_ptr(), B, S, T, Hq, Hkv, D,
        k.stride(0), k.stride(1), v.stride(0), v.stride(1),
    )
    return out


def flash_attention_gqa_exact(q, k, v, q_positions, kv_valid, impl: str = "auto"):
    """K3's exact mode: (out (B, S, Hq, D), lse (B, Hq, S) float32)."""
    if not kernels.use_kernel(q, impl):
        return flash_attention_gqa_exact_torch(q, k, v, q_positions, kv_valid)
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qs, pos, valid = _kernel_operands("flash_attention_gqa_exact", q, k, v, q_positions, kv_valid)
    out = torch.empty_like(qs)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    kernels.launch(
        "flash_attention_gqa_exact", qs.data_ptr(), k.data_ptr(), v.data_ptr(),
        pos.data_ptr(), valid.data_ptr(), out.data_ptr(), lse.data_ptr(), B, S, T, Hq, Hkv, D,
        k.stride(0), k.stride(1), v.stride(0), v.stride(1),
    )
    return out, lse


def bwd_operands(q, k, v, q_positions, kv_valid, out, lse, dout):
    """K5's checked kernel operands (q prescaled, k, v, dout, lse, delta,
    positions, validity) from the exact forward's residuals. ``delta =
    rowsum(dout * out)`` (B, Hq, S) is a torch reduction, as in JAX."""
    B, S, Hq, D = q.shape
    qs, pos, valid = _kernel_operands("flash_attention_gqa_bwd", q, k, v, q_positions, kv_valid)
    do = dout.contiguous()
    kernels.check_tensor("dout", do, torch.bfloat16, (B, S, Hq, D))
    kernels.check_tensor("lse", lse, torch.float32, (B, Hq, S))
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return qs, k.contiguous(), v.contiguous(), do, lse, delta, pos, valid


def _bwd_dims(ops):
    qs, k = ops[0], ops[1]
    return (*qs.shape[:3], k.shape[1], k.shape[2], qs.shape[3])  # B, S, Hq, T, Hkv, D


def flash_attention_gqa_bwd_dq(ops):
    """K5's dq kernel on ``bwd_operands``: one CTA per 128 query rows of
    one head, in ``cta_plan``'s order. Returns dq (B, S, Hq, D)."""
    B, S, Hq, T, Hkv, D = _bwd_dims(ops)
    dq = torch.empty_like(ops[0])
    kernels.launch("flash_attention_gqa_bwd_dq", *(x.data_ptr() for x in ops), dq.data_ptr(),
                   B, S, T, Hq, Hkv, D)
    return dq


def flash_attention_gqa_bwd_dkv(ops):
    """K5's dk/dv on ``bwd_operands``, two kernels in one launch: one CTA
    per (64-key tile, query head) writes that head's float32 dk and dv to a
    workspace (2, B, T, Hq, D), then each kv head's group is summed in head
    order and rounded to bf16 (deterministic, no atomics). Returns (dk, dv)
    (B, T, Hkv, D)."""
    B, S, Hq, T, Hkv, D = _bwd_dims(ops)
    dk, dv = torch.empty_like(ops[1]), torch.empty_like(ops[2])
    ws = torch.empty((2, B, T, Hq, D), dtype=torch.float32, device=dk.device)
    kernels.check_tensor("dk/dv workspace", ws, torch.float32, (2, B, T, Hq, D))
    kernels.launch("flash_attention_gqa_bwd_dkv", *(x.data_ptr() for x in ops), dk.data_ptr(),
                   dv.data_ptr(), ws.data_ptr(), B, S, T, Hq, Hkv, D)
    return dk, dv


def flash_attention_gqa_bwd(q, k, v, q_positions, kv_valid, out, lse, dout, impl: str = "auto"):
    """K5: (dq, dk, dv) from the exact forward's residuals."""
    if not kernels.use_kernel(q, impl):
        return flash_attention_gqa_bwd_torch(q, k, v, q_positions, kv_valid, out, lse, dout)
    ops = bwd_operands(q, k, v, q_positions, kv_valid, out, lse, dout)
    return (flash_attention_gqa_bwd_dq(ops), *flash_attention_gqa_bwd_dkv(ops))


class FlashAttentionGQA(torch.autograd.Function):
    """Exact forward (K3) saving (q, k, v, q_positions, kv_valid, out, lse);
    backward K5. Positions and validity get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_valid, impl):
        out, lse = flash_attention_gqa_exact(q, k, v, q_positions, kv_valid, impl=impl)
        ctx.save_for_backward(q, k, v, q_positions, kv_valid, out, lse)
        ctx.impl = impl
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_positions, kv_valid, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_gqa_bwd(q, k, v, q_positions, kv_valid, out, lse, dout,
                                             impl=ctx.impl)
        return dq, dk, dv, None, None, None


def needs_grad(*xs) -> bool:
    """True where autograd records: grad enabled and an input requires it."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention_gqa(q, k, v, q_positions, kv_valid, impl: str = "auto"):
    """Causal GQA attention, differentiable. Returns (B, S, Hq, D).
    Inference calls run the fixed-m forward (K3); under autograd the exact
    forward and K5 run instead."""
    if needs_grad(q, k, v):
        return FlashAttentionGQA.apply(q, k, v, q_positions, kv_valid, impl)
    if not kernels.use_kernel(q, impl):
        return flash_attention_gqa_torch(q, k, v, q_positions, kv_valid)
    return _fixed_m(q, k, v, q_positions, kv_valid)
