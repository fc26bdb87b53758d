"""Ring attention: context-parallel causal attention over a process group
(counterpart of ``open_o3_video_tpu/ops/ring_attention.py``).

Each rank of the ``context`` axis holds one contiguous block of the
sequence: its queries, keys and values, with GLOBAL positions. In each of
the n steps the local queries meet one KV block, and the blocks travel the
ring rank r -> r + 1 (``rotate``: ``batch_isend_irecv`` on the group; a
gloo group stages a card's tensors through the host, since gloo moves host
memory), so after n steps every query has seen every key.

Two versions of the same function:

- ``ring_attention_torch``, the plain version: JAX's einsum recurrence
  (float32 scores, the running max and denominator), differentiated by
  autograd through a rotation whose backward sends the gradient the other
  way round the ring. The CPU's path, and the card's oracle.
- ``RingAttention``, the kernels' path: each step is one call of K3's exact
  mode (``flash_attention_gqa_exact``) on the block, with the query
  positions shifted by the block's first key position (K3 reads a key's
  buffer index as its position), and the steps' (out, lse) pairs combined
  by the online-softmax rule. A query row that a block masks entirely gets
  out 0 and lse ``NEG_INF`` from K3 and adds nothing to the combine. The
  backward calls K5 (``flash_attention_gqa_bwd``) once per block with the
  combined output and log-sum-exp, which makes each block's dq, dk and dv
  exact partial sums: dq adds up locally; dk and dv (float32) travel the
  ring with their block and arrive back at its owner after n sends. On the
  CPU the same calls run K3's and K5's plain versions.

The kernels' path reads a block's key positions as contiguous from its
first (what ``parallel.context`` gives it: the sequence cut in rank order).
Fully masked (padding) query rows return zeros, finite, never read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .flash_attention import NEG_INF, flash_attention_gqa_bwd, flash_attention_gqa_exact

# JAX's mask value of the plain recurrence (its _NEG): finite, so a row
# whose keys are all masked stays NaN-free.
_NEG = -0.7 * float(torch.finfo(torch.float32).max)


@dataclasses.dataclass(frozen=True)
class RingImpl:
    """An ``attn_impl`` that runs the decoder's attention as ring attention
    over ``group`` (JAX's ``"ring:<axis>"``); ``kernels`` is the impl of
    every other kernel call ("auto" or "torch"), and picks the ring's
    version: "auto" the kernels' path, "torch" the plain recurrence."""

    group: object
    kernels: str = "auto"


def _peers(group) -> tuple[int, int]:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return dist.get_global_rank(group, (r + 1) % n), dist.get_global_rank(group, (r - 1) % n)


def rotate(xs: list, group, backward: bool = False) -> list:
    """Each tensor of ``xs`` sent to the next rank of the ring and the
    previous rank's received (``backward``: the other way round). A gloo
    group moves a card's tensors through host copies. A ring of one returns
    ``xs``."""
    if dist.get_world_size(group) == 1:
        return list(xs)
    nxt, prv = _peers(group)
    if backward:
        nxt, prv = prv, nxt
    host = dist.get_backend(group) == "gloo"
    sends = [x.contiguous() for x in xs]
    if host:
        sends = [x.cpu() for x in sends]
    recvs = [torch.empty_like(x) for x in sends]
    ops = [dist.P2POp(dist.isend, x, nxt, group) for x in sends]
    ops += [dist.P2POp(dist.irecv, x, prv, group) for x in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if host:
        recvs = [y.to(x.device) for x, y in zip(xs, recvs)]
    return recvs


class _Rotate(torch.autograd.Function):
    """``rotate`` of one tensor; its gradient travels back the other way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return rotate([x], group)[0]

    @staticmethod
    def backward(ctx, g):
        return rotate([g], ctx.group, backward=True)[0], None


def ring_attention_torch(q, k, v, q_positions, kv_positions, kv_mask, group) -> torch.Tensor:
    """JAX's recurrence: exact causal GQA attention with the KV blocks
    rotating around ``group``, f32 accumulators, differentiable."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    n = dist.get_world_size(group)
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    scale = 1.0 / float(D) ** 0.5
    if kv_mask is None:
        kv_mask = torch.ones((B, Skv), dtype=torch.bool, device=q.device)
    kv_mask = kv_mask.to(torch.int32)  # gloo moves no bool
    acc = torch.zeros((B, Sq, Hkv, Hq // Hkv, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, Sq, Hkv, Hq // Hkv), _NEG, dtype=torch.float32, device=q.device)
    denom = torch.zeros_like(m)
    for step in range(n):
        s = torch.einsum("bshgd,bthd->bshgt", qg.float(), k.float()) * scale
        mask = (kv_positions[:, None, :] <= q_positions[:, :, None]) & (kv_mask[:, None, :] != 0)
        mask = mask[:, :, None, None, :]
        s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        o = torch.einsum("bshgt,bthd->bshgd", p.to(v.dtype).float(), v.float())
        acc = acc * alpha[..., None] + o
        denom = denom * alpha + p.sum(-1)
        m = m_new
        if step < n - 1:
            k, v = _Rotate.apply(k, group), _Rotate.apply(v, group)
            kv_positions, kv_mask = rotate([kv_positions, kv_mask], group)
    out = acc / denom.clamp(min=1e-20)[..., None]
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def _combine(acc, lse, o, lse_j):
    """The online-softmax rule on (out (B, S, Hq, D) f32, lse (B, Hq, S)):
    the running pair and one block's, weighted by exp(lse_j - lse_new); a
    block that masked a row entirely (lse_j ``NEG_INF``) adds nothing."""
    lse_new = torch.logaddexp(lse, lse_j)
    w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w_new = torch.where(lse_j <= NEG_INF, 0.0, torch.exp(lse_j - lse_new))
    return acc * w_old + o.float() * w_new.transpose(1, 2)[..., None], lse_new


class RingAttention(torch.autograd.Function):
    """The kernels' path (module docstring): K3 exact per block forward, K5
    per block backward with the combined (out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, kv_mask, group, impl):
        n = dist.get_world_size(group)
        B, S, Hq, D = q.shape
        acc = torch.zeros((B, S, Hq, D), dtype=torch.float32, device=q.device)
        lse = torch.full((B, Hq, S), NEG_INF, dtype=torch.float32, device=q.device)
        ck, cv, cpos, cmask = k, v, kv_positions, kv_mask
        for step in range(n):
            o, lse_j = flash_attention_gqa_exact(q, ck, cv, q_positions - cpos[:, :1], cmask,
                                                 impl=impl)
            acc, lse = _combine(acc, lse, o, lse_j)
            if step < n - 1:
                ck, cv, cpos, cmask = rotate([ck, cv, cpos, cmask], group)
        out = acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, q_positions, kv_positions, kv_mask, out, lse)
        ctx.group, ctx.impl = group, impl
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_positions, kv_positions, kv_mask, out, lse = ctx.saved_tensors
        group, n = ctx.group, dist.get_world_size(ctx.group)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        ck, cv, cpos, cmask = k, v, kv_positions, kv_mask
        dout = dout.contiguous()
        for step in range(n):
            dq_j, dk_j, dv_j = flash_attention_gqa_bwd(q, ck, cv, q_positions - cpos[:, :1],
                                                       cmask, out, lse, dout, impl=ctx.impl)
            dq += dq_j.float()
            dk += dk_j.float()
            dv += dv_j.float()
            # the block moves on with its accumulated dk/dv; the n-th send
            # brings each block's home
            if step < n - 1:
                ck, cv, cpos, cmask, dk, dv = rotate([ck, cv, cpos, cmask, dk, dv], group)
            else:
                dk, dv = rotate([dk, dv], group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None)


def ring_attention(q, k, v, q_positions, kv_positions, kv_mask: Optional[torch.Tensor], group,
                   impl: str = "auto") -> torch.Tensor:
    """Exact causal GQA attention of the local queries (B, Sq, Hq, D) over
    every rank's KV block, positions GLOBAL. ``impl`` "auto": the kernels'
    path (K3 exact and K5 on CUDA tensors, their plain versions on the
    CPU); "torch": the plain recurrence."""
    if kv_mask is None:
        kv_mask = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    if impl == "torch":
        return ring_attention_torch(q, k, v, q_positions, kv_positions, kv_mask, group)
    return RingAttention.apply(q, k, v, q_positions, kv_positions, kv_mask.to(torch.int32),
                               group, impl)
