"""Attention entry points of the model (counterpart of
``open_o3_video_tpu/ops/attention.py``).

- ``causal_attention``: GQA decoder attention against a KV buffer. Decode
  (S <= 8) runs K4 (``decode_attention``) on k/v in the cache's STORED dtype
  against a buffer of LONG_DECODE_T slots or more, as the JAX package does,
  and on the card at any length wherever K4 takes the inputs (CUDA, a bf16
  q, a bf16 or e4m3 cache, head_dim 128, at most 64 query rows a kv head;
  not under autograd): the dispatch comes before any cast, so a decode step
  makes no copy of the layer. Otherwise, in the JAX package's order, the
  layer is cast to the compute dtype, for prefill (S > 8, K3 in
  ``flash_attention``) or for the plain grouped decode below the
  long-context threshold (the JAX package's XLA path, which the CPU runs).
  Keys are addressed by buffer index == position.
- ``segment_attention``: bidirectional ViT attention over same-size segments
  (K2, ``window_attention``).

Under autograd (training: no cache, S > 8) K3 and K2 run their exact modes
and their backward kernels (K5, K6) through ``torch.autograd.Function``s;
inference calls keep the fixed-m forwards.

``impl="auto"`` launches the kernels for CUDA tensors and runs their plain
versions for CPU tensors; ``impl="torch"`` runs the plain versions anywhere.
A ``ring_attention.RingImpl`` (JAX's ``"ring:<axis>"``) runs a cacheless
forward's attention as ring attention over its group, the keys at the
queries' global positions.

``decode_impl`` is the engine's ``decode_attn_impl``, given only by the
decode step and the speculative verify blocks (S <= 8), as the JAX
package's ``attn_impl`` reaches them: "auto" is the dispatch above;
"pallas" takes the hand-written kernel for every short query block, K4 at
long T and K3 below it (JAX's ``S > 8 or impl == "pallas"``); "xla" takes
the plain versions (JAX's order). It never reaches a matmul.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import kernels
from .decode_attention import KV_DTYPES, MAX_ROWS, decode_attention_gqa
from .flash_attention import flash_attention_gqa, needs_grad
from .ring_attention import RingImpl, ring_attention
from .window_attention import window_attention

# Decode against a buffer at least this long runs K4 (or its plain version)
# on the stored-dtype cache, as the JAX package does (its ops/attention.py
# LONG_DECODE_T); below it only the plain path keeps the grouped decode.
LONG_DECODE_T = 32768
# The values of the engine's decode_attn_impl (the JAX package's attn_impl).
DECODE_IMPLS = ("auto", "pallas", "xla")


def _grouped_decode(q, k, v, mask):
    """Exact-softmax grouped decode for S <= 8 query rows: the KV heads are
    never repeated over the GQA group. mask (B, S, T). Rows with no valid
    key return 0."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, S, Hkv, Hq // Hkv, D)
    s = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) / math.sqrt(D)
    m = mask[:, None, None]
    probs = torch.softmax(s.masked_fill(~m, float("-inf")), dim=-1)
    probs = torch.where(m.any(-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bhgst,bthd->bshgd", probs.to(q.dtype).float(), v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)


def _k4_takes(q, k, v, impl) -> bool:
    """True where K4 runs these decode inputs on the card as they are: what
    the inputs show (device, dtypes, shape), nothing else."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    return (kernels.use_kernel(q, impl) and q.dtype == torch.bfloat16
            and k.dtype in KV_DTYPES and v.dtype == k.dtype and D == kernels.TEXT_HEAD_DIM
            and Hq % Hkv == 0 and S * (Hq // Hkv) <= MAX_ROWS and not needs_grad(q, k, v))


def causal_attention(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, T, Hkv, D), e.g. a layer view of the stacked cache
    v: torch.Tensor,
    *,
    q_positions: Optional[torch.Tensor] = None,  # (B, S) buffer positions
    kv_mask: Optional[torch.Tensor] = None,  # (B, T) validity of cache slots
    impl: str = "auto",
    decode_impl: str = "auto",
) -> torch.Tensor:
    """Causal GQA attention: the query at position p sees valid keys t <= p.
    Query rows with no visible key return 0 (they are never read)."""
    if isinstance(impl, RingImpl):
        # context parallelism: q/k/v are this rank's blocks of a cacheless
        # forward, the positions global (parallel/context.py)
        return ring_attention(q, k, v, q_positions, q_positions, kv_mask, impl.group,
                              impl=impl.kernels)
    if decode_impl not in DECODE_IMPLS:
        raise ValueError(f"decode_impl {decode_impl!r} is not one of {DECODE_IMPLS}")
    if decode_impl == "xla":
        impl = "torch"
    B, S, Hq, D = q.shape
    T = k.shape[1]
    if q_positions is None:
        q_positions = torch.arange(S, device=q.device).expand(B, S)
    if kv_mask is None:
        kv_mask = torch.ones((B, T), dtype=torch.bool, device=q.device)
    if S <= 8 and (T >= LONG_DECODE_T or (decode_impl == "auto" and _k4_takes(q, k, v, impl))):
        # Before any cast: K4 streams the cache in its stored dtype, so a
        # decode step never makes a whole-layer copy in the compute dtype.
        return decode_attention_gqa(q, k, v, q_positions, kv_mask, impl=impl)
    if k.dtype != q.dtype:  # the cache may store another dtype than compute
        k, v = k.to(q.dtype), v.to(q.dtype)
    if S > 8 or decode_impl == "pallas":
        return flash_attention_gqa(q, k, v, q_positions, kv_mask, impl=impl)
    t = torch.arange(T, device=q.device)
    mask = (t[None, None, :] <= q_positions[:, :, None]) & kv_mask[:, None, :].bool()
    return _grouped_decode(q, k, v, mask)


def segment_attention(q, k, v, valid, impl: str = "auto"):
    """Bidirectional attention within each segment. q/k/v (N, W, H, D);
    valid (N, W) bool mask or int32 segment ids (0 = pad)."""
    return window_attention(q, k, v, valid, impl=impl)
