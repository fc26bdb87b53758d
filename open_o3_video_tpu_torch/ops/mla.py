"""Multi-head latent attention (DeepSeek-V3, Kimi-VL): the two attention
kernels of the latent cache and their plain versions.

The cache holds one row of ``kv_lora_rank + rope`` values a token and layer
(``[c_kv | k_pe]``, 512 + 64 in Kimi-VL-A3B), shared by every head. Two
forms compute the same attention from it:

- **Expanded** (query blocks of more than 8 rows: prefill, prefix blocks,
  suffix admissions): ``kv_b`` turns the latent into each head's
  ``k_nope`` (128) and ``v`` (128); the scores are ``q_nope . k_nope +
  q_pe . k_pe`` at head_dim 192, the values 128 wide.
  ``mla_prefill_attention`` (kernel ``o3v_mla_prefill_kernel``).
- **Absorbed** (8 rows or fewer: decode steps): ``q_nope`` is multiplied
  by each head's ``W_UK`` into the latent space, so every head's 576-wide
  query scores the shared latent row as it is stored, and the output is
  the probability-weighted latent (512), which ``W_UV`` then maps to the
  head's 128. ``mla_decode`` (kernels ``o3v_mla_decode_kernel`` and
  ``o3v_mla_decode_combine_kernel``).

Both kernels are CUDA C++ (``csrc/mla_attention.cu``, whose note gives
their designs and times: the decode streams the latent columns by TMA
into mma.sync consumers, split over the card's SMs and combined in split
order; the prefill is K3's TMA and wgmma CTA at qk 192 / v 128). They
replace no TPU kernel: the JAX package has no latent attention. The
decode reads masked columns and weights them by 0, so a cache's masked
columns must be finite (``init_kv_cache`` makes zeros). Keys are buffer
columns;
a key is visible to a query where its column's validity bit is set and the
column is at most the query's position (causal over buffer positions,
holes and a wrapped ring included), as K3 and K4 read them. A query with
no visible key returns 0.

``LAUNCHES`` (``ops.kernels``) counts each wrapper's launches under
``mla_decode`` (the split kernel and its combine, one call) and
``mla_prefill``.
"""

from __future__ import annotations

import torch

from . import kernels

# Decode split-K: one CTA of 16 query rows a split on each SM, no split
# shorter than this many keys.
MIN_SPLIT_KEYS = 256
DECODE_ROWS = 16  # query rows (a row and a head) a CTA
# The widths the kernels are built for: the latent and its rope part, a
# head's k_nope and v.
LATENT, ROPE, NOPE, V_DIM = 512, 64, 128, 128


def _visible(q_pos: torch.Tensor, kv_valid: torch.Tensor) -> torch.Tensor:
    """(B, S, T) bool: column valid and at most the query's position."""
    cols = torch.arange(kv_valid.shape[1], device=kv_valid.device)
    return kv_valid[:, None, :] & (cols[None, None, :] <= q_pos[:, :, None])


def _softmax_rows(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis where ``mask``, 0 for a row with none."""
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.where(mask.any(-1, keepdim=True), p, 0.0)


def mla_prefill_attention_torch(q_nope, q_pe, k_nope, k_pe, v, q_pos, kv_valid, scale):
    """The plain version of ``mla_prefill_attention``, in float32."""
    s = (torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope.float())
         + torch.einsum("bshd,btd->bhst", q_pe.float(), k_pe.float())) * scale
    p = _softmax_rows(s, _visible(q_pos, kv_valid)[:, None])
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(q_nope.dtype)


def mla_decode_torch(q_lat, q_pe, cache, q_pos, kv_valid, scale):
    """The plain version of ``mla_decode``, in float32."""
    r = q_lat.shape[-1]
    kv = cache.float()
    s = (torch.einsum("bshc,btc->bhst", q_lat.float(), kv[..., :r])
         + torch.einsum("bshd,btd->bhst", q_pe.float(), kv[..., r:])) * scale
    p = _softmax_rows(s, _visible(q_pos, kv_valid)[:, None])
    return torch.einsum("bhst,btc->bshc", p, kv[..., :r]).to(q_lat.dtype)


def split_plan(batch: int, rows: int, T: int, sms: int) -> int:
    """Splits of each batch row's columns: one CTA on each of ``sms`` SMs
    over the ``batch`` x 16-row blocks of ``rows`` query rows, none with
    fewer than ``MIN_SPLIT_KEYS`` of the ``T`` columns (one split where
    the row is shorter). The kernel divides the written columns' 32-key
    tiles evenly among the splits."""
    ctas = batch * -(-rows // DECODE_ROWS)
    return max(1, min(sms // ctas, T // MIN_SPLIT_KEYS))


def _check(name, x, dtype, ndim, last):
    if x.dtype != dtype or x.dim() != ndim or x.shape[-1] != last or x.stride(-1) != 1:
        raise ValueError(f"{name}: want {dtype} of {ndim} dims, last {last} contiguous; got "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")
    if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:-1]):
        raise ValueError(f"{name}: rows must start on 16-byte boundaries; got strides "
                         f"{x.stride()}")


def mla_decode(q_lat, q_pe, cache, q_pos, kv_valid, scale: float, impl: str = "auto"):
    """Absorbed attention of at most 8 query rows a batch row over the
    latent cache as stored. q_lat (B, S, H, R) and q_pe (B, S, H, P) in the
    cache's dtype; cache (B, T, R + P), a layer's view; q_pos (B, S) int64
    positions; kv_valid (B, T) bool. Returns the probability-weighted
    latents (B, S, H, R) in q's dtype."""
    if not kernels.use_kernel(q_lat, impl):
        return mla_decode_torch(q_lat, q_pe, cache, q_pos, kv_valid, scale)
    B, S, H, R = q_lat.shape
    P = q_pe.shape[-1]
    T = cache.shape[1]
    if (R, P) != (LATENT, ROPE):
        raise ValueError(f"mla_decode: built for a latent of {LATENT} + {ROPE}, got {R} + {P}")
    q_lat, q_pe = q_lat.contiguous(), q_pe.contiguous()
    _check("q_lat", q_lat, torch.bfloat16, 4, R)
    _check("q_pe", q_pe, torch.bfloat16, 4, P)
    _check("cache", cache, torch.bfloat16, 3, R + P)
    if (cache.stride(1) != R + P or q_pos.dtype != torch.int64 or kv_valid.dtype != torch.bool
            or tuple(q_pos.shape) != (B, S) or tuple(kv_valid.shape) != (B, T)):
        raise ValueError("mla_decode: the cache's rows must be contiguous, q_pos (B, S) int64 "
                         "and kv_valid (B, T) bool")
    q_pos, valid = q_pos.contiguous(), kv_valid.contiguous()
    rows = S * H
    n_split = split_plan(B, rows, T, kernels.sm_count(q_lat.device.index or 0))
    part = torch.empty((B, n_split, rows, R), dtype=torch.float32, device=q_lat.device)
    lse = torch.empty((B, n_split, rows), dtype=torch.float32, device=q_lat.device)
    out = torch.empty_like(q_lat)
    kernels.launch("mla_decode", q_lat.data_ptr(), q_pe.data_ptr(), cache.data_ptr(),
                   cache.stride(0), q_pos.data_ptr(), valid.data_ptr(), part.data_ptr(),
                   lse.data_ptr(), out.data_ptr(), B, S, H, T, n_split, float(scale))
    return out


def mla_prefill_attention(q_nope, q_pe, k_nope, k_pe, v, q_pos, kv_valid, scale: float,
                          impl: str = "auto"):
    """Expanded attention: q_nope (B, S, H, N), q_pe (B, S, H, P), k_nope
    (B, T, H, N), k_pe (B, T, P) shared by the heads, v (B, T, H, Dv), each
    with its last axis contiguous (views of the projections' outputs and of
    the cache are taken as they are); q_pos (B, S) int64, kv_valid (B, T)
    bool. Returns (B, S, H, Dv) in q's dtype."""
    if not kernels.use_kernel(q_nope, impl):
        return mla_prefill_attention_torch(q_nope, q_pe, k_nope, k_pe, v, q_pos, kv_valid, scale)
    B, S, H, N = q_nope.shape
    P, Dv, T = q_pe.shape[-1], v.shape[-1], k_nope.shape[1]
    if (N, P, Dv) != (NOPE, ROPE, V_DIM):
        raise ValueError(f"mla_prefill_attention: built for qk {NOPE} + {ROPE}, v {V_DIM}; got "
                         f"{N} + {P}, {Dv}")
    for name, x, nd, last in (("q_nope", q_nope, 4, N), ("q_pe", q_pe, 4, P),
                              ("k_nope", k_nope, 4, N), ("k_pe", k_pe, 3, P), ("v", v, 4, Dv)):
        _check(name, x, torch.bfloat16, nd, last)
    if (q_pos.dtype != torch.int64 or kv_valid.dtype != torch.bool
            or tuple(q_pos.shape) != (B, S) or tuple(kv_valid.shape) != (B, T)):
        raise ValueError("mla_prefill_attention: q_pos (B, S) int64 and kv_valid (B, T) bool")
    q_pos, valid = q_pos.contiguous(), kv_valid.contiguous()
    out = torch.empty((B, S, H, Dv), dtype=q_nope.dtype, device=q_nope.device)
    kernels.launch("mla_prefill", q_nope.data_ptr(), q_pe.data_ptr(), k_nope.data_ptr(),
                   k_pe.data_ptr(), v.data_ptr(), q_pos.data_ptr(), valid.data_ptr(),
                   out.data_ptr(), B, S, T, H, *q_nope.stride()[:3], *q_pe.stride()[:3],
                   *k_nope.stride()[:3], *k_pe.stride()[:2], *v.stride()[:3], float(scale))
    return out
