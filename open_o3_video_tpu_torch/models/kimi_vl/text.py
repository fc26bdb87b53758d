"""Kimi-VL's decoder: DeepSeek-V3 layers (transformers'
``modeling_deepseek_v3.py``: ``DeepseekV3Attention``, ``DeepseekV3MoE``)
over a latent KV cache.

Attention is multi-head latent attention with no q compression: q is one
projection (heads x (128 + 64)); ``kv_a`` gives the 512-wide latent, which
``kv_norm`` (RMSNorm, eps 1e-6) normalises, and a 64-wide key part shared
by the heads; the rope (1-D positions, theta from the config) turns the 64
rope dims of q and of that key part, their interleaved pairs first
de-interleaved as ``rope_interleave`` says; the scores are scaled by
192^-0.5. The cache stores ``[latent | roped key part]``, 576 values a
token and layer, in one (L, B, T, 576) tensor ``cache["kv"]``: no head's
keys or values are kept between steps. A query block of more than 8 rows
(prefill, prefix blocks, suffix admissions) expands the written latent
columns through ``kv_b`` into each head's k_nope and v and attends at
192 / 128 (``ops.mla.mla_prefill_attention``, range ``mla.expand`` and
``mla.prefill_attn``); a block of 8 rows or fewer (a decode step) absorbs
``kv_b``'s key half into its queries and reads the cache as stored
(``ops.mla.mla_decode``, range ``mla.absorb``), then maps the weighted
latents through the value half.

The MLP of layers before ``first_k_dense_replace`` is a SwiGLU; every
other layer's is ``qwen25vl.text.moe_mlp`` with the router's
``sigmoid_bias_topk_norm`` mode and the shared experts in its
``gate_w``/``up_w``/``down_w`` branch. Positions arrive in the shared
(3, B, S) layout and the first axis is used.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...ops.mla import mla_decode, mla_prefill_attention
from ...ops.quant import dense
from ...ops.rms_norm import rms_norm
from ..qwen25vl.text import moe_mlp, write_cache, write_cache_at
from .config import KimiTextConfig

# Query blocks of at most this many rows take the absorbed path.
ABSORB_MAX_ROWS = 8


def init_kv_cache(cfg: KimiTextConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None) -> dict:
    """Zeroed latent cache {"kv": (L, batch, max_len, kv_lora_rank + rope)}."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the latent cache is bf16 (or float32 on the CPU); {dtype} caches "
                         "are not supported")
    return {"kv": torch.zeros((cfg.num_hidden_layers, batch, max_len, cfg.latent_dim),
                              dtype=dtype, device=device)}


def rope_cos_sin(positions: torch.Tensor, cfg: KimiTextConfig, dtype):
    """cos, sin (B, S, rope dims) at 1-D ``positions`` (B, S), the halves
    repeated (rotate-half layout), computed in float32."""
    d = cfg.qk_rope_head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                                 device=positions.device) / d))
    ang = positions.float()[..., None] * inv
    emb = torch.cat([ang, ang], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               interleave: bool) -> torch.Tensor:
    """x (..., S, [H,] d) with cos/sin (B, S, d): the interleaved pairs
    moved to the halves first where ``interleave``, then rotate-half."""
    if interleave:
        x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    if x.dim() == 4:
        cos, sin = cos[:, :, None], sin[:, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def key_columns(S: int, cache: Optional[dict], cache_offset) -> int:
    """Latent columns an expanded block attends to: a cacheless forward's
    own, else the cache's written columns (a chunk's keys end at its last
    column)."""
    return S if cache is None else cache_offset + S


def _attention(p: dict, cfg: KimiTextConfig, x, cos, sin, seq_positions, kv_mask, cache,
               layer: int, cache_offset, impl: str, validity_only: bool):
    B, S, _ = x.shape
    H, N, R = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    Dv = cfg.v_head_dim
    scale = cfg.qk_head_dim ** -0.5
    q = dense(x, p["q_w"], impl).reshape(B, S, H, cfg.qk_head_dim)
    q_nope = q[..., :N]
    q_pe = apply_rope(q[..., N:], cos, sin, cfg.rope_interleave)
    ckv = dense(x, p["kv_a_w"], impl)
    latent = torch.cat([rms_norm(ckv[..., :R], p["kv_norm"], cfg.kv_norm_eps, impl),
                        apply_rope(ckv[..., R:], cos, sin, cfg.rope_interleave)], dim=-1)
    if cache is not None:
        lay = cache["kv"][layer]  # (B, T, R + P) view
        if isinstance(cache_offset, torch.Tensor):  # a decode step at a column on the device
            write_cache_at(lay, latent, cache_offset)
        else:
            write_cache(lay[:, cache_offset:cache_offset + S], latent)
        if validity_only:
            mask = kv_mask
        else:  # buffer column == position: the columns past the write head are invalid
            written = torch.arange(lay.shape[1], device=x.device)[None, :] < cache_offset + S
            mask = written if kv_mask is None else kv_mask & written
    else:
        lay = latent
        mask = (torch.ones((B, S), dtype=torch.bool, device=x.device) if kv_mask is None
                else kv_mask)
    kv_b = p["kv_b_w"].reshape(R, H, N + Dv)
    if S <= ABSORB_MAX_ROWS:
        with torch.profiler.record_function("mla.absorb"):
            q_lat = torch.einsum("bshd,rhd->bshr", q_nope, kv_b[..., :N])
            o_lat = mla_decode(q_lat.to(lay.dtype), q_pe.to(lay.dtype).contiguous(), lay,
                               seq_positions, mask, scale, impl=impl)
            out = torch.einsum("bshr,rhd->bshd", o_lat.to(x.dtype), kv_b[..., N:])
    else:
        Tk = key_columns(S, cache, cache_offset)
        with torch.profiler.record_function("mla.expand"):
            kv = dense(lay[:, :Tk, :R].to(x.dtype), p["kv_b_w"], impl).reshape(B, Tk, H, N + Dv)
        with torch.profiler.record_function("mla.prefill_attn"):
            out = mla_prefill_attention(q_nope, q_pe.contiguous(), kv[..., :N],
                                        lay[:, :Tk, R:].to(x.dtype), kv[..., N:],
                                        seq_positions, mask[:, :Tk], scale, impl=impl)
    return dense(out.reshape(B, S, H * Dv), p["o_w"], impl)


def _mlp(p: dict, cfg: KimiTextConfig, x: torch.Tensor, impl: str) -> torch.Tensor:
    if "router" in p:
        return moe_mlp(p, cfg, x, impl)
    return dense(F.silu(dense(x, p["gate_w"], impl)) * dense(x, p["up_w"], impl), p["down_w"],
                 impl)


def text_forward(params: dict, cfg: KimiTextConfig, inputs_embeds: torch.Tensor,
                 position_ids: torch.Tensor, *, seq_positions: Optional[torch.Tensor] = None,
                 attn_valid: Optional[torch.Tensor] = None, cache: Optional[dict] = None,
                 cache_offset: int | torch.Tensor = 0, attn_impl: str = "auto",
                 validity_only: bool = False, **unused):
    """(hidden states (B, S, D) after the final norm, the cache updated in
    place), with the arguments of ``qwen25vl.text.text_forward`` that the
    engine passes: ``position_ids`` (3, B, S) (the first axis is read),
    ``seq_positions`` (B, S) buffer positions (default arange + offset),
    ``attn_valid`` (B, T) slot validity, ``cache`` (``init_kv_cache``),
    ``cache_offset`` an int or, for a decode step, a 0-d or (1,) int64
    tensor on the device, ``validity_only`` (the ring's decode step masks
    by validity alone). ``decode_attn_impl``, ``remat`` and the deepstack
    arguments have no meaning here and are refused where set."""
    for key, value in unused.items():
        if value not in (None, False, "auto"):
            raise ValueError(f"the Kimi-VL decoder does not take {key}={value!r}")
    B, S, _ = inputs_embeds.shape
    if seq_positions is None:
        seq_positions = torch.arange(S, device=inputs_embeds.device).expand(B, S) + cache_offset
    cos, sin = rope_cos_sin(position_ids[0], cfg, inputs_embeds.dtype)
    x = inputs_embeds
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["input_norm"], cfg.rms_norm_eps, attn_impl)
        x = x + _attention(layer, cfg, h, cos, sin, seq_positions, attn_valid, cache, i,
                           cache_offset, attn_impl, validity_only)
        h = rms_norm(x, layer["post_norm"], cfg.rms_norm_eps, attn_impl)
        x = x + _mlp(layer, cfg, h, attn_impl)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps, attn_impl), cache
