"""Qwen2.5-VL text decoder: GQA + M-RoPE, prefill and cached decode
(counterpart of ``open_o3_video_tpu/models/qwen25vl/text.py``).

Functions over a param dict. The KV cache is one stacked (L, B, T, Hkv, D)
pair of tensors updated in place: ``cache["k"][layer]`` is already a
contiguous view, which attention reads through its strides. The JAX
package's ``stacked_layer`` plumbing, which exists because a Pallas call's
operands must be whole buffers, therefore has no counterpart here.
Causality follows buffer positions (``seq_positions``); M-RoPE positions only
rotate q/k. Left-padded batches are masked through ``attn_valid``. Every
matmul weight and the lm_head go through ``ops.quant.dense``, so a param
dict with int8 or int4 weights (``params.init(quantize_text=...)``) serves
through the same code; biases add after the quantized matmul.

The cache stores bf16, f32 or fp8 e4m3 (``torch.float8_e4m3fn``, half the
bytes of bf16). Attention receives the layer views in that stored dtype
unchanged: long-context decode (K4) reads them as stored, and only the
other paths cast the layer to the compute dtype (``ops/attention.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...ops.attention import causal_attention
from ...ops.quant import dense
from ...ops.rope import apply_mrope, mrope_cos_sin
from .config import TextConfig
from .vision import rms_norm


def init_kv_cache(cfg: TextConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None) -> dict:
    """Zeroed stacked cache {"k", "v"} of (L, batch, max_len, Hkv, D) in
    ``dtype`` (bf16, f32 or torch.float8_e4m3fn)."""
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


# The largest finite float8_e4m3fn value.
E4M3_MAX = 448.0


def write_cache(dst: torch.Tensor, x: torch.Tensor) -> None:
    """Store new keys or values ``x`` into the cache slice ``dst``, cast to
    the cache's dtype.

    Into a float8_e4m3fn cache the write saturates: a value beyond 448 is
    stored as +-448. Up to 448 in magnitude the bytes equal the JAX
    package's ``astype(float8_e4m3fn)``; above 464 JAX stores NaN instead,
    and so does torch's own cast in some versions and on some devices (on
    the card, not on the CPU), hence the explicit clamp. Saturating is kept
    on purpose: a NaN in the cache would poison every later step that reads
    the slot."""
    if dst.dtype == torch.float8_e4m3fn:
        x = x.clamp(-E4M3_MAX, E4M3_MAX)
    dst.copy_(x)


def _attention_layer(p, cfg: TextConfig, x, cos, sin, seq_positions, kv_mask,
                     cache, layer: int, cache_offset: int, impl: str):
    B, S, _ = x.shape
    q = (dense(x, p["q_w"], impl) + p["q_b"]).reshape(B, S, cfg.num_attention_heads, cfg.head_dim)
    k = (dense(x, p["k_w"], impl) + p["k_b"]).reshape(B, S, cfg.num_key_value_heads, cfg.head_dim)
    v = (dense(x, p["v_w"], impl) + p["v_b"]).reshape(B, S, cfg.num_key_value_heads, cfg.head_dim)
    q, k = apply_mrope(q, k, cos, sin)
    if cache is not None:
        ck, cv = cache["k"][layer], cache["v"][layer]  # (B, T, Hkv, D) views
        write_cache(ck[:, cache_offset:cache_offset + S], k)
        write_cache(cv[:, cache_offset:cache_offset + S], v)
        T = ck.shape[1]
        written = torch.arange(T, device=x.device)[None, :] < cache_offset + S
        mask = written if kv_mask is None else kv_mask & written
        out = causal_attention(q, ck, cv, q_positions=seq_positions, kv_mask=mask, impl=impl)
    else:
        out = causal_attention(q, k, v, q_positions=seq_positions, kv_mask=kv_mask, impl=impl)
    return dense(out.reshape(B, S, -1), p["o_w"], impl)


def text_forward(
    params: dict,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # (B, S, D)
    position_ids: torch.Tensor,  # (3, B, S) M-RoPE positions
    *,
    seq_positions: Optional[torch.Tensor] = None,  # (B, S); default arange + offset
    attn_valid: Optional[torch.Tensor] = None,  # (B, T) bool slot validity
    cache: Optional[dict] = None,
    cache_offset: int = 0,
    attn_impl: str = "auto",
    remat: bool = False,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Returns (hidden states (B, S, D) after the final norm, the cache,
    updated in place).

    ``attn_impl`` picks, for every kernel of the decoder (attention, and K7
    where a matmul weight is int4), the kernel ("auto", on CUDA tensors) or
    its plain version ("torch").

    ``remat=True`` recomputes each decoder layer in the backward pass
    (``jax.checkpoint`` per layer in the JAX package; the reference's
    gradient checkpointing). The checkpoint is non-reentrant, so its first
    forward runs under autograd like the recompute, and attention picks its
    exact training mode in both."""
    B, S, _ = inputs_embeds.shape
    if seq_positions is None:
        seq_positions = torch.arange(S, device=inputs_embeds.device).expand(B, S) + cache_offset
    cos, sin = mrope_cos_sin(position_ids, cfg.head_dim, cfg.mrope_section, cfg.rope_theta)
    cos = cos.to(inputs_embeds.dtype)
    sin = sin.to(inputs_embeds.dtype)

    def layer_fn(x, layer, i):
        h = rms_norm(x, layer["input_norm"], cfg.rms_norm_eps)
        x = x + _attention_layer(layer, cfg, h, cos, sin, seq_positions, attn_valid,
                                 cache, i, cache_offset, attn_impl)
        h = rms_norm(x, layer["post_norm"], cfg.rms_norm_eps)
        act = F.silu(dense(h, layer["gate_w"], attn_impl)) * dense(h, layer["up_w"], attn_impl)
        return x + dense(act, layer["down_w"], attn_impl)

    x = inputs_embeds
    for i, layer in enumerate(params["layers"]):
        if remat:
            x = checkpoint(layer_fn, x, layer, i, use_reentrant=False)
        else:
            x = layer_fn(x, layer, i)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps), cache


def logits_from_hidden(params: dict, hidden: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Final hidden states -> vocabulary logits (float32)."""
    return dense(hidden, params["lm_head"], impl).float()


def _token_logps(params: dict, hidden: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits_from_hidden(params, hidden), dim=-1)
    return torch.gather(logp, -1, targets[..., None])[..., 0]


def per_token_logps_from_hidden(params: dict, hidden: torch.Tensor, targets: torch.Tensor,
                                chunk: Optional[int] = None) -> torch.Tensor:
    """log P(targets | hidden) (B, S) float32 without the full (B, S, vocab)
    logits: with ``chunk`` < S the positions go through the lm_head
    ``chunk`` at a time, each chunk checkpointed, so the backward recomputes
    its logits from the hidden slice instead of keeping them (the JAX
    package's scanned, rematerialized lm_head)."""
    S = hidden.shape[1]
    if chunk is None or S <= chunk:
        return _token_logps(params, hidden, targets)
    parts = [checkpoint(_token_logps, params, hidden[:, i:i + chunk], targets[:, i:i + chunk],
                        use_reentrant=False)
             for i in range(0, S, chunk)]
    return torch.cat(parts, dim=1)
