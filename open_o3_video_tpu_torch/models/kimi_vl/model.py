"""Kimi-VL's whole model: the tower's rows scattered into the token
stream at the vision placeholders, then the decoder. Positions are 1-D:
``get_rope_index`` gives them in the shared (3, B, S) layout, every axis
alike (the engine's ``left_padded_rows`` computes the same through the
Qwen code, since the config has no vision-start id)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..qwen25vl.model import check_vision_inputs, embed_tokens, merge_vision_embeddings
from ..qwen25vl.text import logits_from_hidden
from .config import KimiVLConfig
from .text import text_forward
from .vision import vision_forward


def get_rope_index(cfg: KimiVLConfig, input_ids: np.ndarray,
                   attention_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Sequential positions over the valid tokens as (3, B, S); padding
    keeps position 1, as the shared code keeps it."""
    B, S = np.asarray(input_ids).shape
    if attention_mask is None:
        pos = np.broadcast_to(np.arange(S)[None], (B, S))
    else:
        pos = np.cumsum(attention_mask, axis=-1) - 1
        pos[attention_mask == 0] = 1
    return np.broadcast_to(pos[None], (3, B, S)).copy()


def encode_vision(params: dict, cfg: KimiVLConfig, pixel_patches: torch.Tensor,
                  grid_thw: np.ndarray, impl: str = "auto", remat: bool = False):
    """MoonViT and the projector: (S_patches / 4, text hidden) rows."""
    if remat:
        raise ValueError("the Kimi-VL tower is served only; it has no remat")
    grids = [tuple(int(x) for x in g) for g in np.asarray(grid_thw)]
    return vision_forward(params["visual"], pixel_patches, grids, cfg.vision, impl=impl)


def forward(params: dict, cfg: KimiVLConfig, input_ids: torch.Tensor,
            position_ids: Optional[torch.Tensor] = None, *,
            pixel_patches: Optional[torch.Tensor] = None, grid_thw=None,
            attn_valid: Optional[torch.Tensor] = None, attn_impl: str = "auto",
            return_hidden: bool = False):
    """Full cacheless forward -> (logits (B, S, vocab) float32, None); the
    n-th placeholder takes the n-th vision row."""
    embeds = embed_tokens(params, input_ids)
    if pixel_patches is not None:
        check_vision_inputs(cfg, pixel_patches.shape[0], grid_thw)
        vis = encode_vision(params, cfg, pixel_patches, grid_thw, impl=attn_impl)
        embeds = merge_vision_embeddings(cfg, input_ids, embeds, vis, cfg.image_token_id)
    if position_ids is None:
        mask = None if attn_valid is None else attn_valid.cpu().numpy().astype(np.int64)
        position_ids = torch.from_numpy(get_rope_index(cfg, input_ids.cpu().numpy(), mask)
                                        ).to(input_ids.device)
    hidden, _ = text_forward(params["text"], cfg.text, embeds, position_ids,
                             attn_valid=attn_valid, attn_impl=attn_impl)
    if return_hidden:
        return hidden, None
    return logits_from_hidden(params["text"], hidden, attn_impl), None


def refuse_engine_options(params: dict, *, cache_dtype, mesh, spec_decode, spec_sample,
                          a8_prefill) -> None:
    """Raise ValueError for what ``InferenceEngine`` does not serve Kimi-VL
    with: a mesh, speculative decoding, w8a8 prefill, quantized weights or a
    cache other than bf16 (float32 on the CPU)."""
    asked = {"mesh": mesh is not None, "spec_decode": spec_decode, "spec_sample": spec_sample,
             "a8_prefill": bool(a8_prefill),
             "cache_dtype": cache_dtype not in (torch.bfloat16, torch.float32),
             "quantized weights": any(not isinstance(w, torch.Tensor)
                                      for w in params["text"]["layers"][0].values())}
    bad = [k for k, v in asked.items() if v]
    if bad:
        raise ValueError(f"Kimi-VL is served with bf16 weights and a bf16 latent cache on one "
                         f"device, without speculative decoding: {bad} not supported")
