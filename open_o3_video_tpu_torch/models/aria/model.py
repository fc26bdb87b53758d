"""Aria's full model: vision tower -> projector -> the shared decoder with
mixture-of-experts MLPs (counterpart of ``open_o3_video_tpu/models/aria/model.py``).

The decoder is ``models/qwen25vl/text.py``'s: Aria's rope is chunked M-RoPE
with every frequency in the temporal section (1-D rope when the three axes
carry one position), and its MLPs take the ``router`` branch, so the
inference engine serves it, its image features entering a request as
``Request.vision_embeds``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..qwen25vl.model import embed_tokens, merge_vision_embeddings_by_index
from ..qwen25vl.text import logits_from_hidden, text_forward
from .config import AriaConfig
from .vision import projector, vision_tower


def get_image_features(params: dict, cfg: AriaConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """(n_images, C, H, W) -> (n_images * query_num, text hidden) feature
    rows (HF ``AriaModel.get_image_features`` at ``vision_feature_layer=-1``)."""
    states = vision_tower(params["visual"], cfg.vision, pixel_values.to(cfg.dtype))
    feats = projector(params, cfg, states)
    return feats.reshape(-1, feats.shape[-1])


def get_rope_index(cfg: AriaConfig, input_ids: np.ndarray,
                   attention_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Sequential positions as the (3, B, S) M-RoPE shape (identical axes:
    plain 1-D rope); padding keeps position 1."""
    B, S = np.asarray(input_ids).shape
    if attention_mask is not None:
        pos = np.cumsum(attention_mask, axis=-1) - 1
        pos[attention_mask == 0] = 1
    else:
        pos = np.broadcast_to(np.arange(S)[None], (B, S))
    return np.broadcast_to(pos[None], (3, B, S)).copy()


def forward(
    params: dict,
    cfg: AriaConfig,
    input_ids: torch.Tensor,  # (B, S)
    position_ids: Optional[torch.Tensor] = None,  # (3, B, S)
    *,
    pixel_values: Optional[torch.Tensor] = None,  # (n_images, C, H, W)
    vision_row_index: Optional[torch.Tensor] = None,  # (B, S): position -> feature row
    attn_valid: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
    cache_offset: int = 0,
    seq_positions: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    remat: bool = False,
    return_hidden: bool = False,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Full forward -> (logits (B, S, vocab) float32, the cache).

    Without ``vision_row_index`` the n-th image token takes the n-th feature
    row; with it, several rows may share one encoding (GSPO's layout).
    ``return_hidden=True`` returns the final-norm hidden states instead."""
    embeds = embed_tokens(params, input_ids)
    if pixel_values is not None:
        feats = get_image_features(params, cfg, pixel_values)
        if vision_row_index is None:
            mask = input_ids == cfg.image_token_id
            vision_row_index = torch.where(
                mask, torch.cumsum(mask.reshape(-1).long(), 0).reshape(mask.shape) - 1, -1)
        embeds = merge_vision_embeddings_by_index(embeds, feats, vision_row_index)
    if position_ids is None:
        B, S = input_ids.shape
        pos = torch.arange(S, device=input_ids.device).expand(B, S) + cache_offset
        position_ids = pos[None].expand(3, B, S)
    hidden, cache = text_forward(params["text"], cfg.text, embeds, position_ids,
                                 seq_positions=seq_positions, attn_valid=attn_valid, cache=cache,
                                 cache_offset=cache_offset, attn_impl=attn_impl, remat=remat)
    if return_hidden:
        return hidden, cache
    return logits_from_hidden(params["text"], hidden, attn_impl), cache
