"""Qwen2.5-VL full model: vision features scattered into the token stream
(counterpart of ``open_o3_video_tpu/models/qwen25vl/model.py``).

``get_rope_index`` and ``build_vision_row_index`` are host-side numpy,
copied from the JAX package (its module imports JAX), restricted to the
Qwen2.5-VL family.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .config import Qwen25VLConfig
from .text import logits_from_hidden, text_forward
from .vision import compute_vision_spec, vision_forward


def get_rope_index(
    cfg: Qwen25VLConfig,
    input_ids: np.ndarray,  # (B, S)
    image_grid_thw: Optional[np.ndarray] = None,  # (num_images, 3)
    video_grid_thw: Optional[np.ndarray] = None,  # (num_videos, 3)
    second_per_grid_ts: Optional[Sequence[float]] = None,
    attention_mask: Optional[np.ndarray] = None,  # (B, S) 1 = valid
) -> tuple[np.ndarray, np.ndarray]:
    """3D M-RoPE position ids (3, B, S) + per-row rope deltas (B, 1).

    Vision blocks get (t, h, w) grid positions (t scaled by tokens_per_second
    x second_per_grid); text runs on from the running max + 1. Padding
    positions keep position 1, as in HF.
    """
    merge = cfg.vision.spatial_merge_size
    B, S = input_ids.shape
    if image_grid_thw is None and video_grid_thw is None:
        if attention_mask is not None:
            pos = np.cumsum(attention_mask, axis=-1) - 1
            pos[attention_mask == 0] = 1
            position_ids = np.broadcast_to(pos[None], (3, B, S)).copy()
            deltas = position_ids.max(axis=(0, 2), keepdims=False) + 1 - S
            return position_ids, deltas.reshape(B, 1)
        pos = np.broadcast_to(np.arange(S)[None], (B, S))
        return np.broadcast_to(pos[None], (3, B, S)).copy(), np.zeros((B, 1), dtype=np.int64)

    position_ids = np.ones((3, B, S), dtype=np.int64)
    deltas = []
    image_index, video_index = 0, 0
    for i in range(B):
        row = input_ids[i]
        if attention_mask is not None:
            row = row[attention_mask[i] == 1]
        starts = np.where(row == cfg.vision_start_token_id)[0]
        # a vision_start on the last token opens no vision block
        starts = starts[starts + 1 < len(row)]
        vision_tokens = row[starts + 1] if len(starts) else np.array([], dtype=row.dtype)
        image_nums = int((vision_tokens == cfg.image_token_id).sum())
        video_nums = int((vision_tokens == cfg.video_token_id).sum())
        tokens = row.tolist()
        pos_list = []
        st = 0
        remain_images, remain_videos = image_nums, video_nums
        for _ in range(image_nums + video_nums):
            ed_image = (tokens.index(cfg.image_token_id, st)
                        if (cfg.image_token_id in tokens[st:] and remain_images > 0)
                        else len(tokens) + 1)
            ed_video = (tokens.index(cfg.video_token_id, st)
                        if (cfg.video_token_id in tokens[st:] and remain_videos > 0)
                        else len(tokens) + 1)
            if ed_image < ed_video:
                t, h, w = image_grid_thw[image_index]
                second_per_grid = 0.0
                image_index += 1
                remain_images -= 1
                ed = ed_image
            else:
                t, h, w = video_grid_thw[video_index]
                second_per_grid = (
                    float(second_per_grid_ts[video_index]) if second_per_grid_ts is not None else 1.0
                )
                video_index += 1
                remain_videos -= 1
                ed = ed_video
            lt, lh, lw = int(t), int(h) // merge, int(w) // merge
            text_len = ed - st
            st_idx = int(pos_list[-1].max()) + 1 if pos_list else 0
            pos_list.append(np.broadcast_to(np.arange(text_len)[None], (3, text_len)) + st_idx)
            # HF quirk kept: second_per_grid is truncated to an integer
            # before the multiply (0.5 -> 0).
            t_index = (
                (np.arange(lt)[:, None] * int(second_per_grid) * cfg.vision.tokens_per_second)
                .astype(np.int64)
                .repeat(lh * lw, axis=1)
                .flatten()
            )
            h_index = np.tile(np.arange(lh)[None, :, None], (lt, 1, lw)).flatten()
            w_index = np.tile(np.arange(lw)[None, None, :], (lt, lh, 1)).flatten()
            pos_list.append(np.stack([t_index, h_index, w_index]) + text_len + st_idx)
            st = ed + lt * lh * lw

        if st < len(tokens):
            st_idx = int(pos_list[-1].max()) + 1 if pos_list else 0
            text_len = len(tokens) - st
            pos_list.append(np.broadcast_to(np.arange(text_len)[None], (3, text_len)) + st_idx)

        positions = np.concatenate(pos_list, axis=1)
        if attention_mask is not None:
            position_ids[:, i, attention_mask[i] == 1] = positions
        else:
            position_ids[:, i, :] = positions
        deltas.append(int(positions.max()) + 1 - S)
    return position_ids, np.asarray(deltas, dtype=np.int64).reshape(B, 1)


def build_vision_row_index(
    input_ids: np.ndarray,  # (B, S)
    token_id,  # int, or one per row
    row_offsets: Sequence[Optional[int]],  # per row: vision-table offset, or None
) -> np.ndarray:
    """Host-side (B, S) int32 map: n-th placeholder of row b -> row_offsets[b]+n,
    -1 elsewhere. Rows with offset None keep their text embeddings."""
    B, S = input_ids.shape
    toks = [token_id] * B if np.ndim(token_id) == 0 else list(token_id)
    idx = np.full((B, S), -1, dtype=np.int32)
    for b in range(B):
        if row_offsets[b] is None or toks[b] is None:
            continue
        pos = np.where(input_ids[b] == toks[b])[0]
        idx[b, pos] = row_offsets[b] + np.arange(len(pos), dtype=np.int32)
    return idx


def encode_vision(params: dict, cfg: Qwen25VLConfig, pixel_patches: torch.Tensor,
                  grid_thw: np.ndarray, impl: str = "auto", remat: bool = False) -> torch.Tensor:
    """Vision tower -> merged embeddings (S_patches / merge_unit, hidden)."""
    spec = compute_vision_spec([tuple(int(v) for v in g) for g in np.asarray(grid_thw)],
                               cfg.vision)
    return vision_forward(params["visual"], pixel_patches, spec, cfg.vision, impl=impl,
                          remat=remat)


def embed_tokens(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    return params["text"]["embed_tokens"][input_ids]


def merge_vision_embeddings(cfg: Qwen25VLConfig, input_ids: torch.Tensor,
                            inputs_embeds: torch.Tensor, vision_embeds: torch.Tensor,
                            token_id: int) -> torch.Tensor:
    """n-th placeholder slot (in row-major order) <- n-th vision row."""
    mask = (input_ids == token_id).reshape(-1)
    flat = inputs_embeds.reshape(-1, inputs_embeds.shape[-1])
    rank = torch.cumsum(mask.long(), 0) - 1
    gathered = vision_embeds[rank.clamp(0, vision_embeds.shape[0] - 1)]
    out = torch.where(mask[:, None], gathered.to(flat.dtype), flat)
    return out.reshape(inputs_embeds.shape)


def merge_vision_embeddings_by_index(inputs_embeds: torch.Tensor, vision_embeds: torch.Tensor,
                                     vision_row_index: torch.Tensor) -> torch.Tensor:
    """Scatter vision rows into token slots by an explicit (B, S) index map
    (-1 = keep the text embedding)."""
    flat_idx = vision_row_index.reshape(-1).long()
    flat = inputs_embeds.reshape(-1, inputs_embeds.shape[-1])
    gathered = vision_embeds[flat_idx.clamp(0, vision_embeds.shape[0] - 1)]
    out = torch.where((flat_idx >= 0)[:, None], gathered.to(flat.dtype), flat)
    return out.reshape(inputs_embeds.shape)


def forward(
    params: dict,
    cfg: Qwen25VLConfig,
    input_ids: torch.Tensor,  # (B, S)
    position_ids: torch.Tensor,  # (3, B, S)
    *,
    pixel_patches: Optional[torch.Tensor] = None,
    grid_thw: Optional[np.ndarray] = None,
    vision_token_id: Optional[int] = None,
    vision_row_index: Optional[torch.Tensor] = None,
    attn_valid: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
    cache_offset: int = 0,
    seq_positions: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    remat: bool = False,
    return_hidden: bool = False,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Full forward -> (logits (B, S, vocab) float32, the cache).

    ``vision_row_index`` (B, S) maps token slots to vision rows (-1 = text),
    as ``pack_sft_batch`` builds it; without it the n-th placeholder takes
    the n-th row. ``remat`` checkpoints every vision block and decoder
    layer. ``return_hidden=True`` returns the final-norm hidden states
    instead of logits, for callers that project only some positions."""
    embeds = embed_tokens(params, input_ids)
    if pixel_patches is not None:
        vis = encode_vision(params, cfg, pixel_patches, grid_thw, impl=attn_impl, remat=remat)
        if vision_row_index is not None:
            embeds = merge_vision_embeddings_by_index(embeds, vis, vision_row_index)
        else:
            tok = vision_token_id if vision_token_id is not None else cfg.image_token_id
            embeds = merge_vision_embeddings(cfg, input_ids, embeds, vis, tok)
    hidden, cache = text_forward(
        params["text"], cfg.text, embeds, position_ids,
        seq_positions=seq_positions, attn_valid=attn_valid, cache=cache,
        cache_offset=cache_offset, attn_impl=attn_impl, remat=remat,
    )
    if return_hidden:
        return hidden, cache
    return logits_from_hidden(params["text"], hidden, attn_impl), cache
