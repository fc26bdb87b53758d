"""Rotary position embeddings: 2D vision RoPE and multimodal (M-)RoPE
(counterpart of ``open_o3_video_tpu/ops/rope.py``).

The vision tables are host-side numpy, copied from the JAX package (which
cannot be imported without JAX); the application runs on tensors.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def vision_rotary_table(head_dim: int, max_pos: int, theta: float = 10000.0) -> np.ndarray:
    """Per-axis frequency table for the ViT 2D RoPE: (max_pos, head_dim // 4)."""
    dim = head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    seq = np.arange(max_pos, dtype=np.float32)
    return np.outer(seq, inv_freq)


def vision_pos_freqs(grid_thw: Sequence[tuple[int, int, int]], merge_size: int,
                     head_dim: int) -> np.ndarray:
    """Rotary angle per vision patch, in merge-block order: (S, head_dim // 2)."""
    pos_ids = []
    for t, h, w in grid_thw:
        hh = np.arange(h).reshape(h, 1).repeat(w, axis=1)
        hh = (
            hh.reshape(h // merge_size, merge_size, w // merge_size, merge_size)
            .transpose(0, 2, 1, 3)
            .reshape(-1)
        )
        ww = np.arange(w).reshape(1, w).repeat(h, axis=0)
        ww = (
            ww.reshape(h // merge_size, merge_size, w // merge_size, merge_size)
            .transpose(0, 2, 1, 3)
            .reshape(-1)
        )
        pos = np.stack([hh, ww], axis=-1)
        pos_ids.append(np.tile(pos, (t, 1)))
    pos_ids = np.concatenate(pos_ids, axis=0)
    max_grid = max(max(h, w) for _, h, w in grid_thw)
    table = vision_rotary_table(head_dim, int(max_grid))
    freqs = table[pos_ids]  # (S, 2, dim // 2)
    return freqs.reshape(freqs.shape[0], -1)


def apply_rope_vision(q: torch.Tensor, k: torch.Tensor, freqs: torch.Tensor):
    """2D RoPE on vision q/k (..., S, H, D) with freqs (S, D/2): applied in
    float32, then cast back to the input dtype."""
    emb = torch.cat([freqs, freqs], dim=-1).float()
    cos = torch.cos(emb)[..., :, None, :]
    sin = torch.sin(emb)[..., :, None, :]
    qf, kf = q.float(), k.float()
    qf = qf * cos + rotate_half(qf) * sin
    kf = kf * cos + rotate_half(kf) * sin
    return qf.to(q.dtype), kf.to(k.dtype)


def mrope_cos_sin(position_ids: torch.Tensor, head_dim: int, mrope_section: Sequence[int],
                  theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin (B, S, head_dim) float32 from (3, B, S) positions: section s of
    the doubled mrope_section takes axis s % 3 (temporal, height, width)."""
    dev = position_ids.device
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim)
    )
    freqs = position_ids.float()[..., None] * inv_freq  # (3, B, S, D/2)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = torch.cos(emb), torch.sin(emb)
    sections = list(mrope_section) * 2
    starts = np.cumsum([0] + sections[:-1])
    cos_parts = [cos[i % 3][..., int(s):int(s) + int(w)]
                 for i, (s, w) in enumerate(zip(starts, sections))]
    sin_parts = [sin[i % 3][..., int(s):int(s) + int(w)]
                 for i, (s, w) in enumerate(zip(starts, sections))]
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def mrope_cos_sin_interleaved(position_ids: torch.Tensor, head_dim: int,
                              mrope_section: Sequence[int],
                              theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen3-VL's interleaved M-RoPE: frequency f takes the temporal axis,
    except f = 1, 4, 7, ... below 3 * section[1], which take height, and f =
    2, 5, 8, ... below 3 * section[2], which take width (HF
    ``Qwen3VLTextRotaryEmbedding.apply_interleaved_mrope``). cos/sin (B, S,
    head_dim) float32 from (3, B, S) positions. Where the three axes carry
    one position (text, and every decode step) it equals plain rope."""
    dev = position_ids.device
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim)
    )
    freqs = position_ids.float()[..., None] * inv_freq  # (3, B, S, D/2)
    # the axis of each frequency, made on the device (a decode step is
    # captured in a CUDA graph, which no host-to-device copy may enter)
    idx = torch.arange(head_dim // 2, device=dev)
    axis = torch.where((idx % 3 == 1) & (idx < 3 * int(mrope_section[1])), 1,
                       torch.where((idx % 3 == 2) & (idx < 3 * int(mrope_section[2])), 2, 0))
    merged = torch.gather(freqs, 0, axis.expand(freqs.shape[1:])[None])[0]  # (B, S, D/2)
    emb = torch.cat([merged, merged], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_mrope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate q/k (B, S, H, D) by cos/sin (B, S, D), in the inputs' dtype."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    q_out = q * cos + rotate_half(q) * sin
    k_out = k * cos + rotate_half(k) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)
