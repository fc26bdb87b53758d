"""MoonViT, Kimi-VL's tower, and its projector (counterpart of nothing in
the JAX package: the family is new to the port).

The blocks are the Qwen3-VL tower's LayerNorm / GELU-tanh blocks
(``qwen25vl.vision``'s norms, ``dense`` and whole-frame attention through
K2) with MoonViT's settings: LayerNorm eps 1e-5, patch 14 with a bias and
no temporal patch (every frame is an image of its own), a learned 64 x 64
position table resized bicubically to each frame's grid, and a 2-D rope
over interleaved pairs: the pair (2j, 2j + 1) of a head's 72 dims turns by
the patch's column for even j and by its row for odd j, at frequency
theta^(-4 (j // 2) / 72). After the blocks a final LayerNorm, then the
projector: LayerNorm over the width, each 2 x 2 block of patches
concatenated, two linears with a GELU between.

Patches come in merge-block order (``ops.preprocess.patchify_device``:
the four patches of a 2 x 2 block one after the other), so the merge is a
reshape; the position table and the rope are laid out in that order.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.quant import dense
from ..qwen25vl.vision import _make_segment_spec, _segmented_attention, layer_norm
from .config import KimiVisionConfig


def merge_block_coords(h: int, w: int, merge: int) -> tuple[np.ndarray, np.ndarray]:
    """Row and column of each patch of an (h, w) grid in merge-block
    order."""
    rows = np.arange(h)[:, None].repeat(w, 1).reshape(h // merge, merge, w // merge, merge)
    cols = np.arange(w)[None, :].repeat(h, 0).reshape(h // merge, merge, w // merge, merge)
    return (rows.transpose(0, 2, 1, 3).reshape(-1), cols.transpose(0, 2, 1, 3).reshape(-1))


def rope_tables(grids: Sequence[tuple], cfg: KimiVisionConfig, device):
    """cos, sin (S, head_dim // 2) float32 of the 2-D rope, one entry per
    interleaved pair, in merge-block order over every frame."""
    d = cfg.head_dim
    freqs = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 4)[: d // 4] / d))  # (d / 4,)
    angles = []
    for t, h, w in grids:
        rows, cols = merge_block_coords(int(h), int(w), cfg.spatial_merge_size)
        ang = np.stack([cols[:, None] * freqs, rows[:, None] * freqs], -1).reshape(len(rows), -1)
        angles.append(np.tile(ang, (int(t), 1)))
    ang = torch.from_numpy(np.concatenate(angles)).to(device)
    return torch.cos(ang).float(), torch.sin(ang).float()


def apply_rope_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """(S, H, D) turned pairwise: (a, b) -> (a cos - b sin, a sin + b cos)
    at each pair's angle, in float32, back in x's dtype."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    a, b = xf[..., 0], xf[..., 1]
    c, s = cos[:, None], sin[:, None]
    return torch.stack([a * c - b * s, a * s + b * c], -1).reshape(x.shape).to(x.dtype)


def position_embeddings(table: torch.Tensor, grids: Sequence[tuple], merge: int) -> torch.Tensor:
    """The (H0, W0, D) table at each patch of each grid in merge-block
    order: as it is where the grid is (H0, W0), else resized bicubically
    (``align_corners=False``) in float32; repeated over the grid's frames."""
    out = []
    for t, h, w in grids:
        h, w = int(h), int(w)
        if (h, w) == tuple(table.shape[:2]):
            pe = table.float()
        else:
            pe = F.interpolate(table.float().permute(2, 0, 1)[None], size=(h, w), mode="bicubic",
                               align_corners=False)[0].permute(1, 2, 0)
        rows, cols = merge_block_coords(h, w, merge)
        idx = torch.from_numpy(rows * w + cols).to(table.device)
        out.append(pe.reshape(h * w, -1)[idx].repeat(int(t), 1))
    return torch.cat(out).to(table.dtype)


def frame_segments(grids: Sequence[tuple], device):
    """Whole-frame attention's plan for ``_segmented_attention``: equal
    frames as contiguous runs (a reshape), mixed ones as a gather plan."""
    sizes = [int(h) * int(w) for t, h, w in grids for _ in range(int(t))]
    if len(set(sizes)) == 1:
        return sizes[0], torch.ones((len(sizes), sizes[0]), dtype=torch.int32, device=device)
    return _make_segment_spec(np.asarray(sizes, dtype=np.int64))


def _block(p: dict, x, cos, sin, seg, cfg: KimiVisionConfig, impl: str):
    S = x.shape[0]
    h = layer_norm(x, p["norm1"], p["norm1_b"], cfg.layer_norm_eps)
    qkv = (dense(h, p["qkv_w"], impl) + p["qkv_b"]).reshape(S, 3, -1, cfg.head_dim)
    q = apply_rope_pairs(qkv[:, 0], cos, sin)
    k = apply_rope_pairs(qkv[:, 1], cos, sin)
    attn = _segmented_attention(q, k, qkv[:, 2].contiguous(), seg, impl).reshape(S, -1)
    x = x + (dense(attn, p["proj_w"], impl) + p["proj_b"])
    h = layer_norm(x, p["norm2"], p["norm2_b"], cfg.layer_norm_eps)
    a = F.gelu(dense(h, p["fc1_w"], impl) + p["fc1_b"], approximate="tanh")
    return x + (dense(a, p["fc2_w"], impl) + p["fc2_b"])


def vision_forward(visual: dict, patches: torch.Tensor, grids: Sequence[tuple],
                   cfg: KimiVisionConfig, impl: str = "auto") -> torch.Tensor:
    """patches (S, 3 * 14 * 14) in merge-block order -> the projector's rows
    (S / 4, text hidden), one per 2 x 2 block, in order."""
    dev = patches.device
    x = dense(patches.to(visual["patch_embed"].dtype), visual["patch_embed"])
    x = x + visual["patch_embed_b"]
    x = x + position_embeddings(visual["pos_embed"], grids, cfg.spatial_merge_size).to(x.dtype)
    cos, sin = rope_tables(grids, cfg, dev)
    seg = frame_segments(grids, dev)
    for blk in visual["blocks"]:
        x = _block(blk, x, cos, sin, seg, cfg, impl)
    x = layer_norm(x, visual["final_norm"], visual["final_norm_b"], cfg.layer_norm_eps)
    m = visual["merger"]
    h = layer_norm(x, m["ln_q"], m["ln_q_b"], cfg.layer_norm_eps)
    h = F.gelu(dense(h.reshape(-1, cfg.merge_unit * cfg.hidden_size), m["fc1_w"]) + m["fc1_b"])
    return dense(h, m["fc2_w"]) + m["fc2_b"]
