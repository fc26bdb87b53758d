"""The plain float32 reference of Kimi-VL for the card: MoonViT, the
projector and the DeepSeek-V3 decoder over a whole sequence, with no cache,
no batching and no kernel; the card's copy of ``tests/reference_kimi_vl.py``
(a test holds the two equal on a tiny forward).

Written from transformers' ``modeling_deepseek_v3.py`` (DeepseekV3Attention
with ``rope_interleave``, DeepseekV3TopkRouter with one group,
DeepseekV3MoE, DeepseekV3MLP) and Kimi-VL's MoonViT as its model card and
technical report (arXiv:2504.07491, section 2.1) describe it, in plain
PyTorch; it imports nothing of the program or of JAX. The weights are the
benchmark's bf16 tensors (``lib.kimi_weights``, the program's input-major
layout), each layer's cast to float32 as it is used, so the model never
exists whole in float32; every product in full float32 (``full_float32``:
TF32 off). ``mm`` computes every product with a weight (the float8
control passes ``qwen_vl.fp8_matmul``).

Departures from the published code, none of which changes the function:
attention in the expanded form (each head's keys and values from ``kv_b``),
a block of queries at a time; each routed expert over the tokens that chose
it only (the others' weights are 0 in the published combine); patches in
2 x 2 merge-block order (the program's layout), so the position table and
the rope are gathered in that order and the projector's merge is a
reshape; the position table resized in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..lib.kimi_arch import Arch
from .qwen_vl import f32, full_float32, layer_norm, matmul, rms_norm

__all__ = ["full_float32", "vision_tower", "logits", "patch_rows"]

QUERY_BLOCK = 1024


def merge_block_coords(h: int, w: int, merge: int):
    rows = np.arange(h)[:, None].repeat(w, 1).reshape(h // merge, merge, w // merge, merge)
    cols = np.arange(w)[None, :].repeat(h, 0).reshape(h // merge, merge, w // merge, merge)
    return rows.transpose(0, 2, 1, 3).reshape(-1), cols.transpose(0, 2, 1, 3).reshape(-1)


def patch_rows(frames: torch.Tensor, a: Arch) -> torch.Tensor:
    """(T, C, H, W) values in [0, 255] -> float32 patch rows (T * H/p *
    W/p, C * p * p) in merge-block order, normalised by the processor's
    mean and std."""
    v = a.vision
    x = frames.to(torch.float64) / 255.0
    mean = torch.tensor(v.mean, dtype=torch.float64, device=x.device)[:, None, None]
    std = torch.tensor(v.std, dtype=torch.float64, device=x.device)[:, None, None]
    x = (x - mean) / std
    T, C, H, W = x.shape
    p, m = v.patch, v.merge
    x = x.reshape(T, C, H // p // m, m, p, W // p // m, m, p).permute(0, 2, 5, 3, 6, 1, 4, 7)
    return x.reshape(T * (H // p) * (W // p), C * p * p).to(torch.float32)


def vision_tower(visual: dict, a: Arch, patches: torch.Tensor, grids: Sequence[tuple],
                 mm=matmul) -> torch.Tensor:
    """Patch rows (S, 3 * p * p) -> the projector's rows (S / 4, text
    hidden) in float32."""
    v = a.vision
    D, heads, hd, eps = v.hidden, v.heads, v.head_dim, v.eps
    x = patches.float() @ visual["patch_embed"].float() + visual["patch_embed_b"].float()
    table = visual["pos_embed"].float()
    freqs = 1.0 / (v.theta ** (np.arange(0, hd, 4)[: hd // 4] / hd))
    pos, angles, frames, at = [], [], [], 0
    for t, h, w in grids:
        pe = table if (h, w) == tuple(table.shape[:2]) else F.interpolate(
            table.permute(2, 0, 1)[None], size=(h, w), mode="bicubic",
            align_corners=False)[0].permute(1, 2, 0)
        r, c = merge_block_coords(h, w, v.merge)
        pos.append(pe.reshape(h * w, D)[torch.from_numpy(r * w + c).to(pe.device)].repeat(t, 1))
        angles.append(np.tile(np.stack([c[:, None] * freqs, r[:, None] * freqs],
                                       -1).reshape(h * w, -1), (t, 1)))
        for _ in range(t):
            frames.append(slice(at, at + h * w))
            at += h * w
    x = x + torch.cat(pos)
    ang = torch.from_numpy(np.concatenate(angles)).to(x.device)
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]

    def rope(y):
        y = y.reshape(*y.shape[:-1], -1, 2)
        ya, yb = y[..., 0], y[..., 1]
        return torch.stack([ya * cos - yb * sin, ya * sin + yb * cos], -1).flatten(-2)

    S = x.shape[0]
    for blk in visual["blocks"]:
        p = f32(blk)
        h = layer_norm(x, p["norm1"], p["norm1_b"], eps)
        qkv = (mm(h, p["qkv_w"]) + p["qkv_b"]).reshape(S, 3, heads, hd)
        q, k, val = rope(qkv[:, 0]), rope(qkv[:, 1]), qkv[:, 2]
        out = torch.empty_like(q)
        for fr in frames:
            s = torch.einsum("qhd,khd->hqk", q[fr], k[fr]) * hd ** -0.5
            out[fr] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), val[fr])
        x = x + mm(out.reshape(S, D), p["proj_w"]) + p["proj_b"]
        h = layer_norm(x, p["norm2"], p["norm2_b"], eps)
        x = x + mm(F.gelu(mm(h, p["fc1_w"]) + p["fc1_b"], approximate="tanh"), p["fc2_w"]) \
            + p["fc2_b"]
    x = layer_norm(x, visual["final_norm"].float(), visual["final_norm_b"].float(), eps)
    m = f32(visual["merger"])
    h = layer_norm(x, m["ln_q"], m["ln_q_b"], eps).reshape(-1, D * v.unit)
    return mm(F.gelu(mm(h, m["fc1_w"]) + m["fc1_b"]), m["fc2_w"]) + m["fc2_b"]


def rope_1d(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """DeepSeek-V3's rope with ``rope_interleave`` on x (S, ..., d)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = positions.float()[:, None] * inv
    emb = torch.cat([ang, ang], -1)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (d,)
    cos, sin = emb.cos().reshape(shape), emb.sin().reshape(shape)
    x = torch.cat([x[..., 0::2], x[..., 1::2]], -1)
    x1, x2 = x.chunk(2, -1)
    return x * cos + torch.cat([-x2, x1], -1) * sin


def attention(p: dict, a: Arch, h: torch.Tensor, positions: torch.Tensor, mm=matmul,
              query_block: int = QUERY_BLOCK) -> torch.Tensor:
    t = a.text
    S = h.shape[0]
    H, N, R, Dv = t.heads, t.nope, t.kv_rank, t.v_dim
    q = mm(h, p["q_w"]).reshape(S, H, t.qk_dim)
    q = torch.cat([q[..., :N], rope_1d(q[..., N:], positions, t.theta)], -1)
    ckv = mm(h, p["kv_a_w"])
    c = rms_norm(ckv[:, :R], p["kv_norm"], t.kv_eps)
    k_pe = rope_1d(ckv[:, R:], positions, t.theta)
    kv = mm(c, p["kv_b_w"]).reshape(S, H, N + Dv)
    k = torch.cat([kv[..., :N], k_pe[:, None].expand(S, H, -1)], -1)
    val = kv[..., N:]
    out = torch.empty(S, H, Dv, device=h.device)
    for s0 in range(0, S, query_block):
        s1 = min(S, s0 + query_block)
        s = torch.einsum("qhd,khd->hqk", q[s0:s1], k[:s1]) * t.qk_dim ** -0.5
        causal = torch.arange(s1, device=h.device)[None, :] <= torch.arange(
            s0, s1, device=h.device)[:, None]
        s = s.masked_fill(~causal, float("-inf"))
        out[s0:s1] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), val[:s1])
    return mm(out.reshape(S, H * Dv), p["o_w"])


def swiglu(p: dict, h: torch.Tensor, mm=matmul) -> torch.Tensor:
    return mm(F.silu(mm(h, p["gate_w"])) * mm(h, p["up_w"]), p["down_w"])


def moe(p: dict, a: Arch, h: torch.Tensor, mm=matmul) -> torch.Tensor:
    """DeepseekV3TopkRouter (one group; ties to the lower index) and
    DeepseekV3MoE: each chosen expert over its tokens, plus the shared
    experts."""
    t = a.text
    scores = torch.sigmoid(h @ p["router"].float())
    order = torch.sort(scores + p["router_bias"].float(), dim=-1, descending=True,
                       stable=True).indices
    idx = order[:, :t.topk]
    w = scores.gather(1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * t.scaling
    out = torch.zeros_like(h)
    F_ = t.moe_inter
    for e in torch.unique(idx).tolist():
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        fc1 = p["moe_fc1"][e].float()
        y = mm(F.silu(mm(h[rows], fc1[:, :F_])) * mm(h[rows], fc1[:, F_:]),
               p["moe_fc2"][e].float())
        out.index_add_(0, rows, y * w[rows, slot, None])
    return out + swiglu(p, h, mm)


def dense_leaves(layer: dict) -> dict:
    return {k: (v if k.startswith("moe_") else v.float()) for k, v in layer.items()}


def logits(weights: dict, a: Arch, ids: Sequence[int], vision: Optional[torch.Tensor],
           at: slice, mm=matmul, query_block: int = QUERY_BLOCK) -> torch.Tensor:
    """Float32 logits (n, vocab) at the positions ``at`` of ``ids``
    (positions 0..S-1), whose vision placeholders take the rows of
    ``vision`` in order."""
    text = weights["text"]
    t = a.text
    dev = text["embed_tokens"].device
    ids_t = torch.as_tensor(np.asarray(ids), device=dev)
    x = text["embed_tokens"][ids_t].float()
    if vision is not None:
        pad = ids_t == a.image_token
        if int(pad.sum()) != vision.shape[0]:
            raise ValueError(f"{int(pad.sum())} placeholders for {vision.shape[0]} vision rows")
        x[pad] = vision.float()
    positions = torch.arange(len(ids), device=dev)
    for i, layer in enumerate(text["layers"]):
        p = dense_leaves(layer)
        x = x + attention(p, a, rms_norm(x, p["input_norm"], t.eps), positions, mm, query_block)
        h = rms_norm(x, p["post_norm"], t.eps)
        x = x + (swiglu(p, h, mm) if i < t.dense_layers else moe(p, a, h, mm))
    h = rms_norm(x[at], text["final_norm"].float(), t.eps)
    return mm(h, text["lm_head"].float())
