"""The plain float32 reference of Kimi-VL (Kimi-VL-A3B-Instruct): MoonViT,
the projector and the DeepSeek-V3 decoder over a whole sequence, with no
cache, no batching and no kernel. Plain PyTorch; it imports nothing of JAX,
of the JAX package or of the port, and switches TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False).

Written from transformers' ``modeling_deepseek_v3.py`` (DeepseekV3Attention
with ``rope_interleave``, DeepseekV3TopkRouter, DeepseekV3MoE,
DeepseekV3MLP) and from Kimi-VL's ``modeling_kimi_vl.py`` as the model card
and the Kimi-VL technical report (arXiv:2504.07491, section 2.1) describe
MoonViT. Weights are the port's parameter tree (input-major matrices),
each cast to float32 where it is used.

Departures from the published code, none of which changes the function:
attention is computed in the expanded form (each head's keys and values
from ``kv_b``) over the whole sequence; every routed expert runs on every
token and a dense (N, E) combine sums the chosen ones (the unchosen weights
are 0); patches arrive in 2 x 2 merge-block order (the port's patch
layout), so the position table and the rope are gathered in that order and
the projector's merge is a reshape; the position table is resized in
float32 (the published code resizes it in the weights' dtype).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _f(x):
    return x.float()


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * _f(w)


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), _f(w), _f(b), eps)


def coords(h: int, w: int, merge: int):
    """Row and column of each patch in merge-block order."""
    rows = np.arange(h)[:, None].repeat(w, 1).reshape(h // merge, merge, w // merge, merge)
    cols = np.arange(w)[None, :].repeat(h, 0).reshape(h // merge, merge, w // merge, merge)
    return rows.transpose(0, 2, 1, 3).reshape(-1), cols.transpose(0, 2, 1, 3).reshape(-1)


def tower(visual: dict, vcfg, patches: torch.Tensor, grids: Sequence[tuple]) -> torch.Tensor:
    """MoonViT and the projector: patch rows (S, 3 * p * p) in merge-block
    order -> (S / 4, text hidden) float32."""
    D, heads = vcfg.hidden_size, vcfg.num_heads
    hd, m, eps = D // heads, vcfg.spatial_merge_size, vcfg.layer_norm_eps
    x = patches.float() @ _f(visual["patch_embed"]) + _f(visual["patch_embed_b"])
    pos, angles, frames = [], [], []
    table = _f(visual["pos_embed"])
    freqs = 1.0 / (vcfg.rope_theta ** (np.arange(0, hd, 4)[: hd // 4] / hd))
    at = 0
    for t, h, w in grids:
        if (h, w) == tuple(table.shape[:2]):
            pe = table
        else:
            pe = F.interpolate(table.permute(2, 0, 1)[None], size=(h, w), mode="bicubic",
                               align_corners=False)[0].permute(1, 2, 0)
        r, c = coords(h, w, m)
        pos.append(pe.reshape(h * w, D)[torch.from_numpy(r * w + c)].repeat(t, 1))
        ang = np.stack([c[:, None] * freqs, r[:, None] * freqs], -1).reshape(h * w, -1)
        angles.append(np.tile(ang, (t, 1)))
        for _ in range(t):
            frames.append(slice(at, at + h * w))
            at += h * w
    x = x + torch.cat(pos).to(x.device)
    ang = torch.from_numpy(np.concatenate(angles)).to(x.device)
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]

    def rope(y):  # consecutive pairs as complex numbers, turned by their angle
        y = y.reshape(*y.shape[:-1], -1, 2)
        a, b = y[..., 0], y[..., 1]
        return torch.stack([a * cos - b * sin, a * sin + b * cos], -1).flatten(-2)

    S = x.shape[0]
    for p in visual["blocks"]:
        h = layer_norm(x, p["norm1"], p["norm1_b"], eps)
        qkv = (h @ _f(p["qkv_w"]) + _f(p["qkv_b"])).reshape(S, 3, heads, hd)
        q, k, v = rope(qkv[:, 0]), rope(qkv[:, 1]), qkv[:, 2]
        out = torch.empty_like(q)
        for fr in frames:
            s = torch.einsum("qhd,khd->hqk", q[fr], k[fr]) * hd ** -0.5
            out[fr] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v[fr])
        x = x + out.reshape(S, D) @ _f(p["proj_w"]) + _f(p["proj_b"])
        h = layer_norm(x, p["norm2"], p["norm2_b"], eps)
        a = F.gelu(h @ _f(p["fc1_w"]) + _f(p["fc1_b"]), approximate="tanh")
        x = x + a @ _f(p["fc2_w"]) + _f(p["fc2_b"])
    x = layer_norm(x, visual["final_norm"], visual["final_norm_b"], eps)
    mg = visual["merger"]
    h = layer_norm(x, mg["ln_q"], mg["ln_q_b"], eps).reshape(-1, D * m * m)
    return F.gelu(h @ _f(mg["fc1_w"]) + _f(mg["fc1_b"])) @ _f(mg["fc2_w"]) + _f(mg["fc2_b"])


def route(p: dict, tcfg, h: torch.Tensor):
    """DeepseekV3TopkRouter with one group: (indices (N, k), weights
    (N, k)). Ties go to the lower expert index."""
    scores = torch.sigmoid(h @ _f(p["router"]))
    choice = scores + _f(p["router_bias"])
    order = torch.sort(choice, dim=-1, descending=True, stable=True).indices
    idx = order[:, :tcfg.moe_topk]
    w = scores.gather(1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * tcfg.routed_scaling_factor


def swiglu(h, gate, up, down):
    return (F.silu(h @ _f(gate)) * (h @ _f(up))) @ _f(down)


def moe(p: dict, tcfg, h: torch.Tensor) -> torch.Tensor:
    """Every routed expert on every token, a dense combine, plus the shared
    experts."""
    idx, w = route(p, tcfg, h)
    combine = torch.zeros(h.shape[0], tcfg.moe_num_experts, device=h.device).scatter_(1, idx, w)
    F_ = tcfg.moe_intermediate_size
    out = torch.zeros_like(h)
    for e in range(tcfg.moe_num_experts):
        fc1 = _f(p["moe_fc1"][e])
        y = (F.silu(h @ fc1[:, :F_]) * (h @ fc1[:, F_:])) @ _f(p["moe_fc2"][e])
        out = out + combine[:, e:e + 1] * y
    return out + swiglu(h, p["gate_w"], p["up_w"], p["down_w"])


def rope_1d(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """DeepSeek-V3's rope with ``rope_interleave``: x (S, ..., d) at 1-D
    positions (S,), its interleaved pairs moved to the halves first."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d))
    ang = positions.float().cpu()[:, None] * inv
    emb = torch.cat([ang, ang], -1).to(x.device)
    cos, sin = emb.cos(), emb.sin()
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (d,)
    cos, sin = cos.reshape(shape), sin.reshape(shape)
    x = torch.cat([x[..., 0::2], x[..., 1::2]], -1)
    x1, x2 = x.chunk(2, -1)
    return x * cos + torch.cat([-x2, x1], -1) * sin


def attention(p: dict, tcfg, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """DeepseekV3Attention (no q compression), causal over the sequence."""
    S = h.shape[0]
    H, N, R = tcfg.num_attention_heads, tcfg.qk_nope_head_dim, tcfg.kv_lora_rank
    Dv = tcfg.v_head_dim
    q = (h @ _f(p["q_w"])).reshape(S, H, N + tcfg.qk_rope_head_dim)
    q_nope, q_pe = q[..., :N], rope_1d(q[..., N:], positions, tcfg.rope_theta)
    ckv = h @ _f(p["kv_a_w"])
    c = rms_norm(ckv[:, :R], p["kv_norm"], tcfg.kv_norm_eps)
    k_pe = rope_1d(ckv[:, R:], positions, tcfg.rope_theta)
    kv = (c @ _f(p["kv_b_w"])).reshape(S, H, N + Dv)
    k = torch.cat([kv[..., :N], k_pe[:, None].expand(S, H, -1)], -1)
    qq = torch.cat([q_nope, q_pe], -1)
    s = torch.einsum("qhd,khd->hqk", qq, k) * (N + tcfg.qk_rope_head_dim) ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    out = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), kv[..., N:])
    return out.reshape(S, H * Dv) @ _f(p["o_w"])


def logits(params: dict, cfg, ids: Sequence[int], vision_rows=None) -> torch.Tensor:
    """Float32 logits (S, vocab) of the sequence ``ids``, whose vision
    placeholders take ``vision_rows`` (the tower's output) in order;
    positions 0..S-1."""
    t = params["text"]
    tcfg = cfg.text
    dev = t["embed_tokens"].device
    ids_t = torch.as_tensor(list(ids), device=dev)
    x = _f(t["embed_tokens"][ids_t])
    if vision_rows is not None:
        x[ids_t == cfg.image_token_id] = vision_rows.float()
    positions = torch.arange(len(ids), device=dev)
    for i, p in enumerate(t["layers"]):
        x = x + attention(p, tcfg, rms_norm(x, p["input_norm"], tcfg.rms_norm_eps), positions)
        h = rms_norm(x, p["post_norm"], tcfg.rms_norm_eps)
        if i < tcfg.first_k_dense_replace:
            x = x + swiglu(h, p["gate_w"], p["up_w"], p["down_w"])
        else:
            x = x + moe(p, tcfg, h)
    return rms_norm(x, t["final_norm"], tcfg.rms_norm_eps) @ _f(t["lm_head"])
