"""The plain float32 reference of the served models: the vision tower, the
M-RoPE positions and the decoder over a whole sequence, with no cache, no
batching and no kernel.

Written from the published architectures (Hugging Face's Qwen2.5-VL and
Qwen3-VL-MoE modelling code) in plain PyTorch; it imports nothing of the
program. The weights are the benchmark's own bf16 tensors (``lib.weights``,
in the program's input-major layout), each cast to float32 as it is used,
one block or layer at a time, so the whole model never exists in float32.
Matrix products run in full float32 (TF32 off, ``full_float32``).

Departures from the modelling code, none of which changes the function:
the Qwen2.5-VL tower attends within each window through a mask over its
frame instead of reordering the patches by window (attention does not
depend on the order of its keys, and the merger works per merge unit,
which the reorder keeps whole); attention over long sequences is computed
a block of queries at a time.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..lib.arch import Arch

QUERY_BLOCK = 1024  # queries a block of the decoder's attention
E4M3_MAX = 448.0


def matmul(x, w):
    """A product in full float32: the reference's."""
    return x @ w


def _fp8(x):
    """``x`` rounded to float8 e4m3 with one scale for the whole tensor (its
    largest magnitude maps to 448), back in float32."""
    scale = x.abs().max().clamp(min=1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_matmul(x, w):
    """The control's product: activations and weights rounded to float8
    e4m3 with a scale per tensor, as the card's fp8 GEMMs take their
    scales, accumulated in float32; the precision below the configuration's
    bf16 that a faster path would take."""
    return _fp8(x) @ _fp8(w)


@contextlib.contextmanager
def full_float32():
    """float32 products in full float32, whatever the caller had set."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def f32(layer: dict) -> dict:
    """A block's or layer's weights cast to float32."""
    return {k: v.float() for k, v in layer.items()}


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def layer_norm(x, w, b, eps=1e-6):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def attend(q, k, v, mask):
    """Softmax attention of q (H, Sq, D) over k, v (H, Sk, D) where
    ``mask`` (Sq, Sk) is true."""
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    s = s.masked_fill(~mask, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


# ---------------------------------------------------------------- the tower


def merge_block_coords(h: int, w: int, merge: int) -> tuple[np.ndarray, np.ndarray]:
    """Row and column of each patch of an (h, w) grid in merge-block order
    (the 2x2 blocks of the merger laid out one after the other)."""
    hh = np.arange(h)[:, None].repeat(w, 1).reshape(h // merge, merge, w // merge, merge)
    ww = np.arange(w)[None, :].repeat(h, 0).reshape(h // merge, merge, w // merge, merge)
    return (hh.transpose(0, 2, 1, 3).reshape(-1), ww.transpose(0, 2, 1, 3).reshape(-1))


def vision_rope(grid: Sequence[tuple], head_dim: int, merge: int, device):
    """cos, sin (S, head_dim) of the tower's 2-D rotary embedding: half the
    frequencies rotate by the patch row, half by its column."""
    dim = head_dim // 2
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim))
    rows = []
    for t, h, w in grid:
        hh, ww = merge_block_coords(h, w, merge)
        ang = torch.cat([torch.from_numpy(hh)[:, None] * inv, torch.from_numpy(ww)[:, None] * inv],
                        dim=1)
        rows.append(ang.repeat(t, 1))
    emb = torch.cat(rows).repeat(1, 2)
    return emb.cos().float().to(device), emb.sin().float().to(device)


def learned_positions(table: torch.Tensor, grid: Sequence[tuple], merge: int) -> torch.Tensor:
    """Qwen3-VL's position table (side x side) bilinearly interpolated to
    each grid, in merge-block order, repeated over the grid's frames."""
    side = int(round(table.shape[0] ** 0.5))
    tbl = table.float().reshape(side, side, -1)
    out = []
    for t, h, w in grid:
        hi = torch.linspace(0, side - 1, h, dtype=torch.float64)
        wi = torch.linspace(0, side - 1, w, dtype=torch.float64)
        h0, w0 = hi.long(), wi.long()
        h1, w1 = (h0 + 1).clamp(max=side - 1), (w0 + 1).clamp(max=side - 1)
        dh, dw = (hi - h0)[:, None, None].float(), (wi - w0)[None, :, None].float()
        dh, dw = dh.to(tbl.device), dw.to(tbl.device)
        pe = (tbl[h0][:, w0] * (1 - dh) * (1 - dw) + tbl[h0][:, w1] * (1 - dh) * dw
              + tbl[h1][:, w0] * dh * (1 - dw) + tbl[h1][:, w1] * dh * dw)
        hh, ww = merge_block_coords(h, w, merge)
        out.append(pe[torch.from_numpy(hh), torch.from_numpy(ww)].repeat(t, 1))
    return torch.cat(out)


def frame_masks(grid: Sequence[tuple], a: Arch) -> list:
    """Per frame of the grids: (its patch range, the window blocks' mask
    (None without windows))."""
    v = a.vision
    side = v.window_size // v.patch // v.merge if v.window_size else 0
    out, at = [], 0
    for t, h, w in grid:
        n = h * w
        win_mask = None
        if side:
            hh, ww = merge_block_coords(h, w, v.merge)
            win = torch.from_numpy((hh // v.merge // side) * 10_000 + (ww // v.merge // side))
            win_mask = win[:, None] == win[None, :]
        for _ in range(t):
            out.append((slice(at, at + n), win_mask))
            at += n
    return out


def vision_block(p: dict, x, cos, sin, frames, a: Arch, windowed: bool, mm=matmul):
    v = a.vision

    def norm(name, y):
        return layer_norm(y, p[name], p[name + "_b"]) if v.norm == "ln" else rms_norm(y, p[name],
                                                                                         1e-6)

    S = x.shape[0]
    qkv = (mm(norm("norm1", x), p["qkv_w"]) + p["qkv_b"]).reshape(S, 3, v.heads, v.head_dim)
    q, k, val = qkv.unbind(1)
    q = q * cos[:, None] + rotate_half(q) * sin[:, None]
    k = k * cos[:, None] + rotate_half(k) * sin[:, None]
    out = torch.empty_like(q)
    for rng, win_mask in frames:
        n = rng.stop - rng.start
        mask = win_mask.to(x.device) if windowed else torch.ones(n, n, dtype=torch.bool,
                                                                 device=x.device)
        o = attend(q[rng].transpose(0, 1), k[rng].transpose(0, 1), val[rng].transpose(0, 1), mask)
        out[rng] = o.transpose(0, 1)
    x = x + mm(out.reshape(S, -1), p["proj_w"]) + p["proj_b"]
    h = norm("norm2", x)
    if v.act == "swiglu":
        m = mm(F.silu(mm(h, p["gate_w"]) + p["gate_b"]) * (mm(h, p["up_w"]) + p["up_b"]),
               p["down_w"])
        return x + m + p["down_b"]
    m = F.gelu(mm(h, p["fc1_w"]) + p["fc1_b"], approximate="tanh")
    return x + mm(m, p["fc2_w"]) + p["fc2_b"]


def merger(m: dict, x, a: Arch, postshuffle: bool, mm=matmul):
    v = a.vision
    if postshuffle:
        h = layer_norm(x.reshape(-1, v.hidden * v.unit), m["ln_q"], m["ln_q_b"])
    elif v.norm == "ln":
        h = layer_norm(x, m["ln_q"], m["ln_q_b"]).reshape(-1, v.hidden * v.unit)
    else:
        h = rms_norm(x, m["ln_q"], 1e-6).reshape(-1, v.hidden * v.unit)
    return mm(F.gelu(mm(h, m["fc1_w"]) + m["fc1_b"]), m["fc2_w"]) + m["fc2_b"]


def vision_tower(visual: dict, a: Arch, patches: torch.Tensor, grid: Sequence[tuple],
                 mm=matmul):
    """patch rows (S, patch_dim) -> (merged embeddings (S / 4, out), the
    deepstack taps, each of that shape). ``mm`` computes every product of
    the blocks and mergers."""
    v = a.vision
    x = patches.float() @ visual["patch_embed"].float()
    if v.patch_bias:
        x = x + visual["patch_embed_b"].float()
    if v.pos_embeds:
        x = x + learned_positions(visual["pos_embed"], grid, v.merge)
    cos, sin = vision_rope(grid, v.head_dim, v.merge, x.device)
    frames = frame_masks(grid, a)
    taps = []
    for i, blk in enumerate(visual["blocks"]):
        windowed = bool(v.window_size) and i not in v.fullatt
        x = vision_block(f32(blk), x, cos, sin, frames, a, windowed, mm)
        if i in v.deepstack:
            taps.append(merger(f32(visual["deepstack"][v.deepstack.index(i)]), x, a, True, mm))
    return merger(f32(visual["merger"]), x, a, False, mm), taps


# --------------------------------------------------------------- positions


def mrope_positions(ids: Sequence[int], grids: Sequence[tuple], a: Arch) -> np.ndarray:
    """(3, S) M-RoPE positions: text runs on one position for all three
    axes; each run of vision pads takes the next grid (one frame: t = 1) and
    gets (frame, row, column) of its merged tokens after the text before
    it; the text after a block starts past its largest position."""
    ids = np.asarray(ids)
    pads = np.isin(ids, [a.image_token, a.video_token])
    out = np.zeros((3, len(ids)), dtype=np.int64)
    nxt, i, g = 0, 0, 0
    while i < len(ids):
        if not pads[i]:
            out[:, i] = nxt
            nxt += 1
            i += 1
            continue
        t, h, w = grids[g]
        g += 1
        lh, lw = h // a.vision.merge, w // a.vision.merge
        n = t * lh * lw
        if not pads[i:i + n].all():
            raise ValueError(f"vision block at {i}: fewer than {n} pads")
        tt = np.repeat(np.arange(t), lh * lw)
        hh = np.tile(np.repeat(np.arange(lh), lw), t)
        ww = np.tile(np.arange(lw), t * lh)
        out[:, i:i + n] = np.stack([tt, hh, ww]) + nxt
        nxt = int(out[:, i:i + n].max()) + 1
        i += n
    if g != len(grids):
        raise ValueError(f"{len(grids)} grids but {g} vision blocks")
    return out


def text_rope(pos: np.ndarray, a: Arch, device):
    """cos, sin (S, head_dim) of the decoder's M-RoPE at positions (3, S)."""
    t = a.text
    inv = 1.0 / (t.theta ** (torch.arange(0, t.head_dim, 2, dtype=torch.float64) / t.head_dim))
    ang = torch.from_numpy(pos).double()[..., None] * inv  # (3, S, D/2)
    f = torch.arange(t.head_dim // 2)
    if t.interleaved:
        sec = t.mrope_section
        axis = torch.zeros_like(f)
        axis[(f % 3 == 1) & (f < 3 * sec[1])] = 1
        axis[(f % 3 == 2) & (f < 3 * sec[2])] = 2
        half = ang[axis, :, f].T
        emb = torch.cat([half, half], dim=-1)
    else:
        full = torch.cat([ang, ang], dim=-1)  # (3, S, D)
        sections = list(t.mrope_section) * 2
        axis = torch.cat([torch.full((s,), i % 3) for i, s in enumerate(sections)])
        emb = full[axis, :, torch.arange(t.head_dim)].T
    return emb.cos().float().to(device), emb.sin().float().to(device)


# ----------------------------------------------------------------- decoder


def moe(p: dict, h: torch.Tensor, a: Arch, mm=matmul) -> torch.Tensor:
    """Routed experts: a softmax over every expert, the top k renormalised,
    each expert a SwiGLU (the first half of fc1 gated by silu)."""
    t = a.text
    probs = torch.softmax(mm(h, p["router"]), dim=-1)
    w, idx = torch.topk(probs, t.topk, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in torch.unique(idx).tolist():
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        x = h[rows]
        fc1 = p["moe_fc1"][e].float()
        y = F.silu(mm(x, fc1[:, :t.moe_inter])) * mm(x, fc1[:, t.moe_inter:])
        out.index_add_(0, rows, mm(y, p["moe_fc2"][e].float()) * w[rows, slot, None])
    return out


def decoder_layer(p: dict, x, cos, sin, a: Arch, mm=matmul):
    t = a.text
    S = x.shape[0]
    h = rms_norm(x, p["input_norm"], t.eps)
    q, k, v = mm(h, p["q_w"]), mm(h, p["k_w"]), mm(h, p["v_w"])
    if t.attn_bias:
        q, k, v = q + p["q_b"], k + p["k_b"], v + p["v_b"]
    q = q.reshape(S, t.heads, t.head_dim)
    k = k.reshape(S, t.kv_heads, t.head_dim)
    v = v.reshape(S, t.kv_heads, t.head_dim)
    if t.qk_norm:
        q, k = rms_norm(q, p["q_norm"], t.eps), rms_norm(k, p["k_norm"], t.eps)
    q = q * cos[:, None] + rotate_half(q) * sin[:, None]
    k = k * cos[:, None] + rotate_half(k) * sin[:, None]
    group = t.heads // t.kv_heads
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    q = q.transpose(0, 1)
    out = torch.empty_like(q)
    cols = torch.arange(S, device=x.device)
    for s0 in range(0, S, QUERY_BLOCK):
        rows = cols[s0:s0 + QUERY_BLOCK]
        mask = cols[None, :rows[-1] + 1] <= rows[:, None]
        out[:, s0:s0 + len(rows)] = attend(q[:, s0:s0 + len(rows)], k[:, :rows[-1] + 1],
                                           v[:, :rows[-1] + 1], mask)
    x = x + mm(out.transpose(0, 1).reshape(S, -1), p["o_w"])
    h = rms_norm(x, p["post_norm"], t.eps)
    if t.experts:
        return x + moe(p, h, a, mm)
    return x + mm(F.silu(mm(h, p["gate_w"])) * mm(h, p["up_w"]), p["down_w"])


def dense_leaves(layer: dict) -> dict:
    """A decoder layer's weights in float32, the expert stacks left as they
    are (``moe`` casts one expert at a time)."""
    return {k: (v if k.startswith("moe_") else v.float()) for k, v in layer.items()}


def logits(weights: dict, a: Arch, ids: Sequence[int], grids: Sequence[tuple],
           vision: Optional[tuple], at: slice, mm=matmul) -> torch.Tensor:
    """Float32 logits (n, vocab) at the positions ``at`` of the sequence
    ``ids``, whose vision pads take the rows of ``vision`` (the tower's
    (embeddings, taps) for ``grids``) in order. ``mm`` computes every
    product of the layers and the lm_head."""
    text = weights["text"]
    dev = text["embed_tokens"].device
    ids_t = torch.as_tensor(np.asarray(ids), device=dev)
    x = text["embed_tokens"][ids_t].float()
    pad = torch.isin(ids_t, torch.tensor([a.image_token, a.video_token], device=dev))
    taps = []
    if vision is not None:
        emb, taps = vision
        if int(pad.sum()) != emb.shape[0]:
            raise ValueError(f"{int(pad.sum())} vision pads for {emb.shape[0]} vision rows")
        x[pad] = emb
    cos, sin = text_rope(mrope_positions(ids, grids, a), a, dev)
    for i, layer in enumerate(text["layers"]):
        x = decoder_layer(dense_leaves(layer), x, cos, sin, a, mm)
        if i < len(taps):
            x[pad] = x[pad] + taps[i]
    h = rms_norm(x[at], text["final_norm"].float(), a.text.eps)
    return mm(h, text["lm_head"].float())
