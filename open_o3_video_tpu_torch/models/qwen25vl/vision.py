"""Qwen-VL vision towers (counterpart of
``open_o3_video_tpu/models/qwen25vl/vision.py``).

Host half: ``compute_vision_spec`` plans, per grid, the tower's layout. For
Qwen2.5-VL: the window permutation and the padded, packed layout: every
8x8-patch window padded to one row width ``win_w`` (several small edge
windows packed into one row, told apart by segment ids), so each layer's
segmentation is a reshape. It is a numpy copy of the JAX planner (which
cannot be imported without JAX), with the pack factor fixed at its default
of 2 and the same fallback to one window per row on ragged grids. For the
towers without windows (Qwen2-VL, Qwen3-VL): the sequence keeps its order
and every block attends within whole frames, contiguous equal runs where
every frame has the same size (``frame_w``), a gather/scatter
``SegmentSpec`` where they differ; for Qwen3-VL also the bilinear plan of
its learned position embedding onto each grid.

Device half: ``vision_forward`` runs the tower on CPU and CUDA alike.
Qwen2.5-VL: the 28 windowed blocks through K1 (fused rope + window
attention), the 4 global blocks through K2 over whole frames (rope applied
before it). Qwen2-VL (LayerNorm, QuickGELU MLP) and Qwen3-VL (LayerNorm,
gelu-tanh MLP, biased patch embed, learned position embedding, deepstack
taps merged after blocks 8, 16 and 24) run every block through K2 over
whole frames and build no window rows. A block's linear layers go through
``ops.quant.dense``, as JAX's do: a plain weight is ``x @ w`` in the param
dtype; a quantized one (``init(quantize_vision=...)``) is its int8 or int4
product, w8a8 inside the engine's ``a8_acts`` scope. The patch embed and
the mergers are plain matmuls.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...ops.attention import segment_attention
from ...ops.quant import dense
from ...ops.rms_norm import rms_norm
from ...ops.sharded import local
from ...ops.rope import apply_rope_vision, vision_pos_freqs
from ...ops.window_attention import fused_window_attention
from .config import VisionConfig

PACK = 2  # full windows per padded row when packing adds no pad rows


@dataclasses.dataclass(frozen=True)
class FusedSeg:
    """Per-layer plan for the fused rope + window kernel: rows of ``w``
    tokens, rotary tables (N, w, head_dim) float32, ids (N, w) int32."""

    w: int
    cos: torch.Tensor
    sin: torch.Tensor
    valid: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    """Static gather/scatter plan for batched segment attention."""

    indices: np.ndarray  # (N, W) int32: sequence position of each slot
    valid: np.ndarray  # (N, W) bool
    seg_ids: np.ndarray  # (S,) int32: segment of each sequence position
    offsets: np.ndarray  # (S,) int32: slot of each sequence position


def _make_segment_spec(seg_sizes: np.ndarray, valid_mask: "np.ndarray | None" = None) -> SegmentSpec:
    """Contiguous segments (sizes summing to S) -> batched layout.
    ``valid_mask`` (length S) marks pad positions inside the segments."""
    n = len(seg_sizes)
    w = int(seg_sizes.max())
    s = int(seg_sizes.sum())
    indices = np.zeros((n, w), dtype=np.int32)
    valid = np.zeros((n, w), dtype=bool)
    seg_ids = np.zeros(s, dtype=np.int32)
    offsets = np.zeros(s, dtype=np.int32)
    pos = 0
    for i, size in enumerate(seg_sizes):
        size = int(size)
        indices[i, :size] = np.arange(pos, pos + size)
        valid[i, :size] = True if valid_mask is None else valid_mask[pos:pos + size]
        seg_ids[pos:pos + size] = i
        offsets[pos:pos + size] = np.arange(size)
        pos += size
    return SegmentSpec(indices=indices, valid=valid, seg_ids=seg_ids, offsets=offsets)


@dataclasses.dataclass(frozen=True)
class VisionSpec:
    """Everything shape-dependent, computed once per grid_thw on the host.
    The padded fields are those of the windowed tower (Qwen2.5-VL)."""

    window_index: np.ndarray  # (S_merged,) permutation of merge blocks
    reverse_index: np.ndarray  # (S_merged,) inverse permutation
    window_seg: SegmentSpec  # windowed-layer segments (reordered sequence)
    full_seg: SegmentSpec  # global-layer segments (reordered sequence)
    freqs: np.ndarray  # (S, head_dim // 2) rotary angles, reordered
    seq_len: int
    padded_index: "np.ndarray | None" = None  # (S_pad,) int32 source row of each padded row
    padded_valid: "np.ndarray | None" = None  # (S_pad,) bool
    padded_gids: "np.ndarray | None" = None  # (S_pad,) int32 segment id in its row (0 = pad)
    padded_freqs: "np.ndarray | None" = None  # (S_pad, head_dim // 2)
    win_w: int = 0  # padded window row length (unmerged tokens)
    merged_out_index: "np.ndarray | None" = None  # (S_merged,) exit gather
    frame_w: int = 0  # padded per-frame length (0: frames differ)
    full_seg_pad: "SegmentSpec | None" = None  # global layers when frame_w == 0
    # Qwen3-VL's learned position embedding: the 4 table rows and bilinear
    # weights of each patch, in merge-block order.
    pos_idx: "np.ndarray | None" = None  # (4, S) int32
    pos_w: "np.ndarray | None" = None  # (4, S) float32


def _pos_interp_plan(grid_thw, side: int, merge: int):
    """(4, S) table rows + bilinear weights of the (side x side) learned
    table at each patch of each grid, in merge-block patch order (HF
    ``fast_pos_embed_interpolate``)."""
    idx_all, w_all = [], []
    for t, h, w in grid_thw:
        t, h, w = int(t), int(h), int(w)
        h_idxs = np.linspace(0, side - 1, h)
        w_idxs = np.linspace(0, side - 1, w)
        hf = h_idxs.astype(np.int64)
        wf = w_idxs.astype(np.int64)
        hc = np.clip(hf + 1, None, side - 1)
        wc = np.clip(wf + 1, None, side - 1)
        dh = h_idxs - hf
        dw = w_idxs - wf
        idx = np.stack([hf[:, None] * side + wf[None, :], hf[:, None] * side + wc[None, :],
                        hc[:, None] * side + wf[None, :], hc[:, None] * side + wc[None, :]])
        wgt = np.stack([(1 - dh)[:, None] * (1 - dw)[None, :], (1 - dh)[:, None] * dw[None, :],
                        dh[:, None] * (1 - dw)[None, :], dh[:, None] * dw[None, :]])

        def to_patch_order(a):  # row-major (h, w) -> merge blocks, repeated per frame
            a = a.reshape(4, h // merge, merge, w // merge, merge)
            return np.tile(a.transpose(0, 1, 3, 2, 4).reshape(4, h * w), (1, t))

        idx_all.append(to_patch_order(idx))
        w_all.append(to_patch_order(wgt))
    return (np.concatenate(idx_all, axis=1).astype(np.int32),
            np.concatenate(w_all, axis=1).astype(np.float32))


def _whole_frame_spec(grid_thw, cfg: VisionConfig) -> VisionSpec:
    """The plan of a tower without windows (Qwen2-VL, Qwen3-VL): the
    sequence in its own order, every block over whole frames (HF's
    cu_seqlens = repeat_interleave(h * w, t))."""
    seq_len = int(sum(t * h * w for t, h, w in grid_thw))
    sizes = [int(h) * int(w) for t, h, w in grid_thw for _ in range(int(t))]
    ident = np.arange(seq_len // cfg.merge_unit, dtype=np.int32)
    full_seg = _make_segment_spec(np.asarray(sizes, dtype=np.int64))
    pos = {}
    if cfg.num_position_embeddings:
        side = int(cfg.num_position_embeddings ** 0.5)
        pos_idx, pos_w = _pos_interp_plan(grid_thw, side, cfg.spatial_merge_size)
        pos = dict(pos_idx=pos_idx, pos_w=pos_w)
    return VisionSpec(
        window_index=ident, reverse_index=ident, window_seg=full_seg, full_seg=full_seg,
        freqs=vision_pos_freqs(grid_thw, cfg.spatial_merge_size, cfg.head_dim).astype(np.float32),
        seq_len=seq_len, frame_w=sizes[0] if len(set(sizes)) == 1 else 0, **pos)


def compute_vision_spec(grid_thw: Sequence[tuple[int, int, int]], cfg: VisionConfig) -> VisionSpec:
    """Host-side plan: window permutation + padded layout + rotary angles,
    or, for a tower without windows, whole frames."""
    if not cfg.use_windows:
        return _whole_frame_spec(grid_thw, cfg)
    merge = cfg.spatial_merge_size
    unit = cfg.merge_unit
    win = cfg.window_patches // merge  # window side in merged positions

    window_index = []
    window_sizes = []  # per-window size in unmerged patches
    full_sizes = []  # per (grid, t) segment size in unmerged patches
    frame_win_counts = []  # per (grid, t) count of nonzero windows
    offset = 0
    for t, h, w in grid_thw:
        lh, lw = h // merge, w // merge
        index = np.arange(t * lh * lw).reshape(t, lh, lw)
        # Padding by win - (l % win) adds an empty window row/col when l
        # divides win; empty windows are dropped below.
        pad_h = win - lh % win
        pad_w = win - lw % win
        nwh = (lh + pad_h) // win
        nww = (lw + pad_w) // win
        padded = np.full((t, lh + pad_h, lw + pad_w), -100, dtype=np.int64)
        padded[:, :lh, :lw] = index
        padded = padded.reshape(t, nwh, win, nww, win).transpose(0, 1, 3, 2, 4)
        padded = padded.reshape(t, nwh * nww, win, win)
        seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)
        flat = padded.reshape(-1)
        window_index.append(flat[flat != -100] + offset)
        window_sizes.extend(int(s) * unit for s in seqlens if s > 0)
        full_sizes.extend([h * w] * t)
        frame_win_counts.extend(int(c) for c in (seqlens.reshape(t, -1) > 0).sum(axis=1))
        offset += t * lh * lw
    window_index = np.concatenate(window_index).astype(np.int32)
    reverse_index = np.argsort(window_index).astype(np.int32)

    seq_len = int(sum(t * h * w for t, h, w in grid_thw))
    window_seg = _make_segment_spec(np.asarray(window_sizes, dtype=np.int64))
    full_seg = _make_segment_spec(np.asarray(full_sizes, dtype=np.int64))

    freqs = vision_pos_freqs(grid_thw, merge, cfg.head_dim)
    freqs = freqs.reshape(seq_len // unit, unit, -1)[window_index].reshape(seq_len, -1)
    freqs = freqs.astype(np.float32)

    sizes_m = [s // unit for s in window_sizes]
    starts_m = np.zeros(len(sizes_m), dtype=np.int64)
    np.cumsum(sizes_m[:-1], out=starts_m[1:])

    def _pack_bins(cap_m: int):
        """First-fit decreasing per frame, so each frame is a run of rows."""
        bins: list[list[int]] = []
        bin_frame_counts = []
        wpos = 0
        for count in frame_win_counts:
            frame_wins = range(wpos, wpos + count)
            wpos += count
            frame_bins: list[list] = []  # [remaining capacity, [window idx]]
            for i in sorted(frame_wins, key=lambda i: (-sizes_m[i], i)):
                for b in frame_bins:
                    if b[0] >= sizes_m[i]:
                        b[0] -= sizes_m[i]
                        b[1].append(i)
                        break
                else:
                    frame_bins.append([cap_m - sizes_m[i], [i]])
            for b in frame_bins:
                b[1].sort()
            frame_bins.sort(key=lambda b: b[1][0])
            bins.extend(b[1] for b in frame_bins)
            bin_frame_counts.append(len(frame_bins))
        return bins, bin_frame_counts

    # Rows of PACK full windows unless that adds pad rows (ragged grids):
    # pad rows ride through every linear layer of the tower.
    win_w_m = win * win * PACK
    bins, bin_frame_counts = _pack_bins(win_w_m)
    bins1, counts1 = _pack_bins(win * win)
    if len(bins) * win_w_m > len(bins1) * win * win:
        win_w_m = win * win
        bins, bin_frame_counts = bins1, counts1

    n_bins = len(bins)
    pad_blocks = np.full(n_bins * win_w_m, -1, dtype=np.int64)
    gid_blocks = np.zeros(n_bins * win_w_m, dtype=np.int32)
    for bi, wins in enumerate(bins):
        off = bi * win_w_m
        for gi, wi in enumerate(wins):
            s = sizes_m[wi]
            pad_blocks[off:off + s] = np.arange(starts_m[wi], starts_m[wi] + s)
            gid_blocks[off:off + s] = gi + 1
            off += s
    s_pad = n_bins * win_w_m * unit
    j = np.arange(s_pad)
    blk = pad_blocks[j // unit]
    valid = blk >= 0
    gids = gid_blocks[j // unit]
    src_blk = np.where(valid, blk, 0)
    padded_index = (window_index[src_blk].astype(np.int64) * unit + j % unit).astype(np.int32)
    padded_freqs = np.where(
        valid[:, None], freqs[src_blk * unit + j % unit], 0.0
    ).astype(np.float32)
    merged_out_index = np.empty(seq_len // unit, dtype=np.int32)
    jm = np.arange(n_bins * win_w_m)
    real = pad_blocks >= 0
    merged_out_index[window_index[pad_blocks[real]]] = jm[real]
    uniform = len({(int(h), int(w), int(t)) for t, h, w in grid_thw}) == 1
    extra = {}
    if uniform:
        extra["frame_w"] = bin_frame_counts[0] * win_w_m * unit
    else:
        frame_pad_sizes = np.asarray(bin_frame_counts, dtype=np.int64) * win_w_m * unit
        extra["full_seg_pad"] = _make_segment_spec(frame_pad_sizes, valid_mask=valid)
    return VisionSpec(
        window_index=window_index,
        reverse_index=reverse_index,
        window_seg=window_seg,
        full_seg=full_seg,
        freqs=freqs,
        seq_len=seq_len,
        padded_index=padded_index,
        padded_valid=valid,
        padded_gids=gids,
        padded_freqs=padded_freqs,
        win_w=win_w_m * unit,
        merged_out_index=merged_out_index,
        **extra,
    )


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with bias in float32, cast back (Qwen2-VL's and Qwen3-VL's
    vision norm, eps 1e-6)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt((xf - mean).pow(2).mean(-1, keepdim=True) + eps)
    return (xf * weight.float() + bias.float()).to(x.dtype)


def _norm(p: dict, name: str, x: torch.Tensor, cfg: VisionConfig, impl: str) -> torch.Tensor:
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p[name], p[name + "_b"])
    return rms_norm(x, p[name], impl=impl)


def _segmented_attention(q, k, v, spec, impl):
    """(S, H, D) q/k/v -> segment-batched attention -> (S, H, D). ``spec``:
    ``(w, valid)`` when segments are contiguous w-token runs (a reshape),
    else a SegmentSpec gather/scatter plan."""
    S, H, D = q.shape
    if not isinstance(spec, SegmentSpec):
        w, valid = spec
        qs, ks, vs = (x.reshape(S // w, w, H, D) for x in (q, k, v))
        return segment_attention(qs, ks, vs, valid, impl=impl).reshape(S, H, D)
    dev = q.device
    indices = torch.from_numpy(spec.indices).to(dev).long()
    valid = torch.from_numpy(spec.valid).to(dev)
    out = segment_attention(q[indices], k[indices], v[indices], valid, impl=impl)
    seg = torch.from_numpy(spec.seg_ids).to(dev).long()
    off = torch.from_numpy(spec.offsets).to(dev).long()
    return out[seg, off]


def _block(p: dict, x: torch.Tensor, freqs: torch.Tensor,
           seg: Union[FusedSeg, tuple, SegmentSpec], cfg: VisionConfig, impl: str):
    S = x.shape[0]
    h = _norm(p, "norm1", x, cfg, impl)
    qkv = dense(h, p["qkv_w"], impl) + p["qkv_b"]
    heads = qkv.shape[-1] // (3 * cfg.head_dim)  # on a mesh, this rank's heads
    if isinstance(seg, FusedSeg):
        attn = fused_window_attention(
            qkv.reshape(S // seg.w, seg.w, -1), seg.cos, seg.sin, seg.valid,
            heads, impl=impl,
        ).reshape(S, -1)
    else:
        qkv = qkv.reshape(S, 3, heads, cfg.head_dim)
        q, k = apply_rope_vision(qkv[:, 0], qkv[:, 1], freqs)
        v = qkv[:, 2].contiguous()
        attn = _segmented_attention(q, k, v, seg, impl).reshape(S, -1)
    x = x + (dense(attn, p["proj_w"], impl) + p["proj_b"])
    h = _norm(p, "norm2", x, cfg, impl)
    if cfg.act_type == "swiglu":
        gate = F.silu(dense(h, p["gate_w"], impl) + p["gate_b"])
        up = dense(h, p["up_w"], impl) + p["up_b"]
        return x + (dense(gate * up, p["down_w"], impl) + p["down_b"])
    a = dense(h, p["fc1_w"], impl) + p["fc1_b"]
    if cfg.act_type == "quickgelu":  # Qwen2-VL's VisionMlp
        a = a * torch.sigmoid(1.702 * a)
    else:  # Qwen3-VL's VisionMLP: gelu_pytorch_tanh
        a = F.gelu(a, approximate="tanh")
    return x + (dense(a, p["fc2_w"], impl) + p["fc2_b"])


def _merger(m: dict, x: torch.Tensor, cfg: VisionConfig, impl: str,
            postshuffle: bool = False) -> torch.Tensor:
    """Patch merger: norm -> merge-unit concat -> fc1 -> GELU -> fc2. The
    deepstack mergers (``postshuffle``) norm after the concat, over
    merge_unit * hidden."""
    S = x.shape[0]
    merged = (S // cfg.merge_unit, cfg.merge_unit * cfg.hidden_size)
    if postshuffle:
        h = layer_norm(x.reshape(merged), m["ln_q"], m["ln_q_b"])
    else:
        h = _norm(m, "ln_q", x, cfg, impl).reshape(merged)
    h = F.gelu(dense(h, m["fc1_w"]) + m["fc1_b"])
    return dense(h, m["fc2_w"]) + m["fc2_b"]


def vision_forward(params: dict, patches: torch.Tensor, spec: VisionSpec,
                   cfg: VisionConfig, impl: str = "auto", remat: bool = False):
    """patches (S, patch_dim) -> merged embeddings (S / merge_unit, out_dim),
    in the original (pre-permutation) merged order; for Qwen3-VL (deepstack
    indexes configured) (embeddings, [one (S / merge_unit, out_dim) table
    per tapped block]), the taps that the decoder adds after its first
    layers. ``remat=True`` recomputes each block in the backward pass
    (non-reentrant checkpoint), as HF's gradient checkpointing does for the
    vision blocks. Without it the 32 blocks would save ~0.5 GB each at 16
    frames (reckoned from the shapes), more than is left beside a full
    fine-tune's weights, grads and AdamW state on one 80 GB card."""
    dev = patches.device
    x = dense(patches.to(params["patch_embed"].dtype), params["patch_embed"])  # (S, hidden)
    if cfg.patch_embed_bias:
        x = x + params["patch_embed_b"]
    if spec.pos_idx is not None:  # Qwen3-VL: the learned table, bilinearly interpolated
        pe = local(params["pos_embed"]).float()
        wgt = torch.from_numpy(spec.pos_w).to(dev)
        x = x + torch.einsum("cs,csd->sd", wgt, pe[torch.from_numpy(spec.pos_idx).to(dev).long()]
                             ).to(x.dtype)
    win_seg = None
    if cfg.use_windows:
        # One gather applies the window permutation and pads every window
        # row; pad rows are zeroed, masked as keys, and never gathered back.
        index = torch.from_numpy(spec.padded_index).to(dev).long()
        valid_np = spec.padded_valid
        x = torch.where(torch.from_numpy(valid_np).to(dev)[:, None], x[index], 0)
        freqs = torch.from_numpy(spec.padded_freqs).to(dev)
        emb = np.concatenate([spec.padded_freqs, spec.padded_freqs], -1)
        d = emb.shape[-1]
        w = spec.win_w
        win_seg = FusedSeg(
            w=w,
            cos=torch.from_numpy(np.cos(emb).astype(np.float32).reshape(-1, w, d)).to(dev),
            sin=torch.from_numpy(np.sin(emb).astype(np.float32).reshape(-1, w, d)).to(dev),
            valid=torch.from_numpy(spec.padded_gids.reshape(-1, w)).to(dev),
        )
        out_index = torch.from_numpy(spec.merged_out_index).to(dev).long()
    else:  # no windows: the sequence keeps its order, no exit gather
        freqs = torch.from_numpy(spec.freqs).to(dev)
        valid_np = np.ones(spec.seq_len, dtype=bool)
        out_index = None
    if spec.frame_w > 0:  # whole frames are contiguous equal runs
        frame_ids = valid_np.reshape(-1, spec.frame_w).astype(np.int32)
        full_seg = (spec.frame_w, torch.from_numpy(frame_ids).to(dev))
    else:
        full_seg = spec.full_seg_pad if cfg.use_windows else spec.full_seg
    taps = []
    for i in range(cfg.depth):
        seg = full_seg if win_seg is None or i in cfg.fullatt_block_indexes else win_seg
        if remat:
            x = checkpoint(_block, params["blocks"][i], x, freqs, seg, cfg, impl,
                           use_reentrant=False)
        else:
            x = _block(params["blocks"][i], x, freqs, seg, cfg, impl)
        if i in cfg.deepstack_visual_indexes:
            j = cfg.deepstack_visual_indexes.index(i)
            taps.append(_merger(params["deepstack"][j], x, cfg, impl, postshuffle=True))
    h = _merger(params["merger"], x, cfg, impl)
    if out_index is not None:
        h, taps = h[out_index], [tap[out_index] for tap in taps]
    if cfg.deepstack_visual_indexes:
        return h, taps
    return h
