"""Qwen-VL text decoder: GQA + M-RoPE, prefill and cached decode
(counterpart of ``open_o3_video_tpu/models/qwen25vl/text.py``). Qwen2.5-VL
and Qwen2-VL add q/k/v biases; Qwen3-VL has none, normalizes q and k per
head (RMSNorm over head_dim) before the rope, takes its head_dim from the
config, interleaves its M-RoPE sections, and adds its tower's deepstack
taps to the hidden states at vision positions after the first decoder
layers.

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

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...ops.attention import causal_attention
from ...ops.quant import dense
from ...ops.rms_norm import rms_norm
from ...ops.sharded import expert_range, local
from ...ops.rope import apply_mrope, mrope_cos_sin, mrope_cos_sin_interleaved
from .config import TextConfig


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


def write_cache_at(layer: torch.Tensor, x: torch.Tensor, col: torch.Tensor) -> None:
    """``write_cache`` of S tokens' keys or values ``x`` (B, S, Hkv, D) into
    the layer view ``layer`` (B, T, Hkv, D) at columns [col, col + S), the
    first held on the device in ``col`` (a 0-d or (1,) int64 tensor): an
    ``index_copy_``, so no value is read back to the host and a CUDA graph
    can replay the write at a column that moves (a decode step's token, or a
    speculative verify block). The stored bytes equal the slice write's.
    ``index_copy_`` has no float8 kernel, so an fp8 cache is written through
    uint8 views of both sides after the same clamp and cast."""
    cols = col.reshape(1) + torch.arange(x.shape[1], device=col.device)
    if layer.dtype == torch.float8_e4m3fn:
        x = x.clamp(-E4M3_MAX, E4M3_MAX).to(layer.dtype)
        layer, x = layer.view(torch.uint8), x.view(torch.uint8)
    layer.index_copy_(1, cols, x.to(layer.dtype))


def _attention_layer(p, cfg: TextConfig, x, cos, sin, seq_positions, kv_mask,
                     cache, layer: int, cache_offset, impl: str, validity_only: bool,
                     decode_impl: str):
    B, S, _ = x.shape
    mm = getattr(impl, "kernels", impl)  # a ring impl names the matmuls' impl
    q, k, v = dense(x, p["q_w"], mm), dense(x, p["k_w"], mm), dense(x, p["v_w"], mm)
    if cfg.attention_bias:
        q, k, v = q + p["q_b"], k + p["k_b"], v + p["v_b"]
    # Heads from the widths: on a mesh the projections give this rank's heads.
    q = q.reshape(B, S, -1, cfg.head_dim)
    k = k.reshape(B, S, -1, cfg.head_dim)
    v = v.reshape(B, S, -1, cfg.head_dim)
    if cfg.use_qk_norm:  # Qwen3: per-head RMSNorm on q and k before the rope
        q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps, mm)
        k = rms_norm(k, p["k_norm"], cfg.rms_norm_eps, mm)
    q, k = apply_mrope(q, k, cos, sin)
    if cache is not None:
        ck, cv = cache["k"][layer], cache["v"][layer]  # (B, T, Hkv, D) views
        if isinstance(cache_offset, torch.Tensor):  # decode or verify at a column on the device
            write_cache_at(ck, k, cache_offset)
            write_cache_at(cv, v, cache_offset)
        else:
            write_cache(ck[:, cache_offset:cache_offset + S], k)
            write_cache(cv[:, cache_offset:cache_offset + S], v)
        if validity_only:
            mask = kv_mask
        else:  # buffer column == position: the columns past the write head are invalid
            written = torch.arange(ck.shape[1], device=x.device)[None, :] < cache_offset + S
            mask = written if kv_mask is None else kv_mask & written
        out = causal_attention(q, ck, cv, q_positions=seq_positions, kv_mask=mask, impl=impl,
                               decode_impl=decode_impl)
    else:
        out = causal_attention(q, k, v, q_positions=seq_positions, kv_mask=kv_mask, impl=impl)
    return dense(out.reshape(B, S, -1), p["o_w"], mm)


def _mlp(p: dict, cfg: TextConfig, x: torch.Tensor, impl: str) -> torch.Tensor:
    if "router" in p:
        return moe_mlp(p, cfg, x, impl)
    return dense(F.silu(dense(x, p["gate_w"], impl)) * dense(x, p["up_w"], impl), p["down_w"],
                 impl)


def _top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest scores of each row and their indices, ties to the lower
    index, as JAX's ``lax.top_k`` takes them: a stable descending sort keeps
    equal scores in index order, so it orders by (-score, index)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p: dict, cfg: TextConfig, flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The router of a mixture layer: (N, k) expert indices and their (N, k)
    float32 weights for the tokens ``flat`` (N, D). ``softmax_topk_norm``
    (Qwen3-VL-MoE): a softmax over all experts, the top k, renormalised;
    ``topk_softmax`` (Aria): the top k logits, a softmax over those;
    ``sigmoid_bias_topk_norm`` (DeepSeek-V3's ``noaux_tc`` with one group,
    Kimi-VL): sigmoid scores of float32 logits, the top k of the scores
    plus the layer's ``router_bias`` (the bias chooses, it does not
    weigh), the chosen scores normalised (+ 1e-20) and scaled by
    ``routed_scaling_factor``."""
    if cfg.moe_routing == "sigmoid_bias_topk_norm":
        scores = torch.sigmoid(flat.float() @ p["router"].float())
        _, idx = _top_k(scores + p["router_bias"].float(), cfg.moe_topk)
        w = scores.gather(-1, idx)
        return idx, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
    logits = dense(flat, p["router"]).float()
    if cfg.moe_routing == "softmax_topk_norm":
        w, idx = _top_k(torch.softmax(logits, dim=-1), cfg.moe_topk)
        return idx, w / w.sum(dim=-1, keepdim=True)
    top, idx = _top_k(logits, cfg.moe_topk)
    return idx, torch.softmax(top, dim=-1)


def expert_groups(idx: torch.Tensor, n_experts: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (token, slot) pairs of ``idx`` (N, k) sorted by expert: the
    order (a stable sort, so a token's pairs keep their slot order; pair i
    is token i // k) and each expert's end in it (int32, on the device).
    The ends come from a search over the sorted ids, not a count read back
    to the host (``torch.bincount`` reads its length back), so a CUDA graph
    can capture them."""
    ids, order = torch.sort(idx.reshape(-1), stable=True)
    ends = torch.searchsorted(ids, torch.arange(n_experts, device=idx.device), right=True)
    return order, ends.to(torch.int32)


class RouteRing:
    """The expert ids that a decode segment's steps route to, on the device:
    ``ids`` (MoE layers, steps, rows, k), step ``at`` (a 0-d tensor on the
    device, the segment's step) written by one ``index_copy_`` per MoE layer
    and step, so a CUDA graph captured under ``record_routes`` replays the
    writes and nothing is read back until the segment's own readback.
    ``local``: the experts this rank computes (expert parallelism sorts them
    first), the others' ids are not its reads."""

    def __init__(self, layers: int, steps: int, rows: int, k: int, at: torch.Tensor):
        self.ids = torch.zeros((layers, steps, rows, k), dtype=torch.long, device=at.device)
        self.at = at.reshape(1)
        self.layer = 0
        self.local = 0

    def add(self, idx: torch.Tensor, local: int) -> None:
        self.ids[self.layer].index_copy_(0, self.at, idx[None])
        self.layer = (self.layer + 1) % self.ids.shape[0]
        self.local = local


_ROUTES = threading.local()


@contextlib.contextmanager
def record_routes(ring: Optional[RouteRing]):
    """``moe_mlp`` on this thread writes its expert ids into ``ring`` inside
    the scope, one layer after another; ``record_routes(None)`` turns an
    enclosing scope off. Outside a scope ``moe_mlp`` records nothing."""
    prev = getattr(_ROUTES, "ring", None)
    _ROUTES.ring = ring
    try:
        yield
    finally:
        _ROUTES.ring = prev


def _experts(x: torch.Tensor, fc1: torch.Tensor, fc2: torch.Tensor,
             offs: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over rows ``x`` (M, D) sorted by expert, expert e
    taking the rows up to ``offs[e]`` (int32, on the device): one grouped
    product per weight stack (fc1 (E, D, 2F): silu of the first F columns
    times the last F; fc2 (E, F, D)). ``torch._grouped_mm`` reads each
    expert's weights only where the expert has rows, and takes the group
    sizes from the device, so no count is read back to the host and a CUDA
    graph can replay it."""
    h = torch._grouped_mm(x, fc1, offs=offs)
    proj, gate = h.chunk(2, dim=-1)
    return torch._grouped_mm(F.silu(proj) * gate, fc2, offs=offs)


def moe_mlp(p: dict, cfg: TextConfig, x: torch.Tensor, impl: str = "auto",
            route: Optional[tuple] = None) -> torch.Tensor:
    """A mixture-of-experts MLP over ``x`` (..., D): the routed experts'
    outputs weighted by the router (``moe_route``), plus Aria's shared
    experts (``gate_w``/``up_w``/``down_w``) where the layer has them.

    The JAX package computes every expert on every token and a dense (N, E)
    combine whose unselected entries are 0 (``_moe_mlp``); this is the same
    function computed routed, summed over each token's k experts instead
    (``moe_mlp_dense`` is JAX's form). The N * k (token, expert) pairs are
    sorted by expert (a stable sort: a token's pairs stay in slot order),
    the rows gathered, the experts run by ``_experts``, and the results put
    back by the inverse permutation and summed over k in float32 with the
    weights cast to the activations' dtype first, as JAX's combine is. No
    shape depends on the routing, so a decode step stays capturable.
    ``route`` replaces the router's decision, as in ``moe_mlp_dense``.
    Inside ``record_routes`` the (rotated, on a mesh) expert ids are also
    copied into the scope's ``RouteRing``.

    On a mesh whose ``tensor`` axis splits the expert stacks (expert
    parallelism, JAX's ``moe_fc1``/``moe_fc2`` rules), each rank sorts its
    own experts' pairs first (the expert ids rotated by its first expert),
    runs ``torch._grouped_mm`` over those groups only, zeroes the other
    pairs' rows, and one all-reduce over ``tensor`` sums the combine in
    float32. The shapes stay independent of the routing. Under autograd
    that all-reduce's backward is the identity, and the rows and routing
    weights the rank's experts read have their gradients summed over
    ``tensor`` (``Mesh.copy_in``).

    Under autograd the router's gradient flows through the top-k weights
    (the indices, from the sort, have none), as JAX's flows through its
    combine. An expert that no token chose gets a gradient of exactly 0 in
    ``moe_fc1`` and ``moe_fc2``, as JAX's zero combine entries give it:
    ``torch._grouped_mm``'s backward writes the weight gradient of an empty
    group as zeros (on the card and on the CPU; tests/test_torch_train_moe.py
    and ``chip_smoke.py`` phase 23 hold it). The ``index_copy_`` that puts
    the experts' rows back in token order also hands ``_grouped_mm``'s
    backward a gradient of its own layout: called on a stride-0 upstream
    gradient (``y.sum()``'s) that backward raises. Under remat the
    checkpoint recomputes the routing from the same input, and the stable
    sort picks the same experts in the same order."""
    shape, D = x.shape, x.shape[-1]
    flat = x.reshape(-1, D)
    idx, w = moe_route(p, cfg, flat) if route is None else route
    n, k = idx.shape
    ep = expert_range(p["moe_fc1"])
    if ep is not None:  # expert parallelism: this rank's experts' pairs sort first
        idx = torch.remainder(idx - ep[0], cfg.moe_num_experts)
    ring = getattr(_ROUTES, "ring", None)
    if ring is not None:
        ring.add(idx, cfg.moe_num_experts if ep is None else ep[1])
    order, offs = expert_groups(idx, cfg.moe_num_experts)
    rows = flat
    if ep is not None:
        offs = offs[:ep[1]]
        # each rank's experts see the replicated rows and weights: under
        # autograd their gradients' partials are summed over tensor
        mesh = p["moe_fc1"].mesh
        rows, w = mesh.copy_in(flat, "tensor"), mesh.copy_in(w, "tensor")
    out = _experts(rows[order // k], local(p["moe_fc1"]), local(p["moe_fc2"]), offs)
    routed = torch.empty_like(out).index_copy_(0, order, out).reshape(n, k, D)
    if ep is not None:  # the rows past the local experts' were not computed
        routed = torch.where((idx < ep[1])[..., None], routed, 0)
    y = (routed.float() * w.to(x.dtype).float()[..., None]).sum(1)
    if ep is not None:
        y = p["moe_fc1"].mesh.all_reduce(y, "tensor")
    y = y.to(x.dtype)
    if "gate_w" in p:  # Aria's always-on shared experts
        y = y + dense(F.silu(dense(flat, p["gate_w"], impl)) * dense(flat, p["up_w"], impl),
                      p["down_w"], impl)
    return y.reshape(shape)


def moe_mlp_dense(p: dict, cfg: TextConfig, x: torch.Tensor,
                  route: Optional[tuple] = None) -> torch.Tensor:
    """JAX's form of ``moe_mlp`` (``text.py:_moe_mlp``): every expert over
    every token and a dense (N, E) combine, the unselected entries 0. The
    plain reference the routed form is held to; it reads every expert's
    weights and makes an (E, N, 2F) intermediate, so it is not served.
    ``route`` (``moe_route``'s output) replaces the router's own decision,
    so that a float32 reference can take a bf16 path's experts."""
    shape, D = x.shape, x.shape[-1]
    flat = x.reshape(-1, D)
    idx, w = moe_route(p, cfg, flat) if route is None else route
    combine = torch.zeros(flat.shape[0], cfg.moe_num_experts, dtype=flat.dtype,
                          device=flat.device).scatter_(1, idx, w.to(flat.dtype))
    h = torch.einsum("nd,edf->enf", flat, p["moe_fc1"])
    proj, gate = h.chunk(2, dim=-1)
    h = torch.einsum("enf,efd->end", F.silu(proj) * gate, p["moe_fc2"])
    y = torch.einsum("ne,end->nd", combine, h)
    if "gate_w" in p:
        y = y + dense(F.silu(dense(flat, p["gate_w"])) * dense(flat, p["up_w"]), p["down_w"])
    return y.reshape(shape)


def text_forward(
    params: dict,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # (B, S, D)
    position_ids: torch.Tensor,  # (3, B, S) M-RoPE positions
    *,
    seq_positions: Optional[torch.Tensor] = None,  # (B, S); default arange + offset
    attn_valid: Optional[torch.Tensor] = None,  # (B, T) bool slot validity
    cache: Optional[dict] = None,
    cache_offset: int | torch.Tensor = 0,
    attn_impl: str = "auto",
    remat: bool = False,
    validity_only: bool = False,
    decode_attn_impl: str = "auto",
    deepstack_embeds: Optional[list] = None,
    deepstack_row_index: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Returns (hidden states (B, S, D) after the final norm, the cache,
    updated in place).

    ``cache_offset`` is the buffer column of the first new token: a Python
    int, or, for a decode step or a speculative verify block (S <= 8,
    ``seq_positions`` given), a 0-d or (1,) int64 tensor on the device, so
    the step reads nothing back to the host and a CUDA graph can replay it.

    ``attn_impl`` picks, for every kernel of the decoder (attention, and K7
    where a matmul weight is int4), the kernel ("auto", on CUDA tensors) or
    its plain version ("torch"); an ``ops.ring_attention.RingImpl`` runs
    the attention of a cacheless forward as ring attention over its group
    (``parallel.context``; ``seq_positions`` then global). ``decode_attn_impl`` (the engine's knob of
    that name: "auto", "pallas" or "xla") reaches the attention of query
    blocks of at most 8 rows only, never a matmul (``ops/attention.py``).

    ``validity_only=True`` (with a cache) masks the cache by ``attn_valid``
    alone, as the JAX package does when given explicit (zero)
    ``kv_positions``: the ring-buffer decode step, whose valid columns are
    every one of a row's earlier tokens wherever the ring put them (also
    past the write head, once it wrapped). Its caller passes
    ``seq_positions`` = T, so that the causal test ``column <= position``
    of every attention path (K4 included) passes for every column.

    ``remat=True`` recomputes each decoder layer in the backward pass
    (``jax.checkpoint`` per layer in the JAX package; the reference's
    gradient checkpointing). The checkpoint is non-reentrant, so its first
    forward runs under autograd like the recompute, and attention picks its
    exact training mode in both.

    ``deepstack_embeds`` (Qwen3-VL): a list of (n_vis, D) tables, the i-th
    added into the hidden states after decoder layer i at the positions
    that ``deepstack_row_index`` (B, S) maps to a table row (-1: none), as
    HF's ``Qwen3VLTextModel._deepstack_process``. The addition is
    positionwise, so a chunk of a prefill takes the index's columns of that
    chunk; decode steps and verify blocks carry no taps."""
    B, S, _ = inputs_embeds.shape
    if seq_positions is None:
        seq_positions = torch.arange(S, device=inputs_embeds.device).expand(B, S) + cache_offset
    rope = mrope_cos_sin_interleaved if cfg.mrope_interleaved else mrope_cos_sin
    cos, sin = rope(position_ids, cfg.head_dim, cfg.mrope_section, cfg.rope_theta)
    cos = cos.to(inputs_embeds.dtype)
    sin = sin.to(inputs_embeds.dtype)

    impl = getattr(attn_impl, "kernels", attn_impl)  # a ring impl names the other kernels'

    def layer_fn(x, layer, i):
        h = rms_norm(x, layer["input_norm"], cfg.rms_norm_eps, impl)
        x = x + _attention_layer(layer, cfg, h, cos, sin, seq_positions, attn_valid,
                                 cache, i, cache_offset, attn_impl, validity_only,
                                 decode_attn_impl)
        h = rms_norm(x, layer["post_norm"], cfg.rms_norm_eps, impl)
        return x + _mlp(layer, cfg, h, impl)

    x = inputs_embeds
    for i, layer in enumerate(params["layers"]):
        if remat:
            x = checkpoint(layer_fn, x, layer, i, use_reentrant=False)
        else:
            x = layer_fn(x, layer, i)
        if deepstack_embeds is not None and i < len(deepstack_embeds):
            tbl = deepstack_embeds[i]
            flat_idx = deepstack_row_index.reshape(-1).long()
            add = tbl[flat_idx.clamp(0, tbl.shape[0] - 1)].to(x.dtype)
            x = x + torch.where((flat_idx >= 0)[:, None], add, 0).reshape(x.shape)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps, impl), cache


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
