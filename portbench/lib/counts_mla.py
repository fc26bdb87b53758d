"""Operations and bytes of Kimi-VL's work from shapes alone (the rules of
``counts.py``: the least time is the larger of the operations at the bf16
peak and the bytes, each input read once and each output written once, at
the HBM rate).

- Absorbed decode attention (``o3v_mla_decode`` and its combine): per
  (query row, visible key) and layer 2 x heads x (576 + 512) operations
  (scores against the 576-wide latent row, values over its 512); bytes:
  each visible latent column once (576 bf16 values a layer), each row's
  576-wide queries and 512-wide outputs of every head.
- Expanded prefill attention (``o3v_mla_prefill``): per causal pair, head
  and layer 2 x (192 + 128) operations; bytes: q (192 a head), k_nope and
  v (128 + 128 a head) and the shared k_pe (64) of each key, the output
  (128 a head).
- Model operations (``mfu_mla.serve``): 2 per weight a token meets (the
  routed experts' top k, the shared experts, the dense layer, every
  attention projection with ``kv_b`` once a token), attention by causal
  pairs in the expanded form, the lm_head per answer token, and the tower
  (its matrices, whole-frame attention pairs at 4 x width, the projector).
"""

from __future__ import annotations

import math

from .counts import BF16, bound_s, causal_pairs  # noqa: F401  (bound_s re-exported)
from .kimi_weights import leaf_specs


def _elems(tree, skip=()) -> int:
    if isinstance(tree, dict):
        return sum(_elems(v, skip) for k, v in tree.items() if k not in skip)
    if isinstance(tree, list):
        return sum(_elems(v, skip) for v in tree)
    return math.prod(tree[1])


def _matrices(tree, skip=()) -> int:
    if isinstance(tree, dict):
        return sum(_matrices(v, skip) for k, v in tree.items() if k not in skip)
    if isinstance(tree, list):
        return sum(_matrices(v, skip) for v in tree)
    return math.prod(tree[1]) if len(tree[1]) >= 2 else 0


def latent_bytes_per_token(a) -> int:
    """A token's latent rows over every layer."""
    return BF16 * a.text.layers * a.text.latent


def decode_attention(a, live: list) -> tuple[float, float]:
    """(operations, bytes) of one decode step's absorbed attention for rows
    whose visible keys are ``live`` (one count a row)."""
    t = a.text
    keys = sum(live)
    flops = 2 * t.heads * (t.latent + t.kv_rank) * keys * t.layers
    nbytes = (latent_bytes_per_token(a) * keys
              + BF16 * t.layers * len(live) * t.heads * (t.latent + t.kv_rank))
    return flops, nbytes


def prefill_attention(a, forwards) -> tuple[float, float]:
    """(operations, bytes) of the expanded attention over ``forwards``
    ((queries, keys) of each row, causal, the queries the last keys)."""
    t = a.text
    flops = sum(2 * (t.qk_dim + t.v_dim) * t.heads * causal_pairs(q, kv) for q, kv in forwards)
    nbytes = sum(BF16 * (q * t.heads * (t.qk_dim + t.v_dim)
                         + kv * (t.heads * (t.nope + t.v_dim) + t.rope)) for q, kv in forwards)
    return t.layers * flops, t.layers * nbytes


def text_weight_bytes(a, experts_read: float) -> float:
    """Bytes of the decoder weights a decode step reads: every layer's
    attention, dense, shared and router weights, ``experts_read`` routed
    experts in each expert layer, the lm_head; not the embedding table."""
    t = a.text
    spec = leaf_specs(a)["text"]
    dense = sum(_elems(layer, skip=("moe_fc1", "moe_fc2")) for layer in spec["layers"])
    per_expert = 3 * t.hidden * t.moe_inter
    expert_layers = t.layers - t.dense_layers
    return BF16 * (dense + _elems(spec["final_norm"]) + _elems(spec["lm_head"])
                   + expert_layers * experts_read * per_expert)


def _active_matrix_params(a) -> int:
    """Decoder matrix elements a token multiplies by: the top-k routed
    experts only; not the embedding lookup or the lm_head."""
    t = a.text
    spec = leaf_specs(a)["text"]
    n = sum(_matrices(layer, skip=("moe_fc1", "moe_fc2")) for layer in spec["layers"])
    return n + (t.layers - t.dense_layers) * t.topk * 3 * t.hidden * t.moe_inter


def decoder_flops(a, tokens: int, attn_pairs: int, logits: int) -> float:
    t = a.text
    return (2 * tokens * _active_matrix_params(a)
            + 2 * (t.qk_dim + t.v_dim) * t.heads * t.layers * attn_pairs
            + 2 * logits * t.hidden * t.vocab)


def vision_flops(a, grids) -> float:
    v = a.vision
    spec = leaf_specs(a)["visual"]
    n = sum(t * h * w for t, h, w in grids)
    pairs = sum(t * (h * w) ** 2 for t, h, w in grids)
    flops = 2 * n * (_matrices({"p": spec["patch_embed"]}) + v.depth * _matrices(spec["blocks"][0]))
    flops += 4 * pairs * v.hidden * v.depth
    return flops + 2 * (n // v.unit) * _matrices(spec["merger"])
