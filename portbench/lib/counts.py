"""Operations and bytes that the inputs need, from shapes alone, whatever
implements them; and the card's published peaks they are held to.

The roofline rule is ``chip_smoke.py``'s ``bound_ms``, frozen here: the
least time is the larger of the operations at the bf16 dense peak and the
bytes (each input read once, each output written once) at the memory rate.
Causal attention counts 4 operations per visible (query, key) pair per
head dimension (QK^T and PV, a multiply and an add each).
"""

from __future__ import annotations

import math

from .weights import leaf_specs

# NVIDIA H100 SXM5 80 GB, NVIDIA's data sheet: dense bf16 tensor-core rate
# and HBM3 bandwidth, at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16 = 2


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def _matrix_elems(tree, skip=()) -> int:
    if isinstance(tree, dict):
        return sum(_matrix_elems(v, skip) for k, v in tree.items() if k not in skip)
    if isinstance(tree, list):
        return sum(_matrix_elems(v, skip) for v in tree)
    kind, shape = tree
    return math.prod(shape) if kind == "w" and len(shape) >= 2 else 0


def text_matmul_params(a, per_token: bool = True) -> int:
    """Decoder matrix elements a token multiplies by (the embedding table is
    a lookup, the lm_head is counted apart): with ``per_token`` and routed
    experts, the router and the top-k experts only."""
    t = a.text
    spec = leaf_specs(a)["text"]["layers"][0]
    layer = _matrix_elems(spec, skip=("moe_fc1", "moe_fc2"))
    if t.experts:
        n = t.topk if per_token else t.experts
        layer += n * 3 * t.hidden * t.moe_inter
    return t.layers * layer


def _elems(tree) -> int:
    if isinstance(tree, dict):
        return sum(_elems(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_elems(v) for v in tree)
    return math.prod(tree[1])


def text_weight_bytes(a) -> int:
    """Bytes of every decoder weight a decode step must read once: the
    layers (every expert), norms, biases and the lm_head; not the embedding
    table, of which a step reads a row a token."""
    spec = leaf_specs(a)["text"]
    return BF16 * (_elems(spec) - _elems({"e": spec["embed_tokens"]}))


def kv_bytes_per_token(a) -> int:
    t = a.text
    return BF16 * 2 * t.layers * t.kv_heads * t.head_dim


def causal_pairs(q: int, kv: int) -> int:
    """Visible pairs of ``q`` queries at the end of ``kv`` keys, causal."""
    return q * (kv - q) + q * (q + 1) // 2


def prefill_attention(a, forwards) -> tuple[float, float]:
    """(operations, bytes) of the decoder's prefill attention over
    ``forwards``: (queries, keys) pairs, each a row that attends causally to
    its keys, the queries the last of them."""
    t = a.text
    flops = sum(4 * causal_pairs(q, kv) * t.heads * t.head_dim for q, kv in forwards)
    nbytes = sum(BF16 * t.head_dim * (2 * q * t.heads + 2 * kv * t.kv_heads)
                 for q, kv in forwards)
    return t.layers * flops, t.layers * nbytes


def vision_flops(a, grids) -> float:
    """Tower operations for patch grids (t, h, w): every patch through
    every block's matrices, attention within windows or whole frames, and
    the mergers."""
    v = a.vision
    spec = leaf_specs(a)["visual"]
    n = sum(t * h * w for t, h, w in grids)
    block = _matrix_elems(spec["blocks"][0])
    mergers = _matrix_elems(spec["merger"]) + sum(_matrix_elems(m) for m in spec.get("deepstack",
                                                                                        []))
    flops = 2 * n * (_matrix_elems({"p": spec["patch_embed"]}) + v.depth * block)
    flops += 2 * (n // v.unit) * mergers
    side = v.window_size // v.patch // v.merge if v.window_size else 0
    for i in range(v.depth):
        pairs = 0
        for t, h, w in grids:
            if side and i not in v.fullatt:
                mh, mw = h // v.merge, w // v.merge
                rows = [min(side, mh - r) for r in range(0, mh, side)]
                cols = [min(side, mw - c) for c in range(0, mw, side)]
                pairs += t * sum((r * c * v.unit) ** 2 for r in rows for c in cols)
            else:
                pairs += t * (h * w) ** 2
        flops += 4 * pairs * v.hidden
    return flops


def decoder_flops(a, tokens: int, attn_pairs: int, logits: int) -> float:
    """Operations of ``tokens`` through the decoder's matrices, attention
    over ``attn_pairs`` visible pairs, and ``logits`` lm_head rows."""
    t = a.text
    return (2 * tokens * text_matmul_params(a) + 4 * attn_pairs * t.layers * t.heads * t.head_dim
            + 2 * logits * t.hidden * t.vocab)
