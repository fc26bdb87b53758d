"""Seeded random weights in the program's parameter layout, made on the
device in a few large calls.

Every matrix is normal(0, 0.02) (the published initializer scale), every
norm weight 1 and every bias 0, in the dtype the model is served in. The
matrices are views into one flat buffer that a ``torch.Generator`` on the
device fills slice by slice, so the same seed gives the same bits on every
call: the reference makes its copy again after the program is gone.

The layout is the program's (``open_o3_video_tpu_torch/models/qwen25vl/
params.py``): linear weights input-major, the expert stacks (E, D, 2F) and
(E, F, D). A test holds it to the program's own ``init`` at a tiny size.
"""

from __future__ import annotations

import math

import torch

from .arch import Arch

# Elements filled by one call of the generator.
FILL_CHUNK = 1 << 28
INIT_STD = 0.02


def leaf_specs(a: Arch) -> dict:
    """The parameter tree with each leaf a (kind, shape) pair, kind "w"
    (random), "ones" or "zeros"."""
    v, t = a.vision, a.text
    W, ONE, ZERO = "w", "ones", "zeros"

    def norm(name, n, with_bias):
        out = {name: (ONE, (n,))}
        if with_bias:
            out[name + "_b"] = (ZERO, (n,))
        return out

    def block():
        b = {**norm("norm1", v.hidden, v.norm == "ln"),
             "qkv_w": (W, (v.hidden, 3 * v.hidden)), "qkv_b": (ZERO, (3 * v.hidden,)),
             "proj_w": (W, (v.hidden, v.hidden)), "proj_b": (ZERO, (v.hidden,)),
             **norm("norm2", v.hidden, v.norm == "ln")}
        if v.act == "swiglu":
            b.update(gate_w=(W, (v.hidden, v.inter)), gate_b=(ZERO, (v.inter,)),
                     up_w=(W, (v.hidden, v.inter)), up_b=(ZERO, (v.inter,)),
                     down_w=(W, (v.inter, v.hidden)), down_b=(ZERO, (v.hidden,)))
        else:
            b.update(fc1_w=(W, (v.hidden, v.inter)), fc1_b=(ZERO, (v.inter,)),
                     fc2_w=(W, (v.inter, v.hidden)), fc2_b=(ZERO, (v.hidden,)))
        return b

    merged = v.hidden * v.unit

    def merger(postshuffle):
        return {**norm("ln_q", merged if postshuffle else v.hidden, v.norm == "ln"),
                "fc1_w": (W, (merged, merged)), "fc1_b": (ZERO, (merged,)),
                "fc2_w": (W, (merged, v.out_hidden)), "fc2_b": (ZERO, (v.out_hidden,))}

    visual = {"patch_embed": (W, (v.patch_dim, v.hidden)),
              "blocks": [block() for _ in range(v.depth)], "merger": merger(False)}
    if v.patch_bias:
        visual["patch_embed_b"] = (ZERO, (v.hidden,))
    if v.pos_embeds:
        visual["pos_embed"] = (W, (v.pos_embeds, v.hidden))
    if v.deepstack:
        visual["deepstack"] = [merger(True) for _ in v.deepstack]

    q_dim, kv_dim = t.heads * t.head_dim, t.kv_heads * t.head_dim

    def layer():
        lay = {"input_norm": (ONE, (t.hidden,)), "q_w": (W, (t.hidden, q_dim)),
               "k_w": (W, (t.hidden, kv_dim)), "v_w": (W, (t.hidden, kv_dim)),
               "o_w": (W, (q_dim, t.hidden)), "post_norm": (ONE, (t.hidden,))}
        if t.attn_bias:
            lay.update(q_b=(ZERO, (q_dim,)), k_b=(ZERO, (kv_dim,)), v_b=(ZERO, (kv_dim,)))
        if t.experts:
            lay.update(router=(W, (t.hidden, t.experts)),
                       moe_fc1=(W, (t.experts, t.hidden, 2 * t.moe_inter)),
                       moe_fc2=(W, (t.experts, t.moe_inter, t.hidden)))
        else:
            lay.update(gate_w=(W, (t.hidden, t.inter)), up_w=(W, (t.hidden, t.inter)),
                       down_w=(W, (t.inter, t.hidden)))
        if t.qk_norm:
            lay.update(q_norm=(ONE, (t.head_dim,)), k_norm=(ONE, (t.head_dim,)))
        return lay

    text = {"embed_tokens": (W, (t.vocab, t.hidden)),
            "layers": [layer() for _ in range(t.layers)],
            "final_norm": (ONE, (t.hidden,)), "lm_head": (W, (t.hidden, t.vocab))}
    return {"visual": visual, "text": text}


def _walk(tree, fn):
    if isinstance(tree, dict):
        return {k: _walk(x, fn) for k, x in tree.items()}
    if isinstance(tree, list):
        return [_walk(x, fn) for x in tree]
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _walk(tree, out.append)
    return out


def count(a: Arch, kind: str = "w") -> int:
    """Elements of the leaves of ``kind`` (default: the random matrices)."""
    return sum(math.prod(shape) for k, shape in _leaves(leaf_specs(a)) if k == kind)


def make_weights(a: Arch, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The tree of ``leaf_specs`` with tensors on ``device``: the random
    matrices as views into one buffer filled ``FILL_CHUNK`` elements a
    call from a generator seeded with ``seed``; ones and zeros the same."""
    specs = leaf_specs(a)
    sizes = {kind: sum(math.prod(s) for k, s in _leaves(specs) if k == kind)
             for kind in ("w", "ones", "zeros")}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.empty(sizes["w"], dtype=dtype, device=device)
    for i in range(0, sizes["w"], FILL_CHUNK):
        flat[i:i + FILL_CHUNK].normal_(0.0, INIT_STD, generator=gen)
    bufs = {"w": flat, "ones": torch.ones(sizes["ones"], dtype=dtype, device=device),
            "zeros": torch.zeros(sizes["zeros"], dtype=dtype, device=device)}
    at = dict.fromkeys(bufs, 0)

    def view(spec):
        kind, shape = spec
        n = math.prod(shape)
        out = bufs[kind][at[kind]:at[kind] + n].view(shape)
        at[kind] += n
        return out

    return _walk(specs, view)


def map_leaves(tree, fn):
    """``tree`` with every tensor leaf replaced by ``fn(name, leaf)``."""
    def go(x, name):
        if isinstance(x, dict):
            return {k: go(y, k) for k, y in x.items()}
        if isinstance(x, list):
            return [go(y, name) for y in x]
        return fn(name, x)
    return go(tree, "")
