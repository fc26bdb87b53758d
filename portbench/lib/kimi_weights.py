"""Seeded random weights of Kimi-VL in the program's parameter layout
(``open_o3_video_tpu_torch/models/kimi_vl/params.py``), made on the device
as ``weights.py`` makes the Qwen families': every matrix normal(0, 0.02),
the routers' correction bias too, every norm weight 1 and every bias 0, in
bf16, the matrices views into one buffer filled slice by slice from a
generator seeded with the run's seed. A test holds the layout to the
program's own ``init`` at a tiny size."""

from __future__ import annotations

import math

import torch

from .kimi_arch import Arch
from .weights import FILL_CHUNK, INIT_STD, _leaves, _walk


def leaf_specs(a: Arch) -> dict:
    """The parameter tree with each leaf a (kind, shape) pair, kind "w"
    (random), "ones" or "zeros"."""
    v, t = a.vision, a.text
    W, ONE, ZERO = "w", "ones", "zeros"
    D, F, U = v.hidden, v.inter, v.hidden * v.unit

    def block():
        return {"norm1": (ONE, (D,)), "norm1_b": (ZERO, (D,)), "qkv_w": (W, (D, 3 * D)),
                "qkv_b": (ZERO, (3 * D,)), "proj_w": (W, (D, D)), "proj_b": (ZERO, (D,)),
                "norm2": (ONE, (D,)), "norm2_b": (ZERO, (D,)), "fc1_w": (W, (D, F)),
                "fc1_b": (ZERO, (F,)), "fc2_w": (W, (F, D)), "fc2_b": (ZERO, (D,))}

    visual = {"patch_embed": (W, (v.patch_dim, D)), "patch_embed_b": (ZERO, (D,)),
              "pos_embed": (W, (*v.pos_hw, D)), "blocks": [block() for _ in range(v.depth)],
              "final_norm": (ONE, (D,)), "final_norm_b": (ZERO, (D,)),
              "merger": {"ln_q": (ONE, (D,)), "ln_q_b": (ZERO, (D,)), "fc1_w": (W, (U, U)),
                         "fc1_b": (ZERO, (U,)), "fc2_w": (W, (U, v.out_hidden)),
                         "fc2_b": (ZERO, (v.out_hidden,))}}
    Dt, H = t.hidden, t.heads

    def layer(i):
        lay = {"input_norm": (ONE, (Dt,)), "q_w": (W, (Dt, H * t.qk_dim)),
               "kv_a_w": (W, (Dt, t.latent)), "kv_norm": (ONE, (t.kv_rank,)),
               "kv_b_w": (W, (t.kv_rank, H * (t.nope + t.v_dim))),
               "o_w": (W, (H * t.v_dim, Dt)), "post_norm": (ONE, (Dt,))}
        if i < t.dense_layers:
            lay.update(gate_w=(W, (Dt, t.inter)), up_w=(W, (Dt, t.inter)),
                       down_w=(W, (t.inter, Dt)))
            return lay
        Fs = t.moe_inter * t.shared
        lay.update(router=(W, (Dt, t.experts)), router_bias=(W, (t.experts,)),
                   moe_fc1=(W, (t.experts, Dt, 2 * t.moe_inter)),
                   moe_fc2=(W, (t.experts, t.moe_inter, Dt)),
                   gate_w=(W, (Dt, Fs)), up_w=(W, (Dt, Fs)), down_w=(W, (Fs, Dt)))
        return lay

    text = {"embed_tokens": (W, (t.vocab, Dt)), "layers": [layer(i) for i in range(t.layers)],
            "final_norm": (ONE, (Dt,)), "lm_head": (W, (Dt, t.vocab))}
    return {"visual": visual, "text": text}


def make_weights(a: Arch, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The tree of ``leaf_specs`` with tensors on ``device`` (as
    ``weights.make_weights``)."""
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


def count(a: Arch) -> int:
    """Elements of the random matrices (every parameter but norms and
    biases)."""
    return sum(math.prod(s) for k, s in _leaves(leaf_specs(a)) if k == "w")
