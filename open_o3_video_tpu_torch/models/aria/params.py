"""Aria's parameter dict: random init on the device, import of the JAX
package's tree, and the HF safetensors import and export (counterpart of
``open_o3_video_tpu/models/aria/params.py``).

The decoder's tree is the shared one (``models/qwen25vl/params.py``) with
each layer's MLP a mixture: ``router`` (D, E), ``moe_fc1`` (E, D, 2F),
``moe_fc2`` (E, F, D) and the shared experts' SwiGLU in ``gate_w`` /
``up_w`` / ``down_w`` (width F times the shared-expert count). Linear
weights are input-major (``x @ W``).

visual: patch_embed (C * ps * ps, D), patch_embed_b, pos_embed
        (num_patches_per_side^2, D), blocks[i]: norm1(_b), q/k/v/out _w/_b,
        norm2(_b), fc1_w/b, fc2_w/b
projector: query (max_query_num, D), ln_q(_b), ln_kv(_b), q_w, k_w, v_w,
           mha_{q,k,v,out}_w/b, lin_w/b, ln_ff(_b), ff_in_w (D, Dt),
           ff_out_w (Dt, Dt)
"""

from __future__ import annotations

import json
import os

import torch

from ..qwen25vl.params import from_jax_params, write_safetensors
from .config import AriaConfig

_BLOCK = {  # HF suffix under vision_tower.encoder.layers.{i}. -> (leaf, transpose)
    "layer_norm1.weight": ("norm1", False),
    "layer_norm1.bias": ("norm1_b", False),
    "layer_norm2.weight": ("norm2", False),
    "layer_norm2.bias": ("norm2_b", False),
    "self_attn.q_proj.weight": ("q_w", True),
    "self_attn.q_proj.bias": ("q_b", False),
    "self_attn.k_proj.weight": ("k_w", True),
    "self_attn.k_proj.bias": ("k_b", False),
    "self_attn.v_proj.weight": ("v_w", True),
    "self_attn.v_proj.bias": ("v_b", False),
    "self_attn.out_proj.weight": ("out_w", True),
    "self_attn.out_proj.bias": ("out_b", False),
    "mlp.fc1.weight": ("fc1_w", True),
    "mlp.fc1.bias": ("fc1_b", False),
    "mlp.fc2.weight": ("fc2_w", True),
    "mlp.fc2.bias": ("fc2_b", False),
}
_LAYER = {  # under language_model.layers.{i}.
    "input_layernorm.weight": ("input_norm", False),
    "post_attention_layernorm.weight": ("post_norm", False),
    "self_attn.q_proj.weight": ("q_w", True),
    "self_attn.k_proj.weight": ("k_w", True),
    "self_attn.v_proj.weight": ("v_w", True),
    "self_attn.o_proj.weight": ("o_w", True),
    "mlp.router.weight": ("router", True),
    # (E, D, 2F) and (E, F, D): already input-major per expert
    "mlp.experts.fc1.weight": ("moe_fc1", False),
    "mlp.experts.fc2.weight": ("moe_fc2", False),
    "mlp.shared_experts.gate_proj.weight": ("gate_w", True),
    "mlp.shared_experts.up_proj.weight": ("up_w", True),
    "mlp.shared_experts.down_proj.weight": ("down_w", True),
}
_PROJECTOR = {  # under multi_modal_projector.
    "query": ("query", False),
    "cross_attn.q_proj.weight": ("q_w", True),
    "cross_attn.k_proj.weight": ("k_w", True),
    "cross_attn.v_proj.weight": ("v_w", True),
    "cross_attn.multihead_attn.out_proj.weight": ("mha_out_w", True),
    "cross_attn.multihead_attn.out_proj.bias": ("mha_out_b", False),
    "cross_attn.linear.weight": ("lin_w", True),
    "cross_attn.linear.bias": ("lin_b", False),
    "cross_attn.layer_norm.weight": ("ln_q", False),
    "cross_attn.layer_norm.bias": ("ln_q_b", False),
    "cross_attn.layer_norm_kv.weight": ("ln_kv", False),
    "cross_attn.layer_norm_kv.bias": ("ln_kv_b", False),
    "layer_norm.weight": ("ln_ff", False),
    "layer_norm.bias": ("ln_ff_b", False),
    "feed_forward.linear_in.weight": ("ff_in_w", True),
    "feed_forward.linear_out.weight": ("ff_out_w", True),
}
# nn.MultiheadAttention's packed in-projection: q, k, v stacked on dim 0
_IN_PROJ = (("mha_q_w", "mha_q_b"), ("mha_k_w", "mha_k_b"), ("mha_v_w", "mha_v_b"))


def init(cfg: AriaConfig, seed: int, device) -> dict:
    """Random normal(0.02) weights, unit norms and zero biases, drawn on
    ``device`` from a seeded ``torch.Generator`` in ``cfg.dtype`` (not the
    JAX package's random bits)."""
    v, t = cfg.vision, cfg.text
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def w(*shape):
        return torch.empty(shape, dtype=cfg.dtype, device=device).normal_(0.0, 0.02, generator=gen)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.dtype, device=device)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=device)

    D, Dt = v.hidden_size, t.hidden_size

    def block():
        return {"norm1": ones(D), "norm1_b": zeros(D),
                "q_w": w(D, D), "q_b": zeros(D), "k_w": w(D, D), "k_b": zeros(D),
                "v_w": w(D, D), "v_b": zeros(D), "out_w": w(D, D), "out_b": zeros(D),
                "norm2": ones(D), "norm2_b": zeros(D),
                "fc1_w": w(D, v.intermediate_size), "fc1_b": zeros(v.intermediate_size),
                "fc2_w": w(v.intermediate_size, D), "fc2_b": zeros(D)}

    visual = {"patch_embed": w(v.in_channels * v.patch_size**2, D), "patch_embed_b": zeros(D),
              "pos_embed": w(v.num_patches_per_side**2, D),
              "blocks": [block() for _ in range(v.num_hidden_layers)]}
    projector = {"query": w(cfg.max_query_num, D), "ln_q": ones(D), "ln_q_b": zeros(D),
                 "ln_kv": ones(D), "ln_kv_b": zeros(D),
                 "q_w": w(D, D), "k_w": w(D, D), "v_w": w(D, D),
                 "mha_q_w": w(D, D), "mha_q_b": zeros(D), "mha_k_w": w(D, D), "mha_k_b": zeros(D),
                 "mha_v_w": w(D, D), "mha_v_b": zeros(D),
                 "mha_out_w": w(D, D), "mha_out_b": zeros(D), "lin_w": w(D, D), "lin_b": zeros(D),
                 "ln_ff": ones(D), "ln_ff_b": zeros(D),
                 "ff_in_w": w(D, Dt), "ff_out_w": w(Dt, Dt)}
    F_, E = t.intermediate_size, t.moe_num_experts
    Fs = F_ * t.moe_num_shared_experts
    q_dim, kv_dim = t.num_attention_heads * t.head_dim, t.num_key_value_heads * t.head_dim

    def layer():
        return {"input_norm": ones(Dt), "q_w": w(Dt, q_dim), "k_w": w(Dt, kv_dim),
                "v_w": w(Dt, kv_dim), "o_w": w(q_dim, Dt), "post_norm": ones(Dt),
                "router": w(Dt, E), "moe_fc1": w(E, Dt, 2 * F_), "moe_fc2": w(E, F_, Dt),
                "gate_w": w(Dt, Fs), "up_w": w(Dt, Fs), "down_w": w(Fs, Dt)}

    text = {"embed_tokens": w(t.vocab_size, Dt),
            "layers": [layer() for _ in range(t.num_hidden_layers)],
            "final_norm": ones(Dt), "lm_head": w(Dt, t.vocab_size)}
    return {"visual": visual, "projector": projector, "text": text}


def from_hf_state_dict(named, cfg: AriaConfig, device) -> dict:
    """Param dict from (HF name, tensor) pairs of an Aria checkpoint (with
    or without the ``model.`` prefix); a missing ``lm_head`` ties to the
    embedding. The tower's post-layernorm is not read (the features come
    from the last layer, ``vision_feature_layer=-1``)."""
    v, t = cfg.vision, cfg.text
    D = v.hidden_size
    visual = {"blocks": [{} for _ in range(v.num_hidden_layers)]}
    projector: dict = {}
    text = {"layers": [{} for _ in range(t.num_hidden_layers)]}

    def leaf(x, transpose=False):
        x = x.T if transpose else x
        return x.to(device=device, dtype=cfg.dtype).contiguous()

    for key, x in named:
        key = key[len("model."):] if key.startswith("model.") else key
        parts = key.split(".")
        if key == "language_model.embed_tokens.weight":
            text["embed_tokens"] = leaf(x)
        elif key == "language_model.norm.weight":
            text["final_norm"] = leaf(x)
        elif key == "lm_head.weight":
            text["lm_head"] = leaf(x, True)
        elif key.startswith("language_model.layers.") and ".".join(parts[3:]) in _LAYER:
            name, tr = _LAYER[".".join(parts[3:])]
            text["layers"][int(parts[2])][name] = leaf(x, tr)
        elif key == "vision_tower.embeddings.patch_embedding.weight":  # Conv2d at full stride
            visual["patch_embed"] = leaf(x.reshape(x.shape[0], -1), True)
        elif key == "vision_tower.embeddings.patch_embedding.bias":
            visual["patch_embed_b"] = leaf(x)
        elif key == "vision_tower.embeddings.position_embedding.weight":
            visual["pos_embed"] = leaf(x)
        elif key.startswith("vision_tower.encoder.layers.") and ".".join(parts[4:]) in _BLOCK:
            name, tr = _BLOCK[".".join(parts[4:])]
            visual["blocks"][int(parts[3])][name] = leaf(x, tr)
        elif key == "multi_modal_projector.cross_attn.multihead_attn.in_proj_weight":
            for j, (name, _) in enumerate(_IN_PROJ):
                projector[name] = leaf(x[j * D:(j + 1) * D], True)
        elif key == "multi_modal_projector.cross_attn.multihead_attn.in_proj_bias":
            for j, (_, name) in enumerate(_IN_PROJ):
                projector[name] = leaf(x[j * D:(j + 1) * D])
        elif key.startswith("multi_modal_projector.") and ".".join(parts[1:]) in _PROJECTOR:
            name, tr = _PROJECTOR[".".join(parts[1:])]
            projector[name] = leaf(x, tr)
    if "lm_head" not in text and "embed_tokens" in text:
        text["lm_head"] = leaf(text["embed_tokens"], True)
    missing = [f"text.{k}" for k in ("embed_tokens", "final_norm", "lm_head") if k not in text]
    missing += [f"visual.{k}" for k in ("patch_embed", "patch_embed_b", "pos_embed")
                if k not in visual]
    proj_leaves = [n for n, _ in _PROJECTOR.values()] + [n for pair in _IN_PROJ for n in pair]
    missing += [f"projector.{k}" for k in proj_leaves if k not in projector]
    for where, rows, names in (("text.layers", text["layers"], _LAYER),
                               ("visual.blocks", visual["blocks"], _BLOCK)):
        for i, got in enumerate(rows):
            missing += [f"{where}[{i}].{n}" for n, _ in names.values() if n not in got]
    if missing:
        raise ValueError(f"checkpoint is missing {len(missing)} parameters, e.g. {missing[:3]}")
    return {"visual": visual, "projector": projector, "text": text}


def load_pretrained(model_dir: str, device, cfg: AriaConfig | None = None
                    ) -> tuple[dict, AriaConfig]:
    """(params, cfg) from an HF Aria directory of safetensors shards, read
    with safetensors' torch loader."""
    from safetensors import safe_open

    if cfg is None:
        cfg = AriaConfig.from_pretrained(model_dir)
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
    else:
        shards = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))

    def named():
        for shard in shards:
            with safe_open(os.path.join(model_dir, shard), framework="pt") as f:
                for key in f.keys():
                    yield key, f.get_tensor(key)

    return from_hf_state_dict(named(), cfg, device), cfg


def hf_named_tensors(params: dict, cfg: AriaConfig):
    """(HF name, tensor) pairs of a param dict in the HF layout, the names
    of the JAX package's ``save_safetensors``; the inverse of
    ``from_hf_state_dict``. Tensors are views, copied by the caller."""
    v = cfg.vision
    t = params["text"]
    yield "model.language_model.embed_tokens.weight", t["embed_tokens"]
    yield "model.language_model.norm.weight", t["final_norm"]
    yield "lm_head.weight", t["lm_head"].T
    for i, layer in enumerate(t["layers"]):
        for suffix, (name, tr) in _LAYER.items():
            yield f"model.language_model.layers.{i}.{suffix}", layer[name].T if tr else layer[name]
    vis = params["visual"]
    pre = "model.vision_tower."
    yield pre + "embeddings.patch_embedding.weight", vis["patch_embed"].T.reshape(
        v.hidden_size, v.in_channels, v.patch_size, v.patch_size)
    yield pre + "embeddings.patch_embedding.bias", vis["patch_embed_b"]
    yield pre + "embeddings.position_embedding.weight", vis["pos_embed"]
    for i, b in enumerate(vis["blocks"]):
        for suffix, (name, tr) in _BLOCK.items():
            yield f"{pre}encoder.layers.{i}.{suffix}", b[name].T if tr else b[name]
    pj = params["projector"]
    pre = "model.multi_modal_projector."
    for suffix, (name, tr) in _PROJECTOR.items():
        yield pre + suffix, pj[name].T if tr else pj[name]
    yield pre + "cross_attn.multihead_attn.in_proj_weight", torch.cat(
        [pj[w].T for w, _ in _IN_PROJ])
    yield pre + "cross_attn.multihead_attn.in_proj_bias", torch.cat([pj[b] for _, b in _IN_PROJ])


def save_safetensors(params: dict, cfg: AriaConfig, out_path: str, dtype=None) -> None:
    """Write the param dict as one HF-convention safetensors file (the JAX
    package's ``save_safetensors`` names; ``dtype`` as in
    ``qwen25vl.params.save_safetensors``)."""
    write_safetensors(list(hf_named_tensors(params, cfg)), out_path, dtype)


__all__ = ["init", "from_hf_state_dict", "from_jax_params", "load_pretrained",
           "hf_named_tensors", "save_safetensors"]
