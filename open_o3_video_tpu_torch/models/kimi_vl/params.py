"""Kimi-VL's parameter dict: seeded init on the device and the HF
safetensors import (``modeling_kimi_vl.py``'s names). Linear weights are
input-major (``x @ W``).

visual: patch_embed (3 * 14 * 14, D), patch_embed_b, pos_embed (64, 64, D),
        blocks[i]: norm1(_b), qkv_w (D, 3D), qkv_b, proj_w, proj_b,
        norm2(_b), fc1_w (D, F), fc1_b, fc2_w (F, D), fc2_b;
        final_norm(_b); merger: ln_q(_b) (D), fc1_w (4D, 4D), fc1_b,
        fc2_w (4D, Dt), fc2_b
text:   embed_tokens, final_norm, lm_head (Dt, V), layers[i]: input_norm,
        q_w (Dt, H * 192), kv_a_w (Dt, 512 + 64), kv_norm (512),
        kv_b_w (512, H * (128 + 128): per head k_nope then v), o_w
        (H * 128, Dt), post_norm, and the MLP: layer 0 a SwiGLU
        (gate_w, up_w, down_w of width 11264); the others ``router``
        (Dt, E), ``router_bias`` (E,) float32 (``e_score_correction_bias``),
        ``moe_fc1`` (E, Dt, 2F: gate then up), ``moe_fc2`` (E, F, Dt) and
        the shared experts' SwiGLU in gate_w / up_w / down_w (width
        2 x 1408), as ``qwen25vl.text.moe_mlp`` reads them.
"""

from __future__ import annotations

import json
import os

import torch

from .config import KimiVLConfig

_BLOCK = {  # under vision_tower.encoder.blocks.{i}. -> (leaf, transpose)
    "norm0.weight": ("norm1", False), "norm0.bias": ("norm1_b", False),
    "norm1.weight": ("norm2", False), "norm1.bias": ("norm2_b", False),
    "wqkv.weight": ("qkv_w", True), "wqkv.bias": ("qkv_b", False),
    "wo.weight": ("proj_w", True), "wo.bias": ("proj_b", False),
    "mlp.fc0.weight": ("fc1_w", True), "mlp.fc0.bias": ("fc1_b", False),
    "mlp.fc1.weight": ("fc2_w", True), "mlp.fc1.bias": ("fc2_b", False),
}
_PROJECTOR = {  # under multi_modal_projector.
    "pre_norm.weight": ("ln_q", False), "pre_norm.bias": ("ln_q_b", False),
    "linear_1.weight": ("fc1_w", True), "linear_1.bias": ("fc1_b", False),
    "linear_2.weight": ("fc2_w", True), "linear_2.bias": ("fc2_b", False),
}
_ATTN = {  # under language_model.model.layers.{i}.
    "input_layernorm.weight": ("input_norm", False),
    "post_attention_layernorm.weight": ("post_norm", False),
    "self_attn.q_proj.weight": ("q_w", True),
    "self_attn.kv_a_proj_with_mqa.weight": ("kv_a_w", True),
    "self_attn.kv_a_layernorm.weight": ("kv_norm", False),
    "self_attn.kv_b_proj.weight": ("kv_b_w", True),
    "self_attn.o_proj.weight": ("o_w", True),
}
_DENSE = {"mlp.gate_proj.weight": "gate_w", "mlp.up_proj.weight": "up_w",
          "mlp.down_proj.weight": "down_w"}
_SHARED = {"mlp.shared_experts.gate_proj.weight": "gate_w",
           "mlp.shared_experts.up_proj.weight": "up_w",
           "mlp.shared_experts.down_proj.weight": "down_w"}
_EXPERT = ("gate_proj", "up_proj", "down_proj")


def is_moe_layer(cfg: KimiVLConfig, i: int) -> bool:
    return i >= cfg.text.first_k_dense_replace


def init(cfg: KimiVLConfig, seed: int, device) -> dict:
    """Random params: matrices normal(0, 0.02), norm weights 1, biases 0,
    the routers' correction bias normal(0, 0.02) in float32, in
    ``cfg.dtype``."""
    v, t = cfg.vision, cfg.text
    gen = torch.Generator(device=device).manual_seed(seed)

    def w(*shape, dtype=cfg.dtype):
        return (torch.randn(*shape, generator=gen, device=device) * 0.02).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.dtype, device=device)

    D, F = v.hidden_size, v.intermediate_size
    U = D * v.merge_unit

    def block():
        return {"norm1": ones(D), "norm1_b": zeros(D), "qkv_w": w(D, 3 * D),
                "qkv_b": zeros(3 * D), "proj_w": w(D, D), "proj_b": zeros(D),
                "norm2": ones(D), "norm2_b": zeros(D), "fc1_w": w(D, F), "fc1_b": zeros(F),
                "fc2_w": w(F, D), "fc2_b": zeros(D)}

    visual = {"patch_embed": w(v.patch_dim, D), "patch_embed_b": zeros(D),
              "pos_embed": w(v.pos_emb_height, v.pos_emb_width, D),
              "blocks": [block() for _ in range(v.depth)],
              "final_norm": ones(D), "final_norm_b": zeros(D),
              "merger": {"ln_q": ones(D), "ln_q_b": zeros(D), "fc1_w": w(U, U),
                         "fc1_b": zeros(U), "fc2_w": w(U, v.out_hidden_size),
                         "fc2_b": zeros(v.out_hidden_size)}}
    Dt, H = t.hidden_size, t.num_attention_heads

    def layer(i):
        lay = {"input_norm": ones(Dt), "q_w": w(Dt, H * t.qk_head_dim),
               "kv_a_w": w(Dt, t.latent_dim), "kv_norm": ones(t.kv_lora_rank),
               "kv_b_w": w(t.kv_lora_rank, H * (t.qk_nope_head_dim + t.v_head_dim)),
               "o_w": w(H * t.v_head_dim, Dt), "post_norm": ones(Dt)}
        if not is_moe_layer(cfg, i):
            Fd = t.intermediate_size
            lay.update(gate_w=w(Dt, Fd), up_w=w(Dt, Fd), down_w=w(Fd, Dt))
            return lay
        E, Fm = t.moe_num_experts, t.moe_intermediate_size
        Fs = Fm * t.moe_num_shared_experts
        lay.update(router=w(Dt, E), router_bias=w(E, dtype=torch.float32),
                   moe_fc1=w(E, Dt, 2 * Fm), moe_fc2=w(E, Fm, Dt),
                   gate_w=w(Dt, Fs), up_w=w(Dt, Fs), down_w=w(Fs, Dt))
        return lay

    text = {"embed_tokens": w(t.vocab_size, Dt),
            "layers": [layer(i) for i in range(t.num_hidden_layers)],
            "final_norm": ones(Dt), "lm_head": w(Dt, t.vocab_size)}
    return {"visual": visual, "text": text}


def from_hf_state_dict(named, cfg: KimiVLConfig, device) -> dict:
    """Param dict from (HF name, tensor) pairs of a Kimi-VL checkpoint. Each
    routed expert's gate/up/down projections are stacked into the layer's
    ``moe_fc1`` / ``moe_fc2``; the correction bias stays float32. A missing
    parameter raises ValueError."""
    v, t = cfg.vision, cfg.text
    visual: dict = {"blocks": [{} for _ in range(v.depth)], "merger": {}}
    text: dict = {"layers": [{} for _ in range(t.num_hidden_layers)]}
    experts: dict = {}  # (layer, expert, proj) -> tensor (out, in)

    def leaf(x, transpose=False, dtype=None):
        x = x.T if transpose else x
        return x.to(device=device, dtype=dtype or cfg.dtype).contiguous()

    for key, x in named:
        parts = key.split(".")
        if key == "language_model.model.embed_tokens.weight":
            text["embed_tokens"] = leaf(x)
        elif key == "language_model.model.norm.weight":
            text["final_norm"] = leaf(x)
        elif key == "language_model.lm_head.weight":
            text["lm_head"] = leaf(x, True)
        elif key.startswith("language_model.model.layers."):
            i, rest = int(parts[3]), ".".join(parts[4:])
            lay = text["layers"][i]
            if rest in _ATTN:
                name, tr = _ATTN[rest]
                lay[name] = leaf(x, tr)
            elif rest in _DENSE and not is_moe_layer(cfg, i):
                lay[_DENSE[rest]] = leaf(x, True)
            elif rest in _SHARED:
                lay[_SHARED[rest]] = leaf(x, True)
            elif rest == "mlp.gate.weight":
                lay["router"] = leaf(x, True)
            elif rest == "mlp.gate.e_score_correction_bias":
                lay["router_bias"] = leaf(x, dtype=torch.float32)
            elif rest.startswith("mlp.experts.") and parts[7] in _EXPERT:
                experts[(i, int(parts[6]), parts[7])] = x
        elif key == "vision_tower.patch_embed.proj.weight":  # Conv2d at full stride
            visual["patch_embed"] = leaf(x.reshape(x.shape[0], -1), True)
        elif key == "vision_tower.patch_embed.proj.bias":
            visual["patch_embed_b"] = leaf(x)
        elif key == "vision_tower.patch_embed.pos_emb.weight":
            visual["pos_embed"] = leaf(x)
        elif key == "vision_tower.encoder.final_layernorm.weight":
            visual["final_norm"] = leaf(x)
        elif key == "vision_tower.encoder.final_layernorm.bias":
            visual["final_norm_b"] = leaf(x)
        elif key.startswith("vision_tower.encoder.blocks.") and ".".join(parts[4:]) in _BLOCK:
            name, tr = _BLOCK[".".join(parts[4:])]
            visual["blocks"][int(parts[3])][name] = leaf(x, tr)
        elif key.startswith("multi_modal_projector.") and ".".join(parts[1:]) in _PROJECTOR:
            name, tr = _PROJECTOR[".".join(parts[1:])]
            visual["merger"][name] = leaf(x, tr)
    missing = []
    for i, lay in enumerate(text["layers"]):
        if not is_moe_layer(cfg, i):
            continue
        try:
            lay["moe_fc1"] = leaf(torch.stack([
                torch.cat([experts[(i, e, "gate_proj")].T, experts[(i, e, "up_proj")].T], 1)
                for e in range(t.moe_num_experts)]))
            lay["moe_fc2"] = leaf(torch.stack([experts[(i, e, "down_proj")].T
                                               for e in range(t.moe_num_experts)]))
        except KeyError as err:
            missing.append(f"text.layers[{i}] expert {err}")
    need = {"text": ("embed_tokens", "final_norm", "lm_head"),
            "visual": ("patch_embed", "patch_embed_b", "pos_embed", "final_norm",
                       "final_norm_b")}
    tree = {"text": text, "visual": visual}
    missing += [f"{k}.{n}" for k, names in need.items() for n in names if n not in tree[k]]
    missing += [f"visual.merger.{n}" for n, _ in _PROJECTOR.values()
                if n not in visual["merger"]]
    for i, b in enumerate(visual["blocks"]):
        missing += [f"visual.blocks[{i}].{n}" for n, _ in _BLOCK.values() if n not in b]
    for i, lay in enumerate(text["layers"]):
        names = [n for n, _ in _ATTN.values()] + ["gate_w", "up_w", "down_w"]
        if is_moe_layer(cfg, i):
            names += ["router", "router_bias"]
        missing += [f"text.layers[{i}].{n}" for n in names if n not in lay]
    if missing:
        raise ValueError(f"checkpoint is missing {len(missing)} parameters, e.g. {missing[:3]}")
    return tree


def hf_named_tensors(params: dict, cfg: KimiVLConfig):
    """(HF name, tensor) pairs of a param dict, the inverse of
    ``from_hf_state_dict`` (views; the caller copies)."""
    v, t = cfg.vision, cfg.text
    tx, vis = params["text"], params["visual"]
    yield "language_model.model.embed_tokens.weight", tx["embed_tokens"]
    yield "language_model.model.norm.weight", tx["final_norm"]
    yield "language_model.lm_head.weight", tx["lm_head"].T
    Fm = t.moe_intermediate_size
    for i, lay in enumerate(tx["layers"]):
        pre = f"language_model.model.layers.{i}."
        for suffix, (name, tr) in _ATTN.items():
            yield pre + suffix, lay[name].T if tr else lay[name]
        if not is_moe_layer(cfg, i):
            for suffix, name in _DENSE.items():
                yield pre + suffix, lay[name].T
            continue
        for suffix, name in _SHARED.items():
            yield pre + suffix, lay[name].T
        yield pre + "mlp.gate.weight", lay["router"].T
        yield pre + "mlp.gate.e_score_correction_bias", lay["router_bias"]
        for e in range(t.moe_num_experts):
            yield pre + f"mlp.experts.{e}.gate_proj.weight", lay["moe_fc1"][e, :, :Fm].T
            yield pre + f"mlp.experts.{e}.up_proj.weight", lay["moe_fc1"][e, :, Fm:].T
            yield pre + f"mlp.experts.{e}.down_proj.weight", lay["moe_fc2"][e].T
    pre = "vision_tower."
    yield pre + "patch_embed.proj.weight", vis["patch_embed"].T.reshape(
        v.hidden_size, v.in_channels, v.patch_size, v.patch_size)
    yield pre + "patch_embed.proj.bias", vis["patch_embed_b"]
    yield pre + "patch_embed.pos_emb.weight", vis["pos_embed"]
    yield pre + "encoder.final_layernorm.weight", vis["final_norm"]
    yield pre + "encoder.final_layernorm.bias", vis["final_norm_b"]
    for i, b in enumerate(vis["blocks"]):
        for suffix, (name, tr) in _BLOCK.items():
            yield f"{pre}encoder.blocks.{i}.{suffix}", b[name].T if tr else b[name]
    for suffix, (name, tr) in _PROJECTOR.items():
        m = vis["merger"][name]
        yield "multi_modal_projector." + suffix, m.T if tr else m


def load_pretrained(model_dir: str, device, cfg: KimiVLConfig | None = None
                    ) -> tuple[dict, KimiVLConfig]:
    """(params, cfg) from an HF Kimi-VL directory of safetensors shards."""
    from safetensors import safe_open

    if cfg is None:
        cfg = KimiVLConfig.from_pretrained(model_dir)
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


__all__ = ["init", "from_hf_state_dict", "hf_named_tensors", "load_pretrained", "is_moe_layer"]
