"""Parameter dict: random init on the device, import of the JAX package's
param tree, and import of an HF Qwen2.5-VL state dict (counterpart of
``open_o3_video_tpu/models/qwen25vl/params.py``).

Same tree as the JAX package, linear weights input-major (``x @ W``):

visual:
  patch_embed (patch_dim, D)
  blocks[i]: norm1, qkv_w, qkv_b, proj_w, proj_b, norm2,
             gate_w/b, up_w/b, down_w/b
  merger: ln_q, fc1_w/b, fc2_w/b
text:
  embed_tokens (vocab, D)
  layers[i]: input_norm, q_w/b, k_w/b, v_w/b, o_w, post_norm,
             gate_w, up_w, down_w
  final_norm, lm_head (D, vocab)
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Qwen25VLConfig


def from_jax_params(tree, cfg: Qwen25VLConfig, device) -> dict:
    """The JAX package's param tree, leaves as numpy arrays in JAX's
    (in, out) orientation, as the port's param dict in ``cfg.dtype``."""

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device=device, dtype=cfg.dtype)

    return conv(tree)


def to_jax_layout(tree):
    """Inverse of :func:`from_jax_params`: a param (or gradient) dict of the
    port as the JAX package's tree, leaves float32 numpy arrays in JAX's
    (in, out) orientation, so the two can be compared leaf by leaf. Each
    leaf is a copy: a later in-place update does not change it."""
    if isinstance(tree, dict):
        return {k: to_jax_layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_jax_layout(v) for v in tree]
    return tree.detach().to(device="cpu", dtype=torch.float32, copy=True).numpy()


def leaves(tree) -> list:
    """The tensors of a param dict, in a fixed (depth-first, key) order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def trainable(tree) -> dict:
    """Mark every floating-point leaf as requiring a gradient (a full fine-
    tune); returns the same dict."""
    for x in leaves(tree):
        if x.is_floating_point():
            x.requires_grad_(True)
    return tree


def init(cfg: Qwen25VLConfig, seed: int, device) -> dict:
    """Random normal(0.02) weights (the HF initializer scale), unit norms and
    zero biases, drawn on ``device`` from a seeded ``torch.Generator`` in
    ``cfg.dtype``. It does not reproduce the JAX package's random bits."""
    v, t = cfg.vision, cfg.text
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def w(*shape):
        return torch.empty(shape, dtype=cfg.dtype, device=device).normal_(0.0, 0.02, generator=gen)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.dtype, device=device)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=device)

    def block():
        return {
            "norm1": ones(v.hidden_size),
            "qkv_w": w(v.hidden_size, 3 * v.hidden_size),
            "qkv_b": zeros(3 * v.hidden_size),
            "proj_w": w(v.hidden_size, v.hidden_size),
            "proj_b": zeros(v.hidden_size),
            "norm2": ones(v.hidden_size),
            "gate_w": w(v.hidden_size, v.intermediate_size),
            "gate_b": zeros(v.intermediate_size),
            "up_w": w(v.hidden_size, v.intermediate_size),
            "up_b": zeros(v.intermediate_size),
            "down_w": w(v.intermediate_size, v.hidden_size),
            "down_b": zeros(v.hidden_size),
        }

    merged = v.hidden_size * v.merge_unit
    visual = {
        "patch_embed": w(v.patch_dim, v.hidden_size),
        "blocks": [block() for _ in range(v.depth)],
        "merger": {
            "ln_q": ones(v.hidden_size),
            "fc1_w": w(merged, merged),
            "fc1_b": zeros(merged),
            "fc2_w": w(merged, v.out_hidden_size),
            "fc2_b": zeros(v.out_hidden_size),
        },
    }
    q_dim = t.num_attention_heads * t.head_dim
    kv_dim = t.num_key_value_heads * t.head_dim
    layers = [
        {
            "input_norm": ones(t.hidden_size),
            "q_w": w(t.hidden_size, q_dim),
            "q_b": zeros(q_dim),
            "k_w": w(t.hidden_size, kv_dim),
            "k_b": zeros(kv_dim),
            "v_w": w(t.hidden_size, kv_dim),
            "v_b": zeros(kv_dim),
            "o_w": w(q_dim, t.hidden_size),
            "post_norm": ones(t.hidden_size),
            "gate_w": w(t.hidden_size, t.intermediate_size),
            "up_w": w(t.hidden_size, t.intermediate_size),
            "down_w": w(t.intermediate_size, t.hidden_size),
        }
        for _ in range(t.num_hidden_layers)
    ]
    text = {
        "embed_tokens": w(t.vocab_size, t.hidden_size),
        "layers": layers,
        "final_norm": ones(t.hidden_size),
        "lm_head": w(t.hidden_size, t.vocab_size),
    }
    return {"visual": visual, "text": text}


_TEXT_LAYER = {  # HF suffix -> (leaf, transpose to input-major)
    "input_layernorm.weight": ("input_norm", False),
    "post_attention_layernorm.weight": ("post_norm", False),
    "self_attn.q_proj.weight": ("q_w", True),
    "self_attn.q_proj.bias": ("q_b", False),
    "self_attn.k_proj.weight": ("k_w", True),
    "self_attn.k_proj.bias": ("k_b", False),
    "self_attn.v_proj.weight": ("v_w", True),
    "self_attn.v_proj.bias": ("v_b", False),
    "self_attn.o_proj.weight": ("o_w", True),
    "mlp.gate_proj.weight": ("gate_w", True),
    "mlp.up_proj.weight": ("up_w", True),
    "mlp.down_proj.weight": ("down_w", True),
}
_VISION_BLOCK = {
    "norm1.weight": ("norm1", False),
    "norm2.weight": ("norm2", False),
    "attn.qkv.weight": ("qkv_w", True),
    "attn.qkv.bias": ("qkv_b", False),
    "attn.proj.weight": ("proj_w", True),
    "attn.proj.bias": ("proj_b", False),
    "mlp.gate_proj.weight": ("gate_w", True),
    "mlp.gate_proj.bias": ("gate_b", False),
    "mlp.up_proj.weight": ("up_w", True),
    "mlp.up_proj.bias": ("up_b", False),
    "mlp.down_proj.weight": ("down_w", True),
    "mlp.down_proj.bias": ("down_b", False),
}
_MERGER = {
    "ln_q.weight": ("ln_q", False),
    "mlp.0.weight": ("fc1_w", True),
    "mlp.0.bias": ("fc1_b", False),
    "mlp.2.weight": ("fc2_w", True),
    "mlp.2.bias": ("fc2_b", False),
}


def from_hf_state_dict(named, cfg: Qwen25VLConfig, device) -> dict:
    """Param dict from (HF name, tensor) pairs of a Qwen2.5-VL checkpoint
    (``model.`` / ``model.language_model.`` / ``model.visual.`` prefixes
    alike); a missing ``lm_head`` ties to the embedding."""
    v, t = cfg.vision, cfg.text
    visual = {"blocks": [{} for _ in range(v.depth)], "merger": {}}
    text = {"layers": [{} for _ in range(t.num_hidden_layers)]}

    def leaf(x, transpose=False):
        x = x.T if transpose else x
        return x.to(device=device, dtype=cfg.dtype).contiguous()

    for key, x in named:
        for old, new in (("model.language_model.", "language_model."),
                         ("model.visual.", "visual."), ("model.", "language_model.")):
            if key.startswith(old):
                key = new + key[len(old):]
                break
        parts = key.split(".")
        if key == "language_model.embed_tokens.weight":
            text["embed_tokens"] = leaf(x)
        elif key == "language_model.norm.weight":
            text["final_norm"] = leaf(x)
        elif key == "lm_head.weight":
            text["lm_head"] = leaf(x, True)
        elif key.startswith("language_model.layers.") and ".".join(parts[3:]) in _TEXT_LAYER:
            name, tr = _TEXT_LAYER[".".join(parts[3:])]
            text["layers"][int(parts[2])][name] = leaf(x, tr)
        elif key == "visual.patch_embed.proj.weight":  # Conv3d at full stride == linear
            visual["patch_embed"] = leaf(x.reshape(x.shape[0], -1), True)
        elif key.startswith("visual.blocks.") and ".".join(parts[3:]) in _VISION_BLOCK:
            name, tr = _VISION_BLOCK[".".join(parts[3:])]
            visual["blocks"][int(parts[2])][name] = leaf(x, tr)
        elif key.startswith("visual.merger.") and ".".join(parts[2:]) in _MERGER:
            name, tr = _MERGER[".".join(parts[2:])]
            visual["merger"][name] = leaf(x, tr)
    if "lm_head" not in text and "embed_tokens" in text:
        text["lm_head"] = text["embed_tokens"].T.contiguous()
    missing = [k for k in ("patch_embed",) if k not in visual]
    missing += [f"text.{k}" for k in ("embed_tokens", "final_norm", "lm_head") if k not in text]
    for where, tables, names in (("visual.blocks", visual["blocks"], _VISION_BLOCK),
                                 ("text.layers", text["layers"], _TEXT_LAYER),
                                 ("visual.merger", [visual["merger"]], _MERGER)):
        for i, got in enumerate(tables):
            missing += [f"{where}[{i}].{n}" for n, _ in names.values() if n not in got]
    if missing:
        raise ValueError(f"checkpoint is missing {len(missing)} parameters, e.g. {missing[:3]}")
    return {"visual": visual, "text": text}


def count(params) -> int:
    """Number of parameters in a param dict."""
    if isinstance(params, dict):
        return sum(count(x) for x in params.values())
    if isinstance(params, list):
        return sum(count(x) for x in params)
    return params.numel()
