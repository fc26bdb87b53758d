"""Parameter dict: random init on the device, import of the JAX package's
param tree, and import of an HF Qwen2.5-VL state dict (counterpart of
``open_o3_video_tpu/models/qwen25vl/params.py``).

Same tree as the JAX package, linear weights input-major (``x @ W``):

visual:
  patch_embed (patch_dim, D), patch_embed_b and pos_embed (Qwen3-VL)
  blocks[i]: norm1, qkv_w, qkv_b, proj_w, proj_b, norm2,
             gate_w/b, up_w/b, down_w/b (Qwen2.5-VL) or fc1_w/b, fc2_w/b
             (Qwen2-VL, Qwen3-VL), norm1_b, norm2_b (LayerNorm families)
  merger: ln_q (ln_q_b), fc1_w/b, fc2_w/b
  deepstack[j] (Qwen3-VL): a merger normed after the concat
text:
  embed_tokens (vocab, D)
  layers[i]: input_norm, q_w, k_w, v_w, o_w (q_b, k_b, v_b where the
             config has attention biases; q_norm, k_norm for Qwen3-VL),
             post_norm, gate_w, up_w, down_w, or for Qwen3-VL-MoE router
             (D, E), moe_fc1 (E, D, 2F), moe_fc2 (E, F, D)
  final_norm, lm_head (D, vocab)

With ``quantize_text`` the decoder's matmul weights and the lm_head are
``ops.quant.QuantizedLinear`` (int8) or ``ops.int4.Int4Linear`` leaves,
quantized one leaf at a time as they are drawn or read, so the model never
exists in bf16 on the device; ``quantize_vision`` does the same for the ViT
blocks' matmul weights (the w8a8 tower's), never the patch embed or the
merger. The router and the expert stacks stay in ``cfg.dtype``, as in the
JAX package. A text-only checkpoint (the Qwen2.5-72B judge) loads with
``visual`` None.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ...ops.int4 import Int4Linear, quantize_weight_int4
from ...ops.quant import (
    QUANTIZED,
    LoraLinear,
    QuantizedLinear,
    map_with_path,
    quantize_weight,
    stored_tensors,
)
from .config import Qwen25VLConfig

# The decoder leaves quantize_text quantizes (JAX's _QUANT_TEXT_LEAVES).
QUANT_TEXT_LEAVES = frozenset({"q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w", "lm_head"})
# The ViT block leaves quantize_vision quantizes (JAX's _QUANT_VISION_LEAVES).
QUANT_VISION_LEAVES = frozenset({"qkv_w", "proj_w", "fc1_w", "fc2_w", "gate_w", "up_w", "down_w"})


def quantize_leaf(leaf: torch.Tensor, mode):
    """int8 or int4 quantization of one (in, out) matmul weight, as JAX's
    ``_quantize_leaf``: ``mode`` True or "int8" gives per-channel int8;
    "int4" gives group-128 packed int4 where the in-dim divides 128, and
    int8 where it does not. The caller drops the unquantized leaf."""
    if mode not in (True, "int8", "int4"):
        raise ValueError(f"quantize mode must be True, 'int8' or 'int4', got {mode!r}")
    if mode == "int4" and leaf.shape[0] % 128 == 0:
        return quantize_weight_int4(leaf, group=128)
    return quantize_weight(leaf)


def from_jax_params(tree, cfg: Qwen25VLConfig, device, quantize_vision=False) -> dict:
    """The JAX package's param tree, leaves as numpy arrays in JAX's
    (in, out) orientation, as the port's param dict in ``cfg.dtype``. JAX's
    quantized leaves, recognised by their fields (``w_p``/``scale``/``group``
    for int4, ``w_q``/``scale`` for int8), keep their int8 bytes and float32
    scales; its ``LoraLinear`` leaves (``base``/``a``/``b``/``scale``) become
    the port's, their adapters in ``cfg.dtype``. ``quantize_vision``
    quantizes the ViT blocks' plain matmul weights as they are carried
    (``quantize_leaf``)."""

    def tensor(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(device)

    def conv(x, path=()):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v, path + (k,)) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v, path + (i,)) for i, v in enumerate(x)]
        if (quantize_vision and path[:2] == ("visual", "blocks")
                and path[-1] in QUANT_VISION_LEAVES and not hasattr(x, "scale")):
            return quantize_leaf(tensor(x, np.float32).to(cfg.dtype), quantize_vision)
        if hasattr(x, "w_p"):
            return Int4Linear(tensor(x.w_p, np.int8), tensor(x.scale, np.float32), x.group)
        if hasattr(x, "w_q"):
            return QuantizedLinear(tensor(x.w_q, np.int8), tensor(x.scale, np.float32))
        if hasattr(x, "base") and hasattr(x, "a"):  # (a numpy array has .base too)
            return LoraLinear(conv(x.base), conv(x.a), conv(x.b), float(np.asarray(x.scale)))
        return tensor(x, np.float32).to(cfg.dtype)

    return conv(tree)


def adapters_from_jax(tree, device, dtype=torch.float32) -> dict:
    """The JAX package's adapter tree (``train/lora.py:init_adapters``),
    leaves as numpy arrays, as the port's adapters in ``dtype``, trainable."""
    return {"layers": [
        {name: {k: torch.from_numpy(np.array(ab[k], dtype=np.float32)).to(device, dtype)
                .requires_grad_(True) for k in ("a", "b")}
         for name, ab in layer.items()}
        for layer in tree["layers"]
    ]}


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
    """The tensors of a param dict, in a fixed (depth-first, key) order; a
    quantized weight contributes its packed tensor and its scale."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return list(stored_tensors(tree))


def trainable(tree) -> dict:
    """Mark every floating-point tensor leaf as requiring a gradient (a full
    fine-tune); quantized weights stay frozen (K7 has no backward). Returns
    the same dict."""

    def mark(_, x):
        if getattr(x, "kind", None) == "tensor":  # a plain weight's shard on a mesh
            x = x.parts["w"]
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            x.requires_grad_(True)

    map_with_path(mark, tree)
    return tree


def init(cfg: Qwen25VLConfig, seed: int, device, quantize_text=False,
         quantize_vision=False) -> dict:
    """Random normal(0.02) weights (the HF initializer scale), unit norms and
    zero biases, drawn on ``device`` from a seeded ``torch.Generator`` in
    ``cfg.dtype``. It does not reproduce the JAX package's random bits.

    ``quantize_text`` (False, True or "int8", "int4") quantizes each decoder
    matmul weight and the lm_head as it is drawn (``quantize_leaf``), so the
    bf16 draw of one leaf at a time is all that exists: a 72B decoder never
    exists in bf16. ``quantize_vision`` (the same values) quantizes the ViT
    blocks' matmul weights so. The random draws are the same as without
    either."""
    v, t = cfg.vision, cfg.text
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def w(*shape):
        return torch.empty(shape, dtype=cfg.dtype, device=device).normal_(0.0, 0.02, generator=gen)

    def tw(*shape):
        return quantize_leaf(w(*shape), quantize_text) if quantize_text else w(*shape)

    def vw(*shape):
        return quantize_leaf(w(*shape), quantize_vision) if quantize_vision else w(*shape)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.dtype, device=device)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=device)

    def block():
        b = {
            "norm1": ones(v.hidden_size),
            "qkv_w": vw(v.hidden_size, 3 * v.hidden_size),
            "qkv_b": zeros(3 * v.hidden_size),
            "proj_w": vw(v.hidden_size, v.hidden_size),
            "proj_b": zeros(v.hidden_size),
            "norm2": ones(v.hidden_size),
        }
        if v.act_type == "swiglu":
            b.update(gate_w=vw(v.hidden_size, v.intermediate_size),
                     gate_b=zeros(v.intermediate_size),
                     up_w=vw(v.hidden_size, v.intermediate_size),
                     up_b=zeros(v.intermediate_size),
                     down_w=vw(v.intermediate_size, v.hidden_size),
                     down_b=zeros(v.hidden_size))
        else:
            b.update(fc1_w=vw(v.hidden_size, v.intermediate_size),
                     fc1_b=zeros(v.intermediate_size),
                     fc2_w=vw(v.intermediate_size, v.hidden_size),
                     fc2_b=zeros(v.hidden_size))
        if v.norm_type == "layernorm":
            b.update(norm1_b=zeros(v.hidden_size), norm2_b=zeros(v.hidden_size))
        return b

    merged = v.hidden_size * v.merge_unit

    def merger(postshuffle=False):
        norm = merged if postshuffle else v.hidden_size
        m = {"ln_q": ones(norm), "fc1_w": w(merged, merged), "fc1_b": zeros(merged),
             "fc2_w": w(merged, v.out_hidden_size), "fc2_b": zeros(v.out_hidden_size)}
        if v.norm_type == "layernorm":
            m["ln_q_b"] = zeros(norm)
        return m

    visual = {
        "patch_embed": w(v.patch_dim, v.hidden_size),
        "blocks": [block() for _ in range(v.depth)],
        "merger": merger(),
    }
    if v.patch_embed_bias:
        visual["patch_embed_b"] = zeros(v.hidden_size)
    if v.num_position_embeddings:
        visual["pos_embed"] = w(v.num_position_embeddings, v.hidden_size)
    if v.deepstack_visual_indexes:
        visual["deepstack"] = [merger(postshuffle=True) for _ in v.deepstack_visual_indexes]
    q_dim = t.num_attention_heads * t.head_dim
    kv_dim = t.num_key_value_heads * t.head_dim
    moe_f = t.moe_intermediate_size or t.intermediate_size

    def layer():
        lay = {
            "input_norm": ones(t.hidden_size),
            "q_w": tw(t.hidden_size, q_dim),
            "q_b": zeros(q_dim),
            "k_w": tw(t.hidden_size, kv_dim),
            "k_b": zeros(kv_dim),
            "v_w": tw(t.hidden_size, kv_dim),
            "v_b": zeros(kv_dim),
            "o_w": tw(q_dim, t.hidden_size),
            "post_norm": ones(t.hidden_size),
        }
        if t.moe_num_experts:  # Qwen3-VL-MoE: routed experts only
            lay.update(router=w(t.hidden_size, t.moe_num_experts),
                       moe_fc1=w(t.moe_num_experts, t.hidden_size, 2 * moe_f),
                       moe_fc2=w(t.moe_num_experts, moe_f, t.hidden_size))
        else:
            lay.update(gate_w=tw(t.hidden_size, t.intermediate_size),
                       up_w=tw(t.hidden_size, t.intermediate_size),
                       down_w=tw(t.intermediate_size, t.hidden_size))
        if not t.attention_bias:  # Qwen3-VL
            lay = {k: x for k, x in lay.items() if k not in ("q_b", "k_b", "v_b")}
        if t.use_qk_norm:
            lay.update(q_norm=ones(t.head_dim), k_norm=ones(t.head_dim))
        return lay

    layers = [layer() for _ in range(t.num_hidden_layers)]
    text = {
        "embed_tokens": w(t.vocab_size, t.hidden_size),
        "layers": layers,
        "final_norm": ones(t.hidden_size),
        "lm_head": tw(t.hidden_size, t.vocab_size),
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
    "self_attn.q_norm.weight": ("q_norm", False),  # Qwen3: per-head q/k RMSNorm
    "self_attn.k_norm.weight": ("k_norm", False),
    "self_attn.o_proj.weight": ("o_w", True),
    "mlp.gate_proj.weight": ("gate_w", True),
    "mlp.up_proj.weight": ("up_w", True),
    "mlp.down_proj.weight": ("down_w", True),
    # Qwen3-VL-MoE's sparse block: the expert stacks are bare parameters,
    # (E, D, 2F) and (E, F, D), already input-major
    "mlp.gate.weight": ("router", True),
    "mlp.experts.gate_up_proj": ("moe_fc1", False),
    "mlp.experts.down_proj": ("moe_fc2", False),
}
_VISION_ATTN = {
    "norm1.weight": ("norm1", False),
    "norm2.weight": ("norm2", False),
    "norm1.bias": ("norm1_b", False),  # LayerNorm families
    "norm2.bias": ("norm2_b", False),
    "attn.qkv.weight": ("qkv_w", True),
    "attn.qkv.bias": ("qkv_b", False),
    "attn.proj.weight": ("proj_w", True),
    "attn.proj.bias": ("proj_b", False),
}
_VISION_MLP = {  # act_type -> HF suffix -> leaf
    "swiglu": {
        "mlp.gate_proj.weight": ("gate_w", True),
        "mlp.gate_proj.bias": ("gate_b", False),
        "mlp.up_proj.weight": ("up_w", True),
        "mlp.up_proj.bias": ("up_b", False),
        "mlp.down_proj.weight": ("down_w", True),
        "mlp.down_proj.bias": ("down_b", False),
    },
    "quickgelu": {  # Qwen2-VL's VisionMlp
        "mlp.fc1.weight": ("fc1_w", True),
        "mlp.fc1.bias": ("fc1_b", False),
        "mlp.fc2.weight": ("fc2_w", True),
        "mlp.fc2.bias": ("fc2_b", False),
    },
    "gelu_tanh": {  # Qwen3-VL's VisionMLP
        "mlp.linear_fc1.weight": ("fc1_w", True),
        "mlp.linear_fc1.bias": ("fc1_b", False),
        "mlp.linear_fc2.weight": ("fc2_w", True),
        "mlp.linear_fc2.bias": ("fc2_b", False),
    },
}
_MERGER = {
    "ln_q.weight": ("ln_q", False),
    "ln_q.bias": ("ln_q_b", False),  # Qwen2-VL's LayerNorm
    "mlp.0.weight": ("fc1_w", True),
    "mlp.0.bias": ("fc1_b", False),
    "mlp.2.weight": ("fc2_w", True),
    "mlp.2.bias": ("fc2_b", False),
}
_MERGER_QWEN3 = {  # the main merger and each deepstack merger
    "norm.weight": ("ln_q", False),
    "norm.bias": ("ln_q_b", False),
    "linear_fc1.weight": ("fc1_w", True),
    "linear_fc1.bias": ("fc1_b", False),
    "linear_fc2.weight": ("fc2_w", True),
    "linear_fc2.bias": ("fc2_b", False),
}


def _names(cfg: Qwen25VLConfig) -> tuple[dict, dict, dict]:
    """The HF suffix -> leaf maps of this family's decoder layer, vision
    block and merger, holding exactly the leaves ``init`` makes."""
    v, t = cfg.vision, cfg.text
    drop = set()
    if not t.attention_bias:
        drop |= {"q_b", "k_b", "v_b"}
    if not t.use_qk_norm:
        drop |= {"q_norm", "k_norm"}
    drop |= ({"gate_w", "up_w", "down_w"} if t.moe_num_experts
             else {"router", "moe_fc1", "moe_fc2"})
    if v.norm_type != "layernorm":
        drop |= {"norm1_b", "norm2_b", "ln_q_b"}
    layer = {k: x for k, x in _TEXT_LAYER.items() if x[0] not in drop}
    block = {k: x for k, x in {**_VISION_ATTN, **_VISION_MLP[v.act_type]}.items()
             if x[0] not in drop}
    merger = _MERGER_QWEN3 if v.deepstack_visual_indexes else _MERGER
    return layer, block, {k: x for k, x in merger.items() if x[0] not in drop}


def from_hf_state_dict(named, cfg: Qwen25VLConfig, device, quantize_text=False,
                       quantize_vision=False) -> dict:
    """Param dict from (HF name, tensor) pairs of a checkpoint of the
    config's family (``model.`` / ``model.language_model.`` /
    ``model.visual.`` prefixes alike), or of a text-only Qwen2 one
    (``visual`` is then None); a missing ``lm_head`` ties to the embedding.
    ``quantize_text`` quantizes each decoder matmul weight and the lm_head
    as it streams in (JAX's ``from_named_arrays``), so only one leaf at a
    time exists in bf16; ``quantize_vision`` quantizes the ViT blocks'
    matmul weights so."""
    v, t = cfg.vision, cfg.text
    text_names, block_names, merger_names = _names(cfg)
    visual = {"blocks": [{} for _ in range(v.depth)], "merger": {}}
    if v.deepstack_visual_indexes:
        visual["deepstack"] = [{} for _ in v.deepstack_visual_indexes]
    text = {"layers": [{} for _ in range(t.num_hidden_layers)]}
    seen_visual = False

    def leaf(x, transpose=False, mode=None):
        x = x.T if transpose else x
        x = x.to(device=device, dtype=cfg.dtype).contiguous()
        return quantize_leaf(x, mode) if mode else x

    for key, x in named:
        for old, new in (("model.language_model.", "language_model."),
                         ("model.visual.", "visual."), ("model.", "language_model.")):
            if key.startswith(old):
                key = new + key[len(old):]
                break
        parts = key.split(".")
        seen_visual = seen_visual or key.startswith("visual.")
        if key == "language_model.embed_tokens.weight":
            text["embed_tokens"] = leaf(x)
        elif key == "language_model.norm.weight":
            text["final_norm"] = leaf(x)
        elif key == "lm_head.weight":
            text["lm_head"] = leaf(x, True, mode=quantize_text)
        elif key.startswith("language_model.layers.") and ".".join(parts[3:]) in text_names:
            name, tr = text_names[".".join(parts[3:])]
            text["layers"][int(parts[2])][name] = leaf(
                x, tr, mode=quantize_text if name in QUANT_TEXT_LEAVES else None)
        elif key == "visual.patch_embed.proj.weight":  # Conv3d at full stride == linear
            visual["patch_embed"] = leaf(x.reshape(x.shape[0], -1), True)
        elif key == "visual.patch_embed.proj.bias" and v.patch_embed_bias:
            visual["patch_embed_b"] = leaf(x)
        elif key == "visual.pos_embed.weight" and v.num_position_embeddings:
            visual["pos_embed"] = leaf(x)
        elif key.startswith("visual.blocks.") and ".".join(parts[3:]) in block_names:
            name, tr = block_names[".".join(parts[3:])]
            visual["blocks"][int(parts[2])][name] = leaf(
                x, tr, mode=quantize_vision if name in QUANT_VISION_LEAVES else None)
        elif key.startswith("visual.merger.") and ".".join(parts[2:]) in merger_names:
            name, tr = merger_names[".".join(parts[2:])]
            visual["merger"][name] = leaf(x, tr)
        elif (key.startswith("visual.deepstack_merger_list.") and "deepstack" in visual
              and ".".join(parts[3:]) in _MERGER_QWEN3):
            name, tr = _MERGER_QWEN3[".".join(parts[3:])]
            visual["deepstack"][int(parts[2])][name] = leaf(x, tr)
    if "lm_head" not in text and "embed_tokens" in text:
        text["lm_head"] = leaf(text["embed_tokens"], True, mode=quantize_text)
    missing = [f"text.{k}" for k in ("embed_tokens", "final_norm", "lm_head") if k not in text]
    tables = [("text.layers", text["layers"], text_names)]
    if seen_visual:
        tops = ["patch_embed"] + ["patch_embed_b"] * v.patch_embed_bias + (
            ["pos_embed"] if v.num_position_embeddings else [])
        missing += [f"visual.{k}" for k in tops if k not in visual]
        tables += [("visual.blocks", visual["blocks"], block_names),
                   ("visual.merger", [visual["merger"]], merger_names),
                   ("visual.deepstack", visual.get("deepstack", []), _MERGER_QWEN3)]
    for where, rows, names in tables:
        for i, got in enumerate(rows):
            missing += [f"{where}[{i}].{n}" for n, _ in names.values() if n not in got]
    if missing:
        raise ValueError(f"checkpoint is missing {len(missing)} parameters, e.g. {missing[:3]}")
    return {"visual": visual if seen_visual else None, "text": text}


def load_pretrained(model_dir: str, device, cfg: Qwen25VLConfig | None = None,
                    quantize_text=False, quantize_vision=False) -> tuple[dict, Qwen25VLConfig]:
    """(params, cfg) from an HF model directory of safetensors shards (in
    the index file's order when there is one), read with safetensors' torch
    loader and quantized as they stream in (see ``from_hf_state_dict``)."""
    from safetensors import safe_open

    if cfg is None:
        cfg = Qwen25VLConfig.from_pretrained(model_dir)
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

    return from_hf_state_dict(named(), cfg, device, quantize_text=quantize_text,
                              quantize_vision=quantize_vision), cfg


def hf_named_tensors(params: dict, cfg: Qwen25VLConfig):
    """(HF name, tensor) pairs of a plain param dict, in the HF layout of
    the config's family (output-major matmul weights, the patch embedding
    as its Conv3d), the names of the JAX package's ``save_safetensors``.
    The inverse of ``from_hf_state_dict``; tensors are views, copied by the
    caller."""
    text_names, block_names, merger_names = _names(cfg)
    t = params["text"]
    yield "model.embed_tokens.weight", t["embed_tokens"]
    yield "model.norm.weight", t["final_norm"]
    yield "lm_head.weight", t["lm_head"].T
    for i, layer in enumerate(t["layers"]):
        for suffix, (name, tr) in text_names.items():
            yield f"model.layers.{i}.{suffix}", layer[name].T if tr else layer[name]
    vis = params.get("visual")
    if vis is None:
        return
    v = cfg.vision
    yield "visual.patch_embed.proj.weight", vis["patch_embed"].T.reshape(
        v.hidden_size, v.in_channels, v.temporal_patch_size, v.patch_size, v.patch_size)
    if v.patch_embed_bias:
        yield "visual.patch_embed.proj.bias", vis["patch_embed_b"]
    if v.num_position_embeddings:
        yield "visual.pos_embed.weight", vis["pos_embed"]
    for i, block in enumerate(vis["blocks"]):
        for suffix, (name, tr) in block_names.items():
            yield f"visual.blocks.{i}.{suffix}", block[name].T if tr else block[name]
    mergers = [("visual.merger.", vis["merger"], merger_names)] + [
        (f"visual.deepstack_merger_list.{j}.", m, _MERGER_QWEN3)
        for j, m in enumerate(vis.get("deepstack", []))]
    for prefix, m, names in mergers:
        for suffix, (name, tr) in names.items():
            yield prefix + suffix, m[name].T if tr else m[name]


_SAFETENSORS_DTYPES = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16"}


def save_safetensors(params: dict, cfg: Qwen25VLConfig, out_path: str, dtype=None) -> None:
    """Write a plain param dict as one HF-convention safetensors file
    (``write_safetensors``). Each tensor keeps its dtype unless ``dtype`` is
    given (the JAX package's export writes float32)."""
    write_safetensors(list(hf_named_tensors(params, cfg)), out_path, dtype)


def write_safetensors(tensors: list, out_path: str, dtype=None) -> None:
    """Write (name, tensor) pairs as one safetensors file, in the format
    itself (no ``safetensors`` package): an 8-byte little-endian header
    length, the JSON header (name -> dtype, shape, byte offsets), padded
    with spaces to 8 bytes, then each tensor's raw little-endian bytes, in
    ``dtype`` where given. One tensor at a time is copied to the host."""
    header, offset = {}, 0
    for name, x in tensors:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}: export needs plain tensors (merge or dequantize first)")
        out_dtype = dtype or x.dtype
        n = x.numel() * torch.finfo(out_dtype).bits // 8
        header[name] = {"dtype": _SAFETENSORS_DTYPES[out_dtype], "shape": list(x.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(out_path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for _, x in tensors:
            x = x.detach().to(device="cpu", dtype=dtype or x.dtype).contiguous()
            f.write(x.view(torch.uint8).numpy().tobytes())


def count(params) -> int:
    """Number of parameters in a param dict (a quantized weight counts the
    entries of the matrix it stands for)."""
    if params is None:
        return 0
    if isinstance(params, dict):
        return sum(count(x) for x in params.values())
    if isinstance(params, list):
        return sum(count(x) for x in params)
    if isinstance(params, QUANTIZED):
        return int(np.prod(params.shape))
    return params.numel()
