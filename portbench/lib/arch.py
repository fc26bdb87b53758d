"""A model's shapes, read from its published ``config.json`` (the file a
configuration of ``BENCHMARK.json`` names), without the program.

Two families are read: Qwen2.5-VL (``model_type`` "qwen2_5_vl": a windowed
RMSNorm/SwiGLU tower, a decoder with q/k/v biases and sectioned M-RoPE) and
Qwen3-VL-MoE ("qwen3_vl_moe": a LayerNorm/GELU tower over whole frames with
a learned position table and deepstack taps, a decoder with per-head q/k
norms, interleaved M-RoPE and routed experts in every layer). The weight
maker, the operation counts and the plain reference all read this.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

FAMILIES = ("qwen2_5_vl", "qwen3_vl_moe")


@dataclasses.dataclass(frozen=True)
class Vision:
    depth: int
    hidden: int
    inter: int
    heads: int
    patch: int
    merge: int
    temporal_patch: int
    out_hidden: int
    act: str  # "swiglu" or "gelu_tanh"
    norm: str  # "rms" or "ln"
    window_size: int  # 0: no windows
    fullatt: tuple
    pos_embeds: int  # learned position table entries (0: none)
    deepstack: tuple
    patch_bias: bool

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def patch_dim(self) -> int:
        return 3 * self.temporal_patch * self.patch ** 2

    @property
    def unit(self) -> int:
        return self.merge ** 2


@dataclasses.dataclass(frozen=True)
class Text:
    vocab: int
    hidden: int
    inter: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    eps: float
    theta: float
    mrope_section: tuple
    interleaved: bool
    attn_bias: bool
    qk_norm: bool
    experts: int
    topk: int
    moe_inter: int


@dataclasses.dataclass(frozen=True)
class Arch:
    family: str
    vision: Vision
    text: Text
    image_token: int
    video_token: int
    vision_start: int
    vision_end: int
    eos: int
    pad: int


def read_arch(d: dict) -> Arch:
    """The shapes of a published config dict of either family."""
    family = d.get("model_type")
    if family not in FAMILIES:
        raise ValueError(f"model_type {family!r} is not one of {FAMILIES}")
    v = d["vision_config"]
    t = d.get("text_config", d)
    rope = t.get("rope_scaling") or d.get("rope_scaling") or {}
    qwen3 = family == "qwen3_vl_moe"
    vision = Vision(
        depth=v["depth"], hidden=v["hidden_size"], inter=v["intermediate_size"],
        heads=v["num_heads"], patch=v["patch_size"], merge=v["spatial_merge_size"],
        temporal_patch=v["temporal_patch_size"], out_hidden=v["out_hidden_size"],
        act="gelu_tanh" if qwen3 else "swiglu", norm="ln" if qwen3 else "rms",
        window_size=0 if qwen3 else v["window_size"],
        fullatt=tuple(v.get("fullatt_block_indexes", ())),
        pos_embeds=v.get("num_position_embeddings", 0) if qwen3 else 0,
        deepstack=tuple(v.get("deepstack_visual_indexes", ())) if qwen3 else (),
        patch_bias=qwen3)
    heads = t["num_attention_heads"]
    text = Text(
        vocab=t["vocab_size"], hidden=t["hidden_size"], inter=t["intermediate_size"],
        layers=t["num_hidden_layers"], heads=heads, kv_heads=t["num_key_value_heads"],
        head_dim=t.get("head_dim") or t["hidden_size"] // heads, eps=t["rms_norm_eps"],
        theta=float(t["rope_theta"]), mrope_section=tuple(rope["mrope_section"]),
        interleaved=bool(rope.get("mrope_interleaved", False)),
        attn_bias=bool(t.get("attention_bias", not qwen3)), qk_norm=qwen3,
        experts=t.get("num_experts", 0) if qwen3 else 0,
        topk=t.get("num_experts_per_tok", 0) if qwen3 else 0,
        moe_inter=t.get("moe_intermediate_size", 0) if qwen3 else 0)
    eos = t.get("eos_token_id", d.get("eos_token_id", 151645))
    pad: Optional[int] = d.get("pad_token_id")
    return Arch(family=family, vision=vision, text=text,
                image_token=d.get("image_token_id", 151655),
                video_token=d.get("video_token_id", 151656),
                vision_start=d.get("vision_start_token_id", 151652),
                vision_end=d.get("vision_end_token_id", 151653),
                eos=eos[0] if isinstance(eos, list) else eos,
                pad=151643 if pad is None else pad)
