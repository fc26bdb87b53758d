"""Kimi-VL configuration: a MoonViT tower, an MLP projector and a
DeepSeek-V3 decoder (multi-head latent attention, sigmoid-routed experts
with shared experts after a leading dense layer).

The published ``config.json`` nests the decoder under ``text_config`` (a
DeepseekV3 config) and the tower under ``vision_config``; ``from_hf_dict``
also reads a flat file whose decoder keys sit at the top level. The
engine reads the same names of every family's config: ``text``,
``vision``, the special ids, ``model_type``. Kimi-VL has one vision
placeholder (``media_placeholder_token_id``), which serves as both the
image and the video id, and no vision-start token: an id that never occurs
keeps the shared position code on 1-D positions, which is what the decoder
takes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class KimiVisionConfig:
    """MoonViT: native-resolution patches of 14 (one frame an image), a
    learned 64 x 64 position table resized to each grid, a 2-D rope over
    interleaved pairs, LayerNorm / GELU-tanh blocks, a final LayerNorm,
    then the projector (LayerNorm, 2 x 2 merge, two linears with a GELU)."""

    depth: int = 27
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 1
    pos_emb_height: int = 64
    pos_emb_width: int = 64
    layer_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    out_hidden_size: int = 2048
    image_mean: tuple = (0.5, 0.5, 0.5)
    image_std: tuple = (0.5, 0.5, 0.5)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size ** 2


@dataclasses.dataclass(frozen=True)
class KimiTextConfig:
    """The DeepseekV3 decoder as Kimi-VL-A3B configures it: MLA with no q
    compression, 1-D rope on the 64 rope dims only, a dense first layer,
    then routed experts (sigmoid scores, a correction bias for the choice,
    normalised top-k weights times ``routed_scaling_factor``) beside shared
    experts. The ``moe_*`` names are those ``qwen25vl.text.moe_mlp`` reads."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    kv_norm_eps: float = 1e-6  # kv_a_layernorm: DeepseekV3RMSNorm's default
    rope_theta: float = 800000.0
    rope_interleave: bool = True
    first_k_dense_replace: int = 1
    moe_num_experts: int = 64
    moe_topk: int = 6
    moe_num_shared_experts: int = 2
    moe_intermediate_size: int = 1408
    moe_routing: str = "sigmoid_bias_topk_norm"
    routed_scaling_factor: float = 2.446
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 131072

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a token stores per layer: the normalised latent and the
        roped key part."""
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class KimiVLConfig:
    vision: KimiVisionConfig = dataclasses.field(default_factory=KimiVisionConfig)
    text: KimiTextConfig = dataclasses.field(default_factory=KimiTextConfig)
    model_type: str = "kimi_vl"
    image_token_id: int = 163605  # media_placeholder_token_id
    video_token_id: int = 163605
    vision_start_token_id: int = -2  # none: positions stay 1-D
    bos_token_id: int = 163584
    eos_token_id: int = 163586
    pad_token_id: int = 163839
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def from_hf_dict(d: dict[str, Any], dtype=torch.bfloat16) -> "KimiVLConfig":
        """A Kimi-VL config.json (decoder keys under ``text_config`` or at
        the top level). Raises ValueError on what this decoder does not
        compute: q compression, grouped routing, other scoring."""
        t = d.get("text_config", d)
        v = d.get("vision_config", {})
        if t.get("q_lora_rank") is not None:
            raise ValueError("q_lora_rank is not supported (Kimi-VL-A3B has none)")
        if t.get("n_group", 1) != 1 or t.get("topk_group", 1) != 1:
            raise ValueError("grouped expert routing (n_group > 1) is not supported")
        if t.get("scoring_func", "sigmoid") != "sigmoid" or not t.get("norm_topk_prob", True):
            raise ValueError("only sigmoid scoring with normalised top-k weights is supported")
        if t.get("rope_scaling"):
            raise ValueError("rope_scaling is not supported (Kimi-VL-A3B has none)")
        merge = v.get("merge_kernel_size", [2, 2])
        vision = KimiVisionConfig(
            depth=v.get("num_hidden_layers", 27), hidden_size=v.get("hidden_size", 1152),
            intermediate_size=v.get("intermediate_size", 4304),
            num_heads=v.get("num_attention_heads", 16), patch_size=v.get("patch_size", 14),
            spatial_merge_size=merge[0] if isinstance(merge, (list, tuple)) else merge,
            pos_emb_height=v.get("init_pos_emb_height", 64),
            pos_emb_width=v.get("init_pos_emb_width", 64),
            out_hidden_size=t.get("hidden_size", 2048))
        text = KimiTextConfig(
            vocab_size=t.get("vocab_size", 163840), hidden_size=t.get("hidden_size", 2048),
            intermediate_size=t.get("intermediate_size", 11264),
            num_hidden_layers=t.get("num_hidden_layers", 27),
            num_attention_heads=t.get("num_attention_heads", 16),
            kv_lora_rank=t.get("kv_lora_rank", 512),
            qk_nope_head_dim=t.get("qk_nope_head_dim", 128),
            qk_rope_head_dim=t.get("qk_rope_head_dim", 64), v_head_dim=t.get("v_head_dim", 128),
            rms_norm_eps=t.get("rms_norm_eps", 1e-5), rope_theta=float(t.get("rope_theta", 800000)),
            rope_interleave=t.get("rope_interleave", True),
            first_k_dense_replace=t.get("first_k_dense_replace", 1),
            moe_num_experts=t.get("n_routed_experts", 64), moe_topk=t.get("num_experts_per_tok", 6),
            moe_num_shared_experts=t.get("n_shared_experts", 2),
            moe_intermediate_size=t.get("moe_intermediate_size", 1408),
            routed_scaling_factor=float(t.get("routed_scaling_factor", 2.446)),
            tie_word_embeddings=t.get("tie_word_embeddings", False),
            max_position_embeddings=t.get("max_position_embeddings", 131072))
        placeholder = d.get("media_placeholder_token_id", 163605)
        eos = d.get("eos_token_id", t.get("eos_token_id", 163586))
        pad = d.get("pad_token_id", t.get("pad_token_id"))
        return KimiVLConfig(
            vision=vision, text=text, image_token_id=placeholder, video_token_id=placeholder,
            bos_token_id=d.get("bos_token_id", t.get("bos_token_id", 163584)),
            eos_token_id=eos[0] if isinstance(eos, (list, tuple)) else eos,
            pad_token_id=163839 if pad is None else pad, dtype=dtype)

    @staticmethod
    def from_pretrained(model_dir: str, dtype=torch.bfloat16) -> "KimiVLConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            return KimiVLConfig.from_hf_dict(json.load(f), dtype=dtype)

    def to_hf_dict(self) -> dict[str, Any]:
        """The HF layout of ``from_hf_dict``'s input."""
        v, t = self.vision, self.text
        return {
            "model_type": "kimi_vl", "architectures": ["KimiVLForConditionalGeneration"],
            "media_placeholder_token_id": self.image_token_id,
            "bos_token_id": self.bos_token_id, "eos_token_id": self.eos_token_id,
            "pad_token_id": self.pad_token_id,
            "vision_config": {
                "model_type": "moonvit", "num_hidden_layers": v.depth,
                "hidden_size": v.hidden_size, "intermediate_size": v.intermediate_size,
                "num_attention_heads": v.num_heads, "patch_size": v.patch_size,
                "merge_kernel_size": [v.spatial_merge_size, v.spatial_merge_size],
                "init_pos_emb_height": v.pos_emb_height, "init_pos_emb_width": v.pos_emb_width},
            "text_config": {
                "model_type": "deepseek_v3", "vocab_size": t.vocab_size,
                "hidden_size": t.hidden_size, "intermediate_size": t.intermediate_size,
                "moe_intermediate_size": t.moe_intermediate_size,
                "num_hidden_layers": t.num_hidden_layers,
                "num_attention_heads": t.num_attention_heads,
                "num_key_value_heads": t.num_attention_heads,
                "n_shared_experts": t.moe_num_shared_experts,
                "n_routed_experts": t.moe_num_experts,
                "routed_scaling_factor": t.routed_scaling_factor,
                "kv_lora_rank": t.kv_lora_rank, "q_lora_rank": None,
                "qk_rope_head_dim": t.qk_rope_head_dim, "v_head_dim": t.v_head_dim,
                "qk_nope_head_dim": t.qk_nope_head_dim, "topk_method": "noaux_tc",
                "n_group": 1, "topk_group": 1, "num_experts_per_tok": t.moe_topk,
                "first_k_dense_replace": t.first_k_dense_replace, "norm_topk_prob": True,
                "scoring_func": "sigmoid", "rms_norm_eps": t.rms_norm_eps,
                "rope_theta": t.rope_theta, "rope_scaling": None,
                "rope_interleave": t.rope_interleave, "attention_bias": False,
                "tie_word_embeddings": t.tie_word_embeddings,
                "max_position_embeddings": t.max_position_embeddings},
        }


def tiny_kimi_vl(dtype=torch.float32) -> KimiVLConfig:
    """Every width cut for the CPU tests: a 2-block tower of 2 heads of 16
    over an 8 x 8 position table, a 3-layer decoder (one dense, two routed)
    of 4 heads, 8 experts of width 24 (top 3), 2 shared."""
    return KimiVLConfig(
        vision=KimiVisionConfig(depth=2, hidden_size=32, intermediate_size=48, num_heads=2,
                                pos_emb_height=8, pos_emb_width=8, out_hidden_size=64),
        text=KimiTextConfig(vocab_size=512, hidden_size=64, intermediate_size=96,
                            num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=32,
                            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                            moe_num_experts=8, moe_topk=3, moe_intermediate_size=24,
                            rope_theta=10000.0),
        image_token_id=300, video_token_id=300, bos_token_id=301, eos_token_id=302,
        pad_token_id=303, dtype=dtype)
