"""Aria configuration (counterpart of ``open_o3_video_tpu/models/aria/config.py``).

Aria is an Idefics3/SigLIP vision tower, a cross-attention projector with a
learned query bank, and a llama-style decoder whose MLPs are routed
mixtures of experts with always-on shared experts. The decoder is the
shared :class:`TextConfig` with the MoE fields set and ``mrope_section =
(head_dim // 2, 0, 0)``: with one position on all three axes, chunked
M-RoPE is plain 1-D rope, so the shared decoder and engine serve Aria.
The same dataclasses, fields and defaults as the JAX package, with
``dtype`` a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import torch

from ..qwen25vl.config import TextConfig


@dataclasses.dataclass(frozen=True)
class AriaVisionConfig:
    """The Idefics3VisionConfig fields the tower uses."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    in_channels: int = 3
    image_size: int = 980
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    # read by the shared get_rope_index; Aria merges no patches (its
    # projector's queries take the patches' place)
    spatial_merge_size: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class AriaConfig:
    vision: AriaVisionConfig = dataclasses.field(default_factory=AriaVisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    # image patch count -> projector query count (HF
    # projector_patch_to_query_dict), as sorted pairs to keep it hashable
    patch_to_query: tuple[tuple[int, int], ...] = ((1225, 128), (4900, 256))
    image_token_id: int = 9
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 2
    dtype: torch.dtype = torch.bfloat16
    model_type: str = "aria"
    # Aria has no video or vision-start tokens: ids that never occur keep
    # the shared engine's paths for them inert
    video_token_id: int = -1
    vision_start_token_id: int = -2

    @property
    def max_query_num(self) -> int:
        return max(q for _, q in self.patch_to_query)

    def query_num(self, num_patches: int) -> int:
        for p, q in self.patch_to_query:
            if p == num_patches:
                return q
        raise KeyError(f"num_patches {num_patches} not in patch_to_query "
                       f"{dict(self.patch_to_query)} (HF AriaProjector contract)")

    @staticmethod
    def from_hf_dict(d: dict[str, Any], dtype=torch.bfloat16) -> "AriaConfig":
        """An HF Aria config.json, read as the JAX package reads it."""
        v = d.get("vision_config", {})
        t = d.get("text_config", {})
        vision = AriaVisionConfig(
            hidden_size=v.get("hidden_size", 1152),
            intermediate_size=v.get("intermediate_size", 4304),
            num_hidden_layers=v.get("num_hidden_layers", 27),
            num_attention_heads=v.get("num_attention_heads", 16),
            in_channels=v.get("num_channels", 3),
            image_size=v.get("image_size", 980),
            patch_size=v.get("patch_size", 14),
            layer_norm_eps=v.get("layer_norm_eps", 1e-6),
        )
        hidden = t.get("hidden_size", 2560)
        heads = t.get("num_attention_heads", 20)
        explicit_hd = t.get("head_dim")
        head_dim = explicit_hd if explicit_hd is not None else hidden // heads
        text = TextConfig(
            vocab_size=t.get("vocab_size", 100352),
            hidden_size=hidden,
            intermediate_size=t.get("intermediate_size", 13568),
            num_hidden_layers=t.get("num_hidden_layers", 28),
            num_attention_heads=heads,
            num_key_value_heads=t.get("num_key_value_heads", 20),
            rms_norm_eps=t.get("rms_norm_eps", 1e-5),
            rope_theta=t.get("rope_theta", 5000000.0),
            mrope_section=(head_dim // 2, 0, 0),  # everything in T: 1-D rope
            explicit_head_dim=explicit_hd,
            tie_word_embeddings=t.get("tie_word_embeddings", False),
            max_position_embeddings=t.get("max_position_embeddings", 65536),
            attention_bias=t.get("attention_bias", False),
            moe_num_experts=t.get("moe_num_experts", 66),
            moe_topk=t.get("moe_topk", 6),
            moe_num_shared_experts=t.get("moe_num_shared_experts", 2),
        )
        p2q = d.get("projector_patch_to_query_dict", {1225: 128, 4900: 256})
        eos, pad = d.get("eos_token_id", 2), d.get("pad_token_id")
        return AriaConfig(
            vision=vision,
            text=text,
            patch_to_query=tuple(sorted((int(k), int(q)) for k, q in p2q.items())),
            image_token_id=d.get("image_token_id", 9),
            bos_token_id=d.get("bos_token_id", 1),
            eos_token_id=eos[0] if isinstance(eos, (list, tuple)) else eos,
            pad_token_id=2 if pad is None else pad,  # an explicit 0 stays 0
            dtype=dtype,
        )

    @staticmethod
    def from_pretrained(model_dir: str, dtype=torch.bfloat16) -> "AriaConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            return AriaConfig.from_hf_dict(json.load(f), dtype=dtype)

    def to_hf_dict(self) -> dict[str, Any]:
        """HF-convention config.json payload (inverse of ``from_hf_dict``)."""
        v, t = self.vision, self.text
        head_dim = {"head_dim": t.explicit_head_dim} if t.explicit_head_dim is not None else {}
        return {
            "model_type": "aria",
            "architectures": ["AriaForConditionalGeneration"],
            "vision_config": {
                "model_type": "idefics3_vision",
                "hidden_size": v.hidden_size,
                "intermediate_size": v.intermediate_size,
                "num_hidden_layers": v.num_hidden_layers,
                "num_attention_heads": v.num_attention_heads,
                "num_channels": v.in_channels,
                "image_size": v.image_size,
                "patch_size": v.patch_size,
                "layer_norm_eps": v.layer_norm_eps,
            },
            "text_config": {
                "model_type": "aria_text",
                **head_dim,
                "vocab_size": t.vocab_size,
                "hidden_size": t.hidden_size,
                "intermediate_size": t.intermediate_size,
                "num_hidden_layers": t.num_hidden_layers,
                "num_attention_heads": t.num_attention_heads,
                "num_key_value_heads": t.num_key_value_heads,
                "rms_norm_eps": t.rms_norm_eps,
                "rope_theta": t.rope_theta,
                "tie_word_embeddings": t.tie_word_embeddings,
                "max_position_embeddings": t.max_position_embeddings,
                "attention_bias": t.attention_bias,
                "moe_num_experts": t.moe_num_experts,
                "moe_topk": t.moe_topk,
                "moe_num_shared_experts": t.moe_num_shared_experts,
            },
            "projector_patch_to_query_dict": {p: q for p, q in self.patch_to_query},
            "image_token_id": self.image_token_id,
            "bos_token_id": self.bos_token_id,
            "eos_token_id": self.eos_token_id,
            "pad_token_id": self.pad_token_id,
        }


def tiny_aria(dtype=torch.float32) -> AriaConfig:
    """Small random-init Aria config (JAX's ``tiny_aria``)."""
    return AriaConfig(
        vision=AriaVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=4, image_size=28, patch_size=14),
        text=TextConfig(vocab_size=512, hidden_size=48, intermediate_size=64,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                        rope_theta=10000.0, mrope_section=(6, 0, 0), attention_bias=False,
                        moe_num_experts=4, moe_topk=2, moe_num_shared_experts=2),
        patch_to_query=((4, 3),),
        image_token_id=500,
        bos_token_id=1,
        eos_token_id=2,
        pad_token_id=2,
        dtype=dtype,
    )


# The published config.json of rhymes-ai/Aria (25.3B parameters, 3.9B
# active), as transformers' AriaConfig reads it: its decoder's
# intermediate_size is each expert's (the shared experts are two of that
# width), and the fields the JAX reader would otherwise default apart from
# transformers (rms_norm_eps 1e-6, the image token) are written out. No
# weights are in the repository: the port serves it from random weights
# drawn from a seed.
ARIA_CONFIG = {
    "architectures": ["AriaForConditionalGeneration"],
    "model_type": "aria",
    "image_token_id": 9,
    "image_token_index": 9,
    "bos_token_id": 1,
    "eos_token_id": 2,
    "pad_token_id": 2,
    "projector_patch_to_query_dict": {"1225": 128, "4900": 256},
    "vision_feature_layer": -1,
    "text_config": {
        "model_type": "aria_text",
        "hidden_size": 2560,
        "intermediate_size": 1664,
        "max_position_embeddings": 65536,
        "moe_num_experts": 64,
        "moe_num_shared_experts": 2,
        "moe_topk": 6,
        "num_attention_heads": 20,
        "num_hidden_layers": 28,
        "num_key_value_heads": 20,
        "rms_norm_eps": 1e-06,
        "rope_theta": 5000000,
        "tie_word_embeddings": False,
        "vocab_size": 100352,
    },
    "vision_config": {
        "model_type": "idefics3_vision",
        "hidden_size": 1152,
        "image_size": 980,
        "intermediate_size": 4304,
        "num_attention_heads": 16,
        "num_hidden_layers": 27,
        "patch_size": 14,
    },
}
