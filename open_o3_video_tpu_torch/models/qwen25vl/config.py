"""Qwen2.5-VL configuration (counterpart of
``open_o3_video_tpu/models/qwen25vl/config.py``).

The same dataclasses, fields and defaults as the JAX package, with
``dtype`` a ``torch.dtype``. The family switches (norm/act type, windows,
deepstack, qk-norm, MoE) keep their fields so the two configs compare field
by field, but the port implements only Qwen2.5-VL: a config that sets one
to another family's value raises, and so does ``from_hf_dict`` for another
vision family (a text-only ``"qwen2"`` file is read as JAX reads it).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch


def _require_qwen25(cfg, **qwen25_values) -> None:
    for name, value in qwen25_values.items():
        if getattr(cfg, name) != value:
            raise NotImplementedError(
                f"{type(cfg).__name__}.{name}={getattr(cfg, name)!r}: the port runs "
                f"Qwen2.5-VL only ({name}={value!r})")


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: tuple[int, ...] = (7, 15, 23, 31)
    out_hidden_size: int = 3584
    tokens_per_second: int = 2
    norm_type: str = "rmsnorm"
    act_type: str = "swiglu"
    use_windows: bool = True
    num_position_embeddings: int = 0
    deepstack_visual_indexes: tuple[int, ...] = ()
    patch_embed_bias: bool = False

    def __post_init__(self):
        _require_qwen25(self, norm_type="rmsnorm", act_type="swiglu", use_windows=True,
                        num_position_embeddings=0, deepstack_visual_indexes=(),
                        patch_embed_bias=False)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size**2

    @property
    def window_patches(self) -> int:
        """Window side length in (unmerged) patches."""
        return self.window_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    mrope_section: tuple[int, ...] = (16, 24, 24)
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 128000
    explicit_head_dim: Optional[int] = None
    attention_bias: bool = True
    use_qk_norm: bool = False
    mrope_interleaved: bool = False
    moe_num_experts: int = 0
    moe_topk: int = 0
    moe_num_shared_experts: int = 0
    moe_routing: str = "topk_softmax"
    moe_intermediate_size: int = 0

    def __post_init__(self):
        _require_qwen25(self, explicit_head_dim=None, attention_bias=True, use_qk_norm=False,
                        mrope_interleaved=False, moe_num_experts=0)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class Qwen25VLConfig:
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    model_type: str = "qwen2_5_vl"
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    bos_token_id: int = 151643
    eos_token_id: int = 151645
    pad_token_id: int = 151643
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        _require_qwen25(self, model_type="qwen2_5_vl")

    @staticmethod
    def from_hf_dict(d: dict[str, Any], dtype=torch.bfloat16) -> "Qwen25VLConfig":
        """An HF config.json of the Qwen2.5-VL family, or, as the JAX
        package's default branch reads it, of a text-only Qwen2 decoder
        (``"qwen2"``: Qwen2.5-72B-Instruct, the judge), whose missing vision
        fields take the defaults. Qwen2-VL and Qwen3-VL files raise."""
        v = d.get("vision_config", {})
        t = d.get("text_config", d)  # older files inline the text fields
        rope_scaling = t.get("rope_scaling") or d.get("rope_scaling") or {}
        model_type = d.get("model_type", "qwen2_5_vl")
        if (
            model_type in ("qwen2_vl", "qwen3_vl", "qwen3_vl_moe")
            or v.get("deepstack_visual_indexes") is not None
            or v.get("embed_dim") is not None
        ):
            raise NotImplementedError(f"model family {model_type!r}: the port runs qwen2_5_vl")
        vision = VisionConfig(
            depth=v.get("depth", 32),
            hidden_size=v.get("hidden_size", 1280),
            intermediate_size=v.get("intermediate_size", 3420),
            num_heads=v.get("num_heads", 16),
            in_channels=v.get("in_channels", v.get("in_chans", 3)),
            patch_size=v.get("patch_size", 14),
            spatial_merge_size=v.get("spatial_merge_size", 2),
            temporal_patch_size=v.get("temporal_patch_size", 2),
            window_size=v.get("window_size", 112),
            fullatt_block_indexes=tuple(v.get("fullatt_block_indexes", (7, 15, 23, 31))),
            out_hidden_size=v.get("out_hidden_size", 3584),
            tokens_per_second=v.get("tokens_per_second", 2),
        )
        text = TextConfig(
            vocab_size=t.get("vocab_size", 152064),
            hidden_size=t.get("hidden_size", 3584),
            intermediate_size=t.get("intermediate_size", 18944),
            num_hidden_layers=t.get("num_hidden_layers", 28),
            num_attention_heads=t.get("num_attention_heads", 28),
            num_key_value_heads=t.get("num_key_value_heads", 4),
            rms_norm_eps=t.get("rms_norm_eps", 1e-6),
            rope_theta=t.get("rope_theta", 1000000.0),
            mrope_section=tuple(rope_scaling.get("mrope_section", (16, 24, 24))),
            tie_word_embeddings=t.get("tie_word_embeddings", d.get("tie_word_embeddings", False)),
            max_position_embeddings=t.get("max_position_embeddings", 128000),
        )
        eos = d.get("eos_token_id", 151645)
        pad = d.get("pad_token_id")
        return Qwen25VLConfig(
            vision=vision,
            text=text,
            image_token_id=d.get("image_token_id", 151655),
            video_token_id=d.get("video_token_id", 151656),
            vision_start_token_id=d.get("vision_start_token_id", 151652),
            vision_end_token_id=d.get("vision_end_token_id", 151653),
            bos_token_id=d.get("bos_token_id", 151643),
            eos_token_id=eos[0] if isinstance(eos, (list, tuple)) else eos,
            pad_token_id=151643 if pad is None else pad,  # an explicit 0 stays 0
            dtype=dtype,
        )

    @staticmethod
    def from_pretrained(model_dir: str, dtype=torch.bfloat16) -> "Qwen25VLConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            return Qwen25VLConfig.from_hf_dict(json.load(f), dtype=dtype)

    def to_hf_dict(self) -> dict[str, Any]:
        """HF-convention config.json payload (inverse of ``from_hf_dict``),
        the JAX package's ``to_hf_dict`` for Qwen2.5-VL, so an exported
        directory is self-describing."""
        v, t = self.vision, self.text
        return {
            "model_type": self.model_type,
            "architectures": ["Qwen2_5_VLForConditionalGeneration"],
            "vision_config": {
                "depth": v.depth,
                "hidden_size": v.hidden_size,
                "intermediate_size": v.intermediate_size,
                "num_heads": v.num_heads,
                "in_channels": v.in_channels,
                "patch_size": v.patch_size,
                "spatial_merge_size": v.spatial_merge_size,
                "temporal_patch_size": v.temporal_patch_size,
                "window_size": v.window_size,
                "fullatt_block_indexes": list(v.fullatt_block_indexes),
                "out_hidden_size": v.out_hidden_size,
                "tokens_per_second": v.tokens_per_second,
            },
            "text_config": {
                "vocab_size": t.vocab_size,
                "hidden_size": t.hidden_size,
                "intermediate_size": t.intermediate_size,
                "num_hidden_layers": t.num_hidden_layers,
                "num_attention_heads": t.num_attention_heads,
                "num_key_value_heads": t.num_key_value_heads,
                "rms_norm_eps": t.rms_norm_eps,
                "rope_theta": t.rope_theta,
                "rope_scaling": {"type": "mrope", "mrope_section": list(t.mrope_section)},
                "tie_word_embeddings": t.tie_word_embeddings,
                "max_position_embeddings": t.max_position_embeddings,
            },
            "image_token_id": self.image_token_id,
            "video_token_id": self.video_token_id,
            "vision_start_token_id": self.vision_start_token_id,
            "vision_end_token_id": self.vision_end_token_id,
            "bos_token_id": self.bos_token_id,
            "eos_token_id": self.eos_token_id,
            "pad_token_id": self.pad_token_id,
        }

    @staticmethod
    def tiny(dtype=torch.float32) -> "Qwen25VLConfig":
        """Small random-init config for tests and CPU parity checks."""
        return Qwen25VLConfig(
            vision=VisionConfig(
                depth=2,
                hidden_size=64,
                intermediate_size=128,
                num_heads=4,
                patch_size=14,
                window_size=112,
                fullatt_block_indexes=(1,),
                out_hidden_size=64,
            ),
            text=TextConfig(
                vocab_size=512,
                hidden_size=64,
                intermediate_size=128,
                num_hidden_layers=2,
                num_attention_heads=4,
                num_key_value_heads=2,
                mrope_section=(2, 3, 3),  # sums to head_dim // 2 = 8
            ),
            vision_start_token_id=100,
            vision_end_token_id=101,
            image_token_id=103,
            video_token_id=104,
            bos_token_id=0,
            eos_token_id=1,
            pad_token_id=2,
            dtype=dtype,
        )
