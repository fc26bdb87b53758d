"""Qwen-VL family configuration: Qwen2.5-VL, Qwen2-VL, Qwen3-VL and
Qwen3-VL-MoE (counterpart of ``open_o3_video_tpu/models/qwen25vl/config.py``).

The same dataclasses, fields and defaults as the JAX package, with
``dtype`` a ``torch.dtype``. ``from_hf_dict`` dispatches on ``model_type``
as JAX's does: Qwen2-VL (LayerNorm + QuickGELU tower, whole-frame attention
in every block, raw frame indices in M-RoPE) and Qwen3-VL (LayerNorm +
gelu-tanh tower with an interpolated learned position embedding and
deepstack taps; a decoder with qk-norm, no attention biases, an explicit
head_dim and interleaved M-RoPE) beside Qwen2.5-VL (a text-only ``"qwen2"``
file is read as JAX reads it). Qwen3-VL-MoE is Qwen3-VL with a routed
mixture of experts in every decoder layer (the ``moe_*`` fields; Aria's
decoder sets them too, ``models/aria/config.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch


MODEL_TYPES = ("qwen2_5_vl", "qwen2_vl", "qwen3_vl", "qwen3_vl_moe")


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
    # A routed mixture of experts in every layer where moe_num_experts > 0:
    # Aria (HF AriaTextMoELayer) takes the top-k logits and a softmax over
    # them ("topk_softmax"), plus always-on shared experts; Qwen3-VL-MoE
    # (HF Qwen3VLMoeTextSparseMoeBlock) a softmax over all experts, the
    # top-k, renormalised ("softmax_topk_norm"), no shared experts.
    moe_num_experts: int = 0
    moe_topk: int = 0
    moe_num_shared_experts: int = 0
    moe_routing: str = "topk_softmax"
    moe_intermediate_size: int = 0  # 0: intermediate_size

    @property
    def head_dim(self) -> int:
        if self.explicit_head_dim is not None:
            return self.explicit_head_dim
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
        if self.model_type not in MODEL_TYPES:
            raise ValueError(f"model_type {self.model_type!r} is not one of {MODEL_TYPES}; an "
                             "Aria checkpoint loads through models.load_model")

    @staticmethod
    def from_hf_dict(d: dict[str, Any], dtype=torch.bfloat16) -> "Qwen25VLConfig":
        """An HF config.json of the Qwen2.5-VL, Qwen2-VL, Qwen3-VL or
        Qwen3-VL-MoE family, or, as the JAX package's default branch reads
        it, of a text-only Qwen2 decoder (``"qwen2"``: Qwen2.5-72B-Instruct,
        the judge), whose missing vision fields take the defaults. An Aria
        file raises ValueError (``models.load_model`` reads it)."""
        v = d.get("vision_config", {})
        t = d.get("text_config", d)  # older files inline the text fields
        rope_scaling = t.get("rope_scaling") or d.get("rope_scaling") or {}
        model_type = d.get("model_type", "qwen2_5_vl")
        if model_type == "aria":
            raise ValueError("model_type 'aria': read it with models.aria.AriaConfig "
                             "(models.load_model dispatches on model_type)")
        if (model_type in ("qwen3_vl", "qwen3_vl_moe")
                or v.get("deepstack_visual_indexes") is not None):
            return _qwen3_from_hf_dict(d, v, t, rope_scaling, dtype)
        if model_type == "qwen2_vl" or v.get("embed_dim") is not None:
            return _qwen2_from_hf_dict(d, v, t, rope_scaling, dtype)
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
        return Qwen25VLConfig(vision=vision, text=_text_from_hf_dict(t, d, rope_scaling),
                              **_special_ids(d), dtype=dtype)

    @staticmethod
    def from_pretrained(model_dir: str, dtype=torch.bfloat16) -> "Qwen25VLConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            return Qwen25VLConfig.from_hf_dict(json.load(f), dtype=dtype)

    def to_hf_dict(self) -> dict[str, Any]:
        """HF-convention config.json payload (inverse of ``from_hf_dict``),
        the JAX package's ``to_hf_dict`` family by family, so an exported
        directory is self-describing."""
        v, t = self.vision, self.text
        if self.model_type in ("qwen3_vl", "qwen3_vl_moe"):
            vision_dict = {
                "depth": v.depth,
                "hidden_size": v.hidden_size,
                "hidden_act": "gelu_pytorch_tanh",
                "intermediate_size": v.intermediate_size,
                "num_heads": v.num_heads,
                "in_channels": v.in_channels,
                "patch_size": v.patch_size,
                "spatial_merge_size": v.spatial_merge_size,
                "temporal_patch_size": v.temporal_patch_size,
                "out_hidden_size": v.out_hidden_size,
                "num_position_embeddings": v.num_position_embeddings,
                "deepstack_visual_indexes": list(v.deepstack_visual_indexes),
            }
            arch = (["Qwen3VLMoeForConditionalGeneration"] if self.model_type == "qwen3_vl_moe"
                    else ["Qwen3VLForConditionalGeneration"])
        elif self.model_type == "qwen2_vl":
            vision_dict = {
                "depth": v.depth,
                "embed_dim": v.hidden_size,
                "hidden_size": v.out_hidden_size,
                "hidden_act": "quick_gelu",
                "mlp_ratio": v.intermediate_size / v.hidden_size,
                "num_heads": v.num_heads,
                "in_channels": v.in_channels,
                "patch_size": v.patch_size,
                "spatial_merge_size": v.spatial_merge_size,
                "temporal_patch_size": v.temporal_patch_size,
            }
            arch = ["Qwen2VLForConditionalGeneration"]
        else:
            vision_dict = {
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
            }
            arch = ["Qwen2_5_VLForConditionalGeneration"]
        text_dict = {
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
        }
        if self.model_type in ("qwen3_vl", "qwen3_vl_moe"):
            text_dict["head_dim"] = t.head_dim
            text_dict["attention_bias"] = t.attention_bias
        if self.model_type == "qwen3_vl_moe":
            text_dict["num_experts"] = t.moe_num_experts
            text_dict["num_experts_per_tok"] = t.moe_topk
            text_dict["moe_intermediate_size"] = t.moe_intermediate_size
        return {
            "model_type": self.model_type,
            "architectures": arch,
            "vision_config": vision_dict,
            "text_config": text_dict,
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


# The published config.json files of the families' served models (no
# weights of any are in the repository: the port serves them from random
# weights drawn from a seed, at these widths).
QWEN3_VL_8B_INSTRUCT_CONFIG = {
    "architectures": ["Qwen3VLForConditionalGeneration"],
    "model_type": "qwen3_vl",
    "image_token_id": 151655,
    "video_token_id": 151656,
    "vision_start_token_id": 151652,
    "vision_end_token_id": 151653,
    "tie_word_embeddings": False,
    "text_config": {
        "model_type": "qwen3_vl_text",
        "attention_bias": False,
        "bos_token_id": 151643,
        "eos_token_id": 151645,
        "head_dim": 128,
        "hidden_act": "silu",
        "hidden_size": 4096,
        "intermediate_size": 12288,
        "max_position_embeddings": 262144,
        "num_attention_heads": 32,
        "num_hidden_layers": 36,
        "num_key_value_heads": 8,
        "rms_norm_eps": 1e-06,
        "rope_scaling": {"mrope_interleaved": True, "mrope_section": [24, 20, 20],
                         "rope_type": "default"},
        "rope_theta": 5000000,
        "tie_word_embeddings": False,
        "vocab_size": 151936,
    },
    "vision_config": {
        "model_type": "qwen3_vl",
        "deepstack_visual_indexes": [8, 16, 24],
        "depth": 27,
        "hidden_act": "gelu_pytorch_tanh",
        "hidden_size": 1152,
        "in_channels": 3,
        "intermediate_size": 4304,
        "num_heads": 16,
        "num_position_embeddings": 2304,
        "out_hidden_size": 4096,
        "patch_size": 16,
        "spatial_merge_size": 2,
        "temporal_patch_size": 2,
    },
}
QWEN3_VL_30B_A3B_INSTRUCT_CONFIG = {
    "architectures": ["Qwen3VLMoeForConditionalGeneration"],
    "model_type": "qwen3_vl_moe",
    "image_token_id": 151655,
    "video_token_id": 151656,
    "vision_start_token_id": 151652,
    "vision_end_token_id": 151653,
    "tie_word_embeddings": False,
    "text_config": {
        "model_type": "qwen3_vl_moe_text",
        "attention_bias": False,
        "bos_token_id": 151643,
        "decoder_sparse_step": 1,
        "eos_token_id": 151645,
        "head_dim": 128,
        "hidden_act": "silu",
        "hidden_size": 2048,
        "intermediate_size": 6144,
        "max_position_embeddings": 262144,
        "mlp_only_layers": [],
        "moe_intermediate_size": 768,
        "norm_topk_prob": True,
        "num_attention_heads": 32,
        "num_experts": 128,
        "num_experts_per_tok": 8,
        "num_hidden_layers": 48,
        "num_key_value_heads": 4,
        "rms_norm_eps": 1e-06,
        "rope_scaling": {"mrope_interleaved": True, "mrope_section": [24, 20, 20],
                         "rope_type": "default"},
        "rope_theta": 5000000,
        "vocab_size": 151936,
    },
    "vision_config": {
        "model_type": "qwen3_vl_moe",
        "deepstack_visual_indexes": [8, 16, 24],
        "depth": 27,
        "hidden_act": "gelu_pytorch_tanh",
        "hidden_size": 1152,
        "in_channels": 3,
        "intermediate_size": 4304,
        "num_heads": 16,
        "num_position_embeddings": 2304,
        "out_hidden_size": 2048,
        "patch_size": 16,
        "spatial_merge_size": 2,
        "temporal_patch_size": 2,
    },
}
QWEN2_VL_7B_INSTRUCT_CONFIG = {
    "architectures": ["Qwen2VLForConditionalGeneration"],
    "model_type": "qwen2_vl",
    "bos_token_id": 151643,
    "eos_token_id": 151645,
    "vision_start_token_id": 151652,
    "vision_end_token_id": 151653,
    "vision_token_id": 151654,
    "image_token_id": 151655,
    "video_token_id": 151656,
    "hidden_act": "silu",
    "hidden_size": 3584,
    "intermediate_size": 18944,
    "max_position_embeddings": 32768,
    "max_window_layers": 28,
    "num_attention_heads": 28,
    "num_hidden_layers": 28,
    "num_key_value_heads": 4,
    "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0,
    "sliding_window": 32768,
    "tie_word_embeddings": False,
    "use_sliding_window": False,
    "vocab_size": 152064,
    "rope_scaling": {"type": "mrope", "mrope_section": [16, 24, 24]},
    "vision_config": {
        "depth": 32,
        "embed_dim": 1280,
        "mlp_ratio": 4,
        "num_heads": 16,
        "in_chans": 3,
        "hidden_size": 3584,
        "patch_size": 14,
        "spatial_merge_size": 2,
        "temporal_patch_size": 2,
    },
}


def _special_ids(d: dict[str, Any]) -> dict:
    eos = d.get("eos_token_id", 151645)
    pad = d.get("pad_token_id")
    return dict(
        image_token_id=d.get("image_token_id", 151655),
        video_token_id=d.get("video_token_id", 151656),
        vision_start_token_id=d.get("vision_start_token_id", 151652),
        vision_end_token_id=d.get("vision_end_token_id", 151653),
        bos_token_id=d.get("bos_token_id", 151643),
        eos_token_id=eos[0] if isinstance(eos, (list, tuple)) else eos,
        pad_token_id=151643 if pad is None else pad,  # an explicit 0 stays 0
    )


def _text_from_hf_dict(t: dict[str, Any], d: dict[str, Any], rope_scaling: dict) -> TextConfig:
    return TextConfig(
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


def _qwen3_from_hf_dict(d, v, t, rope_scaling, dtype) -> Qwen25VLConfig:
    """Qwen3-VL: a tower of LayerNorm + gelu-tanh blocks over whole frames,
    with an interpolated learned position embedding and deepstack taps; a
    Qwen3 decoder (qk-norm, no attention bias, interleaved M-RoPE).
    Qwen3-VL-MoE (``model_type`` "qwen3_vl_moe", or ``num_experts`` in the
    text config): every layer's MLP a routed mixture, softmax -> top-k ->
    renormalised, no shared experts; ``mlp_only_layers`` and a
    ``decoder_sparse_step`` other than 1 raise NotImplementedError, as in
    JAX (no released Qwen3-VL checkpoint sets them)."""
    moe = d.get("model_type") == "qwen3_vl_moe" or t.get("num_experts") is not None
    if moe and (t.get("mlp_only_layers") or t.get("decoder_sparse_step", 1) != 1):
        raise NotImplementedError("qwen3_vl_moe with mlp_only_layers / decoder_sparse_step != 1")
    vision = VisionConfig(
        depth=v.get("depth", 27),
        hidden_size=v.get("hidden_size", 1152),
        intermediate_size=v.get("intermediate_size", 4304),
        num_heads=v.get("num_heads", 16),
        in_channels=v.get("in_channels", 3),
        patch_size=v.get("patch_size", 16),
        spatial_merge_size=v.get("spatial_merge_size", 2),
        temporal_patch_size=v.get("temporal_patch_size", 2),
        fullatt_block_indexes=(),
        out_hidden_size=v.get("out_hidden_size", 3584),
        norm_type="layernorm",
        act_type="gelu_tanh",
        use_windows=False,
        num_position_embeddings=v.get("num_position_embeddings", 2304),
        deepstack_visual_indexes=tuple(v.get("deepstack_visual_indexes", (8, 16, 24))),
        patch_embed_bias=True,
    )
    text = dataclasses.replace(
        _text_from_hf_dict(t, d, rope_scaling),
        vocab_size=t.get("vocab_size", 151936),
        rope_theta=t.get("rope_theta", 5000000.0),
        mrope_section=tuple(rope_scaling.get("mrope_section", (24, 20, 20))),
        explicit_head_dim=t.get("head_dim", 128),
        attention_bias=t.get("attention_bias", False),
        use_qk_norm=True,
        mrope_interleaved=True,
        moe_num_experts=t.get("num_experts", 0) if moe else 0,
        moe_topk=t.get("num_experts_per_tok", 0) if moe else 0,
        moe_routing="softmax_topk_norm" if moe else "topk_softmax",
        moe_intermediate_size=t.get("moe_intermediate_size", 0) if moe else 0,
    )
    return Qwen25VLConfig(vision=vision, text=text, model_type="qwen3_vl_moe" if moe else "qwen3_vl",
                          **_special_ids(d), dtype=dtype)


def _qwen2_from_hf_dict(d, v, t, rope_scaling, dtype) -> Qwen25VLConfig:
    """Qwen2-VL: the vision fields are named embed_dim / hidden_size (the
    merger's output) / mlp_ratio; the decoder is Qwen2.5-VL's."""
    embed_dim = v.get("embed_dim", 1280)
    vision = VisionConfig(
        depth=v.get("depth", 32),
        hidden_size=embed_dim,
        intermediate_size=int(embed_dim * v.get("mlp_ratio", 4)),
        num_heads=v.get("num_heads", 16),
        in_channels=v.get("in_channels", v.get("in_chans", 3)),
        patch_size=v.get("patch_size", 14),
        spatial_merge_size=v.get("spatial_merge_size", 2),
        temporal_patch_size=v.get("temporal_patch_size", 2),
        fullatt_block_indexes=(),
        out_hidden_size=v.get("hidden_size", 3584),
        norm_type="layernorm",
        act_type="quickgelu",
        use_windows=False,
    )
    return Qwen25VLConfig(vision=vision, text=_text_from_hf_dict(t, d, rope_scaling),
                          model_type="qwen2_vl", **_special_ids(d), dtype=dtype)


def tiny_qwen3(dtype=torch.float32) -> Qwen25VLConfig:
    """Small random-init Qwen3-VL config (JAX's ``tiny_qwen3``)."""
    base = Qwen25VLConfig.tiny(dtype=dtype)
    vision = dataclasses.replace(
        base.vision,
        fullatt_block_indexes=(),
        norm_type="layernorm",
        act_type="gelu_tanh",
        use_windows=False,
        intermediate_size=2 * base.vision.hidden_size,
        num_position_embeddings=16,  # a 4x4 learned grid, interpolated
        deepstack_visual_indexes=(0, 1),
        patch_embed_bias=True,
        patch_size=14,
    )
    text = dataclasses.replace(
        base.text,
        explicit_head_dim=16,
        attention_bias=False,
        use_qk_norm=True,
        mrope_section=(4, 2, 2),  # the interleaved layout sums to head_dim // 2
        mrope_interleaved=True,
        rope_theta=5000000.0,
    )
    return dataclasses.replace(base, vision=vision, text=text, model_type="qwen3_vl")


def tiny_qwen3_moe(dtype=torch.float32) -> Qwen25VLConfig:
    """Small random-init Qwen3-VL-MoE config (JAX's ``tiny_qwen3_moe``)."""
    base = tiny_qwen3(dtype=dtype)
    text = dataclasses.replace(base.text, moe_num_experts=4, moe_topk=2,
                               moe_routing="softmax_topk_norm", moe_intermediate_size=32)
    return dataclasses.replace(base, text=text, model_type="qwen3_vl_moe")


def tiny_qwen2(dtype=torch.float32) -> Qwen25VLConfig:
    """Small random-init Qwen2-VL config (JAX's ``tiny_qwen2``)."""
    base = Qwen25VLConfig.tiny(dtype=dtype)
    vision = dataclasses.replace(
        base.vision,
        fullatt_block_indexes=(),
        norm_type="layernorm",
        act_type="quickgelu",
        intermediate_size=4 * base.vision.hidden_size,
        use_windows=False,
    )
    return dataclasses.replace(base, vision=vision, model_type="qwen2_vl")
