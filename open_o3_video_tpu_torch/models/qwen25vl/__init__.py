"""The Qwen-VL families in PyTorch (Qwen2.5-VL, Qwen2-VL, Qwen3-VL and
Qwen3-VL-MoE): a ViT tower + GQA decoder with M-RoPE (its MLPs routed
mixtures of experts for Qwen3-VL-MoE), functions over a param dict (see
``params``), the family selected by the config."""

from . import params
from .config import Qwen25VLConfig, TextConfig, VisionConfig
from .model import build_vision_row_index, encode_vision, forward, get_rope_index

__all__ = [
    "Qwen25VLConfig",
    "TextConfig",
    "VisionConfig",
    "build_vision_row_index",
    "encode_vision",
    "forward",
    "get_rope_index",
    "params",
]
