"""Qwen2.5-VL in PyTorch: windowed ViT tower + GQA decoder with M-RoPE,
functions over a param dict (see ``params``)."""

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
