"""Aria in PyTorch: an Idefics3/SigLIP vision tower, a cross-attention
projector and the shared decoder with mixture-of-experts MLPs (routed
top-k plus shared experts), served by the shared inference engine through
``Request.vision_embeds``."""

from . import params
from .config import ARIA_CONFIG, AriaConfig, AriaVisionConfig, tiny_aria
from .model import forward, get_image_features, get_rope_index

__all__ = [
    "ARIA_CONFIG",
    "AriaConfig",
    "AriaVisionConfig",
    "tiny_aria",
    "forward",
    "get_image_features",
    "get_rope_index",
    "params",
]
