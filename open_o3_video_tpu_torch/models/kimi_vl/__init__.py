"""Kimi-VL (Kimi-VL-A3B-Instruct): MoonViT, an MLP projector and a
DeepSeek-V3 decoder with multi-head latent attention over a latent cache,
served through ``engine.InferenceEngine``. Training, speculative decoding,
meshes, quantized weights and fp8 caches are not supported for this
family."""

from . import params
from .config import KimiTextConfig, KimiVisionConfig, KimiVLConfig, tiny_kimi_vl
from .model import encode_vision, forward, get_rope_index, refuse_engine_options
from .text import init_kv_cache, text_forward

__all__ = ["KimiVLConfig", "KimiTextConfig", "KimiVisionConfig", "tiny_kimi_vl", "params",
           "encode_vision", "forward", "get_rope_index", "init_kv_cache", "refuse_engine_options",
           "text_forward"]
