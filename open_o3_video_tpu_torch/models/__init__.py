"""Model families of the port, everything the reference dispatches between
by name (grpo_trainer.py:211-219) and its 2025-11 update base:

- ``qwen25vl``: Qwen2.5-VL, Qwen2-VL, Qwen3-VL and Qwen3-VL-MoE as
  config-selected variants over shared towers and one decoder, the family
  detected from an HF config.json by ``Qwen25VLConfig.from_hf_dict``;
- ``aria``: Aria, an Idefics3/SigLIP tower and a cross-attention projector
  over the shared decoder with mixture-of-experts MLPs;
- ``kimi_vl``: Kimi-VL, a MoonViT tower and a DeepSeek-V3 decoder with
  latent attention (served only).

``load_model`` dispatches a checkpoint directory on its config.json's
``model_type``; ``family_forward`` is the trainer-facing forward of either;
``family_module`` names the family whose decoder, cache and tower are its
own, for the serving engine.
"""

from __future__ import annotations

import json
import os

from . import aria, kimi_vl, qwen25vl


def load_model(model_dir: str, device, dtype=None, **kwargs):
    """(params, cfg, family module) of an HF checkpoint directory, the
    family chosen by its config.json's ``model_type`` (the reference's
    by-name selection). ``kwargs`` go to the Qwen families' loader
    (``quantize_text``, ``quantize_vision``); Aria's and Kimi-VL's loaders
    take none, and raise ValueError on any."""
    with open(os.path.join(model_dir, "config.json")) as f:
        model_type = json.load(f).get("model_type", "qwen2_5_vl")
    dt = {"dtype": dtype} if dtype is not None else {}
    if model_type == "kimi_vl":
        if kwargs:
            raise ValueError(f"kimi_vl checkpoints do not support loader options {sorted(kwargs)}")
        cfg = kimi_vl.KimiVLConfig.from_pretrained(model_dir, **dt)
        params, cfg = kimi_vl.params.load_pretrained(model_dir, device, cfg=cfg)
        return params, cfg, kimi_vl
    if model_type == "aria":
        if kwargs:
            raise ValueError(f"aria checkpoints do not support loader options {sorted(kwargs)}")
        cfg = aria.AriaConfig.from_pretrained(model_dir, **dt)
        params, cfg = aria.params.load_pretrained(model_dir, device, cfg=cfg)
        return params, cfg, aria
    cfg = qwen25vl.Qwen25VLConfig.from_pretrained(model_dir, **dt)
    params, cfg = qwen25vl.params.load_pretrained(model_dir, device, cfg=cfg, **kwargs)
    return params, cfg, qwen25vl


def is_aria(cfg) -> bool:
    return getattr(cfg, "model_type", None) == "aria"


def family_module(cfg):
    """The module of a family with its own decoder, cache and tower (Kimi-VL:
    ``text_forward``, ``init_kv_cache``, ``encode_vision``,
    ``refuse_engine_options``), or None for the families that share
    ``qwen25vl``'s (the Qwen families and Aria)."""
    return kimi_vl if getattr(cfg, "model_type", None) == "kimi_vl" else None


def family_forward(params, cfg, input_ids, position_ids, *, pixel_patches=None, grid_thw=None,
                   vision_token_id=None, pixel_values=None, vision_row_index=None,
                   attn_valid=None, attn_impl: str = "auto", remat: bool = False,
                   return_hidden: bool = False):
    """The trainer-facing forward, dispatched on the config's family: the
    Qwen families take flattened ``pixel_patches`` with ``grid_thw``, Aria
    square ``pixel_values`` crops; both take ``vision_row_index``, so that
    several rows share one vision encoding."""
    if is_aria(cfg):
        if pixel_patches is not None or grid_thw is not None:
            raise ValueError("Aria takes pixel_values, not pixel_patches/grid_thw")
        return aria.forward(params, cfg, input_ids, position_ids, pixel_values=pixel_values,
                            vision_row_index=vision_row_index, attn_valid=attn_valid,
                            attn_impl=attn_impl, remat=remat, return_hidden=return_hidden)
    if pixel_values is not None:
        raise ValueError("the Qwen families take pixel_patches/grid_thw, not pixel_values")
    return qwen25vl.forward(params, cfg, input_ids, position_ids, pixel_patches=pixel_patches,
                            grid_thw=grid_thw, vision_token_id=vision_token_id,
                            vision_row_index=vision_row_index, attn_valid=attn_valid,
                            attn_impl=attn_impl, remat=remat, return_hidden=return_hidden)


__all__ = ["aria", "kimi_vl", "qwen25vl", "load_model", "family_forward", "family_module",
           "is_aria"]
