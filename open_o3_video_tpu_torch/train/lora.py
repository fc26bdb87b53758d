"""LoRA adapters: the reference's PEFT path (counterpart of
``open_o3_video_tpu/train/lora.py``).

Adapters live in their own small dict ``{"layers": [{name: {"a", "b"}}]}``
over the decoder layers; ``apply_adapters`` grafts them onto the frozen base
as ``ops.quant.LoraLinear`` leaves (no copy: the base tensors are shared), so
an update differentiates the adapters only, and "adapters disabled" is the
base dict itself. The base may be int8 (QLoRA). Both families' param dicts
take them: the targets are decoder-layer leaves, so the Qwen families' and
Aria's mixture layers take adapters on ``q_w``/``v_w`` (PEFT's default),
and a target a layer lacks raises KeyError (a routed layer has no
``gate_w``; Aria's shared experts do).

``init_adapters`` draws A from a seeded ``torch.Generator`` with JAX's
distribution (N(0, 1) / sqrt(rank), B = 0); it cannot reproduce JAX's random
stream, so tests start both packages from JAX's adapters through
``params.adapters_from_jax``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..ops.int4 import Int4Linear, dequantize
from ..ops.quant import QUANTIZED, LoraLinear, QuantizedLinear, map_with_path
from ..ops.sharded import Sharded, lora_views

# TRL/PEFT module names -> leaf names (PEFT's Qwen default targets are the
# attention q/v projections).
_HF_TO_LEAF = {
    "q_proj": "q_w",
    "k_proj": "k_w",
    "v_proj": "v_w",
    "o_proj": "o_w",
    "gate_proj": "gate_w",
    "up_proj": "up_w",
    "down_proj": "down_w",
}


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 16  # TRL get_peft_config default (--lora_r)
    alpha: float = 32.0  # --lora_alpha
    target_modules: tuple[str, ...] = ("q_w", "v_w")  # PEFT Qwen default
    seed: int = 0

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    @staticmethod
    def normalize_targets(names: Sequence[str]) -> tuple[str, ...]:
        return tuple(_HF_TO_LEAF.get(n, n) for n in names)


def init_adapters(params: dict, cfg: LoraConfig, dtype=torch.bfloat16) -> dict:
    """Adapters over the targeted decoder leaves, on the base's device and
    trainable: B = 0 (PEFT's convention, so step 0 is the base model), A ~
    N(0, 1) / sqrt(rank), drawn in float32 from a generator seeded with
    ``cfg.seed`` and cast to ``dtype``."""
    layers_in = params["text"]["layers"]
    device = params["text"]["embed_tokens"].device
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    layers = []
    for layer in layers_in:
        entry = {}
        for name in cfg.target_modules:
            if name not in layer:
                raise KeyError(f"LoRA target {name!r} not in decoder layer (available: "
                               f"{sorted(layer)})")
            d_in, d_out = tuple(layer[name].shape)
            a = torch.randn((d_in, cfg.rank), generator=gen, device=device) / math.sqrt(cfg.rank)
            entry[name] = {
                "a": a.to(dtype).requires_grad_(True),
                "b": torch.zeros((cfg.rank, d_out), dtype=dtype, device=device).requires_grad_(True),
            }
        layers.append(entry)
    return {"layers": layers}


def adapter_leaves(adapters: dict) -> list[torch.Tensor]:
    """The adapter tensors in a fixed order (layer, target, a then b)."""
    return [ab[k] for layer in adapters["layers"] for ab in layer.values() for k in ("a", "b")]


def apply_adapters(params: dict, adapters: dict, scale: float) -> dict:
    """The param dict with each targeted decoder leaf a ``LoraLinear`` over
    the frozen base. Shares every tensor; builds new dicts only, so call it
    per use (a rollout under ``inference_mode``, then the update) and keep
    nothing of one for the other. Over a base on a mesh the whole adapters
    are read through ``ops.sharded.lora_views``."""
    layers = []
    for layer, ad in zip(params["text"]["layers"], adapters["layers"]):
        new = dict(layer)
        for name, ab in ad.items():
            a, b = ab["a"], ab["b"]
            if isinstance(layer[name], Sharded):  # a base on a mesh
                a, b = lora_views(layer[name], a, b)
            new[name] = LoraLinear(layer[name], a, b, scale)
        layers.append(new)
    return {**params, "text": {**params["text"], "layers": layers}}


def _dequant(leaf) -> torch.Tensor:
    if isinstance(leaf, QuantizedLinear):
        return leaf.w_q.float() * leaf.scale.float()
    if isinstance(leaf, Int4Linear):
        return dequantize(leaf, torch.float32)
    return leaf


@torch.no_grad()
def merge_adapters(params: dict, adapters: dict, scale: float, out_dtype=None) -> dict:
    """Fold the deltas into plain weights for export, as JAX's
    ``merge_adapters`` (PEFT's ``merge_and_unload``): a targeted leaf is
    (base + a @ b * scale) summed in float32, in the base's own dtype, or in
    ``out_dtype`` (default: the adapters' dtype) when the base is quantized;
    every other quantized leaf is dequantized to ``out_dtype`` too."""
    if out_dtype is None:
        out_dtype = adapter_leaves(adapters)[0].dtype
    layers = []
    for layer, ad in zip(params["text"]["layers"], adapters["layers"]):
        new = dict(layer)
        for name, ab in ad.items():
            base_leaf = layer[name]
            dtype = out_dtype if isinstance(base_leaf, QUANTIZED) else base_leaf.dtype
            delta = (ab["a"].float() @ ab["b"].float()) * scale
            new[name] = (_dequant(base_leaf).float() + delta).to(dtype)
        layers.append(new)
    out = {**params, "text": {**params["text"], "layers": layers}}
    return map_with_path(
        lambda _, x: _dequant(x).to(out_dtype) if isinstance(x, QUANTIZED) else x, out)
