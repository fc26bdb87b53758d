"""Int8 weight-only quantization and the quantized matmul entry point
(counterpart of ``open_o3_video_tpu/ops/quant.py``).

``dense(x, w)`` is the one matmul of the decoder: a plain tensor gives
``x @ w``; a ``QuantizedLinear`` (int8, per-output-channel float32 scale)
gives x times the int8 weight in x's dtype, summed in float32, times the
scale, cast to x's dtype (JAX's XLA path, so a torch matmul here; it runs
in float32 because torch has no bf16 matmul with a float32 result on every
version, and that keeps JAX's single rounding); an ``Int4Linear`` goes to
``int4.int4_dense`` (K7). Anything else raises.

Not ported yet: w8a8 (``a8_acts``, ROADMAP M6) and ``LoraLinear`` (with
``train/lora.py``).
"""

from __future__ import annotations

import re

import torch

from .int4 import Int4Linear, int4_dense


class QuantizedLinear:
    """int8 weight ``w_q`` (in, out) and float32 ``scale`` (1, out)."""

    def __init__(self, w_q: torch.Tensor, scale: torch.Tensor):
        self.w_q = w_q
        self.scale = scale

    @property
    def shape(self):
        return tuple(self.w_q.shape)

    def __repr__(self):
        return f"QuantizedLinear(shape={self.shape})"


QUANTIZED = (QuantizedLinear, Int4Linear)


def stored_tensors(w) -> tuple:
    """The tensors a weight is stored in: its int8 bytes and scale if
    quantized, else the tensor itself."""
    if isinstance(w, QuantizedLinear):
        return (w.w_q, w.scale)
    if isinstance(w, Int4Linear):
        return (w.w_p, w.scale)
    return (w,)


def quantize_weight(w: torch.Tensor) -> QuantizedLinear:
    """Symmetric per-output-channel int8 quantization of an (in, out)
    matrix, byte for byte as JAX's ``quantize_weight``: absmax / 127 per
    column, round half to even, clip to +-127; the scale stays float32."""
    with torch.no_grad():
        w32 = w.to(torch.float32, copy=True)
        absmax = torch.maximum(w32.amax(dim=0, keepdim=True), w32.amin(dim=0, keepdim=True).neg())
        scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
        w_q = w32.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return QuantizedLinear(w_q, scale)


def dense(x: torch.Tensor, w, impl: str = "auto") -> torch.Tensor:
    """x @ w for a plain tensor, a QuantizedLinear or an Int4Linear (whose
    kernel route ``impl`` picks, as for the attention kernels)."""
    if isinstance(w, torch.Tensor):
        return x @ w
    if isinstance(w, Int4Linear):
        return int4_dense(x, w, impl=impl)
    if isinstance(w, QuantizedLinear):
        y = x.float() @ w.w_q.float()
        return (y * w.scale.float()).to(x.dtype)
    raise TypeError(f"dense: unsupported weight {type(w).__name__}")


# Text-decoder matrices worth quantizing for serving (big, read every token).
DEFAULT_QUANT_PATTERNS = (
    r"text/layers/\d+/(q_w|k_w|v_w|o_w|gate_w|up_w|down_w)$",
    r"text/lm_head$",
)


def map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a param dict, the path as JAX's ``_path_str``
    writes it ("text/layers/0/q_w"); quantized weights are leaves."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, f"{path}/{i}" if path else str(i)) for i, v in enumerate(tree)]
    return fn(path, tree)


def quantize_params(params: dict, patterns=DEFAULT_QUANT_PATTERNS) -> dict:
    """Copy of the param dict with the 2D leaves whose path matches one of
    ``patterns`` int8-quantized; other leaves are shared."""
    regexes = [re.compile(p) for p in patterns]

    def maybe_quant(path, leaf):
        if any(r.search(path) for r in regexes) and isinstance(leaf, torch.Tensor) and leaf.ndim == 2:
            return quantize_weight(leaf)
        return leaf

    return map_with_path(maybe_quant, params)


def param_bytes(params) -> int:
    """Bytes of every tensor in a param dict, quantized weights included."""
    total = 0

    def add(_, leaf):
        nonlocal total
        if leaf is not None:
            total += sum(t.numel() * t.element_size() for t in stored_tensors(leaf))

    map_with_path(add, params)
    return total
