"""Int8 weight-only quantization and the quantized matmul entry point
(counterpart of ``open_o3_video_tpu/ops/quant.py``).

``dense(x, w)`` is the one matmul of the decoder: a plain tensor gives
``x @ w``; a ``QuantizedLinear`` (int8, per-output-channel float32 scale)
gives x times the int8 weight in x's dtype, summed in float32, times the
scale, cast to x's dtype (JAX's XLA path, so a torch matmul here; it runs
in float32 because torch has no bf16 matmul with a float32 result on every
version, and that keeps JAX's single rounding); an ``Int4Linear`` goes to
``int4.int4_dense`` (K7); a ``LoraLinear`` (a frozen base, itself any of
the above, plus a trainable low-rank delta, ``train/lora.py``) gives
``dense(x, base) + ((x @ a) @ b) * scale``. Anything else raises.

w8a8 (``a8_acts``): inside the scope, a ``QuantizedLinear`` product takes
int8 activations too, quantized per row (absmax / 127, round half to
even, clip to +-127), the product summed in int32 (``torch._int_mm`` on
the card, an exact integer product on the CPU), then JAX's float32
epilogue ``y * sx * scale``, cast to x's dtype. The scope is the calling
thread's: the engine opens it around its prefill and vision programs only,
so a decode step, a capture, another engine or a prefetch thread never
runs under it. ``torch._int_mm`` on the card needs M > 16 and K, N
multiples of 8, and runs 5-8x faster with the weight column-major
(``scripts/exp_int8_matmul_torch.py``): so the int8 bytes are stored once,
column-major and zero-padded to multiples of 8 (``w_mm``), ``w_q`` being
their view at the logical shape, and the activations are padded per call,
which is exact in int32.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import re
import threading

import torch

from .int4 import Int4Linear, divisor, int4_dense
from .sharded import Sharded


_MM_ALIGN = 8  # torch._int_mm's K and N on the card


def _padded(n: int) -> int:
    return -(-n // _MM_ALIGN) * _MM_ALIGN


class QuantizedLinear:
    """int8 weight ``w_q`` (in, out) and float32 ``scale`` (1, out). The
    bytes live in ``w_mm`` (in', out'), in and out padded with zeros to
    multiples of 8, column-major (the transpose of a contiguous (out', in')
    tensor): the layout ``torch._int_mm`` reads fastest. ``w_q`` is its
    view at the logical shape; the given tensor is copied once."""

    def __init__(self, w_q: torch.Tensor, scale: torch.Tensor):
        K, N = w_q.shape
        rows = torch.zeros((_padded(N), _padded(K)), dtype=w_q.dtype, device=w_q.device)
        rows[:N, :K] = w_q.t()
        self.w_mm = rows.t()
        self.w_q = self.w_mm[:K, :N]
        self.scale = scale

    @property
    def shape(self):
        return tuple(self.w_q.shape)

    def __repr__(self):
        return f"QuantizedLinear(shape={self.shape})"


QUANTIZED = (QuantizedLinear, Int4Linear)


class LoraLinear:
    """Frozen base matmul + trainable low-rank delta, used via ``dense``
    (JAX's ``LoraLinear``). ``base`` is an (in, out) tensor or a quantized
    weight (QLoRA: an int8 base and bf16 adapters); ``a`` (in, rank), ``b``
    (rank, out); ``scale`` = alpha / rank, a Python float."""

    def __init__(self, base, a: torch.Tensor, b: torch.Tensor, scale: float):
        self.base = base
        self.a = a
        self.b = b
        self.scale = scale

    @property
    def shape(self):
        return tuple(self.base.shape)

    def __repr__(self):
        return f"LoraLinear(shape={self.shape}, rank={self.a.shape[-1]})"


def stored_tensors(w) -> tuple:
    """The tensors a weight is stored in: its int8 bytes and scale if
    quantized, a LoRA weight's base tensors and adapters, else the tensor
    itself."""
    if isinstance(w, QuantizedLinear):
        return (w.w_q, w.scale)
    if isinstance(w, Int4Linear):
        return (w.w_p, w.scale)
    if isinstance(w, LoraLinear):
        return stored_tensors(w.base) + stored_tensors(w.a) + stored_tensors(w.b)
    if isinstance(w, Sharded):
        return tuple(w.parts.values())
    return (w,)


def quantize_weight(w: torch.Tensor) -> QuantizedLinear:
    """Symmetric per-output-channel int8 quantization of an (in, out)
    matrix, byte for byte as JAX's ``quantize_weight``: absmax / 127 per
    column, round half to even, clip to +-127; the scale stays float32."""
    with torch.no_grad():
        w32 = w.to(torch.float32, copy=True)
        absmax = torch.maximum(w32.amax(dim=0, keepdim=True), w32.amin(dim=0, keepdim=True).neg())
        scale = torch.where(absmax == 0, torch.ones_like(absmax),
                            absmax / divisor(127.0, w32.device))
        w_q = w32.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return QuantizedLinear(w_q, scale)


@functools.cache
def rounded_scale(scale: float, dtype: torch.dtype) -> float:
    """``scale`` rounded to ``dtype`` once, as a Python float (JAX's
    ``jnp.asarray(scale, x.dtype)``), so ``dense`` makes no host tensor per
    call."""
    return torch.tensor(scale, dtype=dtype).item()


_A8 = threading.local()
# w8a8 products by route ("int_mm" on the card, "exact" on the CPU), across
# calls; chip_smoke reads them per tower pass and per prefill.
A8_MATMULS: collections.Counter = collections.Counter()


@contextlib.contextmanager
def a8_acts(enabled: bool = True):
    """``QuantizedLinear`` products as int8 x int8 (w8a8) on this thread
    inside the scope, as JAX's ``a8_acts``; ``a8_acts(False)`` turns an
    enclosing scope off. Serving only: ``round`` has no gradient."""
    prev = getattr(_A8, "on", False)
    _A8.on = bool(enabled)
    try:
        yield
    finally:
        _A8.on = prev


def a8_active() -> bool:
    return getattr(_A8, "on", False)


def quantize_acts(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last axis) symmetric int8 quantization, as JAX's
    ``quantize_acts``: (x_q int8, scale float32 of shape x.shape[:-1] + (1,))."""
    absmax = torch.maximum(x.amax(dim=-1, keepdim=True),
                           x.amin(dim=-1, keepdim=True).neg()).to(torch.float32)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / divisor(127.0, x.device))
    # x / scale promotes x to float32 element by element, as x.astype(f32) does
    x_q = torch.div(x, scale).round_().clamp_(-127, 127).to(torch.int8)
    return x_q, scale


def _int8_product(x_q: torch.Tensor, w: QuantizedLinear) -> torch.Tensor:
    """x_q (M, K) int8 times the weight's int8 bytes, summed in int32:
    ``torch._int_mm`` on the card, over ``w_mm`` with x_q's rows padded to
    17 and its columns to w_mm's; on the CPU a float64 product, exact since
    |sum| <= 127^2 K < 2^53."""
    M, K = x_q.shape
    N = w.w_q.shape[1]
    if x_q.is_cuda:
        Kp = w.w_mm.shape[0]
        if M <= 16 or Kp != K:
            x_q = torch.nn.functional.pad(x_q, (0, Kp - K, 0, max(0, 17 - M)))
        y = torch._int_mm(x_q.contiguous(), w.w_mm)
        A8_MATMULS["int_mm"] += 1
        return y[:M, :N]
    A8_MATMULS["exact"] += 1
    return (x_q.double() @ w.w_q.double()).to(torch.int32)


def _as_dtype(w, dtype):
    """A LoRA adapter in ``dtype``: a tensor cast, or a sharded one's shards."""
    if isinstance(w, Sharded):
        return Sharded({k: v.to(dtype) for k, v in w.parts.items()}, w.specs, w.kind, w.mesh,
                       w.shape, x_split=w.x_split, out_full=w.out_full)
    return w.to(dtype)


def dense(x: torch.Tensor, w, impl: str = "auto") -> torch.Tensor:
    """x @ w for a plain tensor, a QuantizedLinear, an Int4Linear (whose
    kernel route ``impl`` picks, as for the attention kernels) or a
    LoraLinear: its base's product plus the delta, with ``a`` and ``b`` cast
    to x's dtype and the scale rounded to it, as JAX's ``jnp.asarray(scale,
    x.dtype)``. A ``Sharded`` weight (a local shard on a mesh) runs its
    local product with the collectives its placement needs."""
    if isinstance(w, torch.Tensor):
        return x @ w
    if isinstance(w, Sharded):
        return w.dense(x, impl)
    if isinstance(w, LoraLinear):
        delta = dense(dense(x, _as_dtype(w.a, x.dtype)), _as_dtype(w.b, x.dtype))
        return dense(x, w.base, impl) + delta * rounded_scale(w.scale, x.dtype)
    if isinstance(w, Int4Linear):
        return int4_dense(x, w, impl=impl)
    if isinstance(w, QuantizedLinear):
        if a8_active():
            x_q, sx = quantize_acts(x)
            y = _int8_product(x_q.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], -1)
            # int32 * float32 converts y to float32 element by element
            return (y * sx).mul_(w.scale.float()).to(x.dtype)
        y = x.float() @ w.w_q.float()
        return (y * w.scale.float()).to(x.dtype)
    raise TypeError(f"dense: unsupported weight {type(w).__name__}")


# Text-decoder matrices worth quantizing for serving (big, read every token).
DEFAULT_QUANT_PATTERNS = (
    r"text/layers/\d+/(q_w|k_w|v_w|o_w|gate_w|up_w|down_w)$",
    r"text/lm_head$",
)

# Vision-tower matrices: quantized for the w8a8 tower's compute, not for
# memory. The patch embed and the merger stay in the model dtype.
VISION_QUANT_PATTERNS = (
    r"visual/blocks/\d+/(qkv_w|proj_w|fc1_w|fc2_w|gate_w|up_w|down_w)$",
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
