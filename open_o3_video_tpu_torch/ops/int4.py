"""Int4 weight-only matmul: K7 (counterpart of ``open_o3_video_tpu/ops/int4.py``).

Layout, as the JAX package packs it (so int4 weights load unchanged):

- weights quantize in groups of ``group`` input rows, symmetric (codes
  -7..7), one float32 scale per (group, output column);
- adjacent rows pack into one byte: ``w_p[k, n]`` holds W[2k] in its low
  nibble and W[2k+1] in its high nibble;
- the group scales multiply each group's dot output, never the weights.

``int4_dense`` follows JAX's ``_int4_mm_2d``. Shapes the kernel covers (N a
multiple of 128, ``(group // 2) % 8 == 0``) take the kernel's function: x
rounded to bf16, per-group bf16 products summed in f32 and scaled in f32, the
result rounded to bf16 and then cast to x's dtype. On a CUDA tensor that is
K7 (``csrc/int4_matmul.cu``, built for groups of 128 rows); on the CPU, or
with ``impl="torch"``, its plain version. Other shapes take JAX's fallback on
every device: ``x @ dequantize(w, x.dtype)``.

K7 has no backward (JAX's Pallas call has none either; LoRA dequantizes the
base before training), so the kernel route raises under autograd rather
than cutting the graph. The JAX package's GSPMD wrapper
(``_sharded_int4_mm``) has no counterpart: one card holds the whole weight.

``int4_matmul_stream`` and ``int4_matmul_convert`` are K7a, the TPU
profiling scripts' probes of K7's parts; nothing on a model path calls them.
"""

from __future__ import annotations

import re

import torch

from . import kernels

# The one group size K7 is built for (the JAX package's default, and the
# only one its quantizers use for the 7B and 72B models).
KERNEL_GROUP = 128


class Int4Linear:
    """Packed int4 weight ``w_p`` (in/2, out) int8 and per-(group, out)
    float32 ``scale`` (in/group, out); used through ``quant.dense``."""

    def __init__(self, w_p: torch.Tensor, scale: torch.Tensor, group: int = 128):
        self.w_p = w_p
        self.scale = scale
        self.group = int(group)

    @property
    def shape(self):
        return (self.w_p.shape[0] * 2, self.w_p.shape[1])

    def __repr__(self):
        return f"Int4Linear(shape={self.shape}, group={self.group})"


def quantize_weight_int4(w: torch.Tensor, group: int = 128) -> Int4Linear:
    """Symmetric group-wise int4 quantization of an (in, out) matrix, byte for
    byte as JAX's ``quantize_weight_int4``: absmax / 7 per (group, column),
    round half to even, clip to +-7, pairs of rows packed with the shifts
    in int32 and the result wrapped to int8. Works in place on one float32
    copy of ``w``, so a 72B leaf needs ~2.5x its float32 size at most."""
    K, N = w.shape
    if group % 2 or K % group:
        raise ValueError(f"in-dim {K} does not divide into groups of {group} (even)")
    with torch.no_grad():
        w32 = w.to(torch.float32, copy=True).reshape(K // group, group, N)
        absmax = torch.maximum(w32.amax(dim=1, keepdim=True), w32.amin(dim=1, keepdim=True).neg())
        scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 7.0)
        q = w32.div_(scale).round_().clamp_(-7, 7).reshape(K, N).to(torch.int8)
        del w32
        lo, hi = q[0::2].to(torch.int32), q[1::2].to(torch.int32)
        packed = ((hi << 4) | (lo & 0xF)).to(torch.int8)
    return Int4Linear(packed, scale[:, 0].contiguous(), group)


def unpack(w_p: torch.Tensor) -> torch.Tensor:
    """(K/2, N) packed bytes -> (K, N) int32 codes: the low nibble of row k
    is code 2k, the high nibble code 2k+1, each sign-extended."""
    p = w_p.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = p >> 4
    return torch.stack([lo, hi], dim=1).reshape(2 * w_p.shape[0], w_p.shape[1])


def dequantize(w: Int4Linear, dtype=torch.float32) -> torch.Tensor:
    """Dense (K, N) codes times their scales (JAX's ``_dequant_xla``)."""
    s = torch.repeat_interleave(w.scale, w.group, dim=0)
    return (unpack(w.w_p) * s).to(dtype)


def kernel_eligible(N: int, group: int) -> bool:
    """JAX's rule for the Pallas route (``_int4_mm_2d``)."""
    return N % 128 == 0 and group % 2 == 0 and (group // 2) % 8 == 0


def int4_matmul_torch(x2: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor,
                      group: int) -> torch.Tensor:
    """Plain version of K7: (M, K) -> (M, N) bf16. Each group's product of
    bf16(x) with its codes in float32, times its scale, added in group
    order; one group's codes are unpacked at a time."""
    xb = x2.to(torch.bfloat16).float()
    out = torch.zeros((x2.shape[0], w_p.shape[1]), dtype=torch.float32, device=x2.device)
    g2 = group // 2
    for g in range(w_p.shape[0] // g2):
        q = unpack(w_p[g * g2:(g + 1) * g2]).float()
        out += (xb[:, g * group:(g + 1) * group] @ q) * scale[g]
    return out.to(torch.bfloat16)


def _operands(name, x2, w_p, scale=None):
    """bf16 x, checked operands and the output of one kernel launch."""
    M, K = x2.shape
    N = w_p.shape[1]
    xb = x2.to(torch.bfloat16).contiguous()
    kernels.check_tensor(f"{name}: x", xb, torch.bfloat16, (M, K))
    kernels.check_tensor(f"{name}: w_p", w_p, torch.int8, (K // 2, N))
    if scale is not None:
        kernels.check_tensor(f"{name}: scale", scale, torch.float32, (K // KERNEL_GROUP, N))
    if N % 128 or K % KERNEL_GROUP:
        raise ValueError(f"{name}: K {K} and N {N} must be multiples of 128")
    return xb, torch.empty((M, N), dtype=torch.bfloat16, device=x2.device)


def int4_matmul(x2: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor, group: int,
                impl: str = "auto") -> torch.Tensor:
    """K7: (M, K) @ the packed (K/2, N) weight, bf16 out."""
    if not kernels.use_kernel(x2, impl):
        return int4_matmul_torch(x2, w_p, scale, group)
    if group != KERNEL_GROUP:
        raise ValueError(f"int4_matmul: group {group} not built; the kernel is built for "
                         f"{KERNEL_GROUP}")
    xb, out = _operands("int4_matmul", x2, w_p, scale)
    M, K = xb.shape
    kernels.launch("int4_matmul", xb.data_ptr(), w_p.data_ptr(), scale.data_ptr(),
                   out.data_ptr(), M, K, w_p.shape[1], group)
    return out


def int4_dense(x: torch.Tensor, w: Int4Linear, impl: str = "auto") -> torch.Tensor:
    """x @ dequantize(w) in x's dtype, by K7's route where the shape is
    eligible (see the module docstring), else by JAX's fallback."""
    K2, N = w.w_p.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, 2 * K2)
    if not kernel_eligible(N, w.group):
        return (x2 @ dequantize(w, x2.dtype)).reshape(*lead, N).to(x.dtype)
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("int4_dense has no backward (the JAX package's Pallas call has none); "
                           "dequantize the weight to train through it")
    return int4_matmul(x2, w.w_p, w.scale, w.group, impl).reshape(*lead, N).to(x.dtype)


# ---- K7a: the TPU profiling scripts' probes of K7's parts -------------------


def int4_matmul_stream_torch(x2: torch.Tensor, w_p: torch.Tensor) -> torch.Tensor:
    """Plain version of the stream probe: x[:, :K/2] @ the packed bytes read
    as int8 values, float32 sums, bf16 out."""
    xb = x2[:, :w_p.shape[0]].to(torch.bfloat16).float()
    return (xb @ w_p.float()).to(torch.bfloat16)


def int4_matmul_convert_torch(x2: torch.Tensor, w_p: torch.Tensor) -> torch.Tensor:
    """Plain version of the convert probe: x @ the unpacked codes, no
    scales, float32 sums, bf16 out."""
    return (x2.to(torch.bfloat16).float() @ unpack(w_p).float()).to(torch.bfloat16)


def int4_matmul_stream(x2: torch.Tensor, w_p: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """K7a stream (``make_stream`` of scripts/profile_int4_kernel_parts.py):
    K7's loads and products without the unpack or the scales."""
    if not kernels.use_kernel(x2, impl):
        return int4_matmul_stream_torch(x2, w_p)
    xb, out = _operands("int4_matmul_stream", x2, w_p)
    kernels.launch("int4_matmul_stream", xb.data_ptr(), w_p.data_ptr(), out.data_ptr(),
                   *xb.shape, w_p.shape[1])
    return out


def int4_matmul_convert(x2: torch.Tensor, w_p: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """K7a convert (``make_convert``; ``_convert_only_int4`` of
    scripts/profile_int4_pallas.py): K7 without the scales."""
    if not kernels.use_kernel(x2, impl):
        return int4_matmul_convert_torch(x2, w_p)
    xb, out = _operands("int4_matmul_convert", x2, w_p)
    kernels.launch("int4_matmul_convert", xb.data_ptr(), w_p.data_ptr(), out.data_ptr(),
                   *xb.shape, w_p.shape[1])
    return out


def quantize_params_int4(params: dict, patterns=None, group: int = 128) -> dict:
    """Copy of the param dict with the 2D leaves whose path matches one of
    ``patterns`` (default: the decoder matmuls and the lm_head) and whose
    in-dim divides ``group`` int4-quantized; other leaves are shared."""
    from .quant import DEFAULT_QUANT_PATTERNS, map_with_path

    regexes = [re.compile(p) for p in (patterns or DEFAULT_QUANT_PATTERNS)]

    def maybe_quant(path, leaf):
        if (any(r.search(path) for r in regexes) and isinstance(leaf, torch.Tensor)
                and leaf.ndim == 2 and leaf.shape[0] % group == 0):
            return quantize_weight_int4(leaf, group)
        return leaf

    return map_with_path(maybe_quant, params)
