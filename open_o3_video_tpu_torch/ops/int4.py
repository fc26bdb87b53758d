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
every device: ``x @ dequantize(w, x.dtype)``. K7 has two routes for the
same function, chosen by the row count (``kernel_route``): decode (M <= 64)
on ``csrc/int4_matmul.cu``'s split-K kernel, prefill on
``csrc/int4_matmul_sm90.cu``'s wgmma kernel. The decode route's column tile
and split count come from ``decode_plan``; with more than one split the
wrapper allocates the float32 workspace of the splits' partials, and the
last split of each column tile to finish sums them in split order, counted
on a per-device buffer of zeros that the kernel leaves zeroed (so calls
on one device go through one stream at a time, as the port runs them).

K7 has no backward (JAX's Pallas call has none either; LoRA dequantizes the
base before training), so the kernel route raises under autograd rather
than cutting the graph. The JAX package's GSPMD wrapper
(``_sharded_int4_mm``) has its counterpart in ``ops/sharded.py``: on a mesh
K7 runs on each rank's local shard (N split; K split only into whole quant
groups, the partials then summed), never on a gathered copy.

``int4_matmul_stream`` and ``int4_matmul_convert`` are K7a, the TPU
profiling scripts' probes of K7's parts; nothing on a model path calls them.
"""

from __future__ import annotations

import functools
import re

import torch

from . import kernels
from .kernels import sm_count

# The one group size K7 is built for (the JAX package's default, and the
# only one its quantizers use for the 7B and 72B models).
KERNEL_GROUP = 128
# From this many rows K7 takes its wgmma route: a 128-row tile then does
# useful work on at least half its rows, and the decode shapes (M <= 16 at
# the slice's batch sizes) keep the decode route's 8-64-row tiles.
WGMMA_MIN_ROWS = 65
# The decode route's column tiles, widest first, and the CTAs per SM its
# plan aims for (enough bytes in flight on every SM).
DECODE_BLOCK_NS = (128, 64, 32)
DECODE_CTAS_PER_SM = 2


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


@functools.cache
def divisor(value: float, device) -> torch.Tensor:
    """``value`` as a float32 tensor on ``device``, to divide by: PyTorch
    divides a CUDA tensor by a Python scalar as a product with its
    reciprocal, which can be an ulp off the quotient that JAX and the CPU
    compute, and so flip a rounding."""
    return torch.full((), value, dtype=torch.float32, device=device)


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
        scale = torch.where(absmax == 0, torch.ones_like(absmax),
                            absmax / divisor(7.0, w32.device))
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


def split_bounds(groups: int, splits: int) -> list[tuple[int, int]]:
    """The quant groups [start, end) of each split of the decode route, in
    split order: split s takes [s * groups // splits, (s + 1) * groups //
    splits), as ``csrc/int4_matmul.cu:split_begin`` computes it."""
    return [(s * groups // splits, (s + 1) * groups // splits) for s in range(splits)]


@functools.cache
def decode_plan(M: int, K: int, N: int, sms: int,
                block_ns: tuple = DECODE_BLOCK_NS) -> tuple[int, int]:
    """(block_n, splits) of the decode route for an (M, K) x (K, N) call on
    a card of ``sms`` SMs: the widest column tile whose tiles, split over
    the quant groups (at least one group a split), reach DECODE_CTAS_PER_SM
    CTAs on each SM, with the fewest splits that do; where no tile reaches
    it, the narrowest tile with every group a split of its own."""
    if not 1 <= M < WGMMA_MIN_ROWS:
        raise ValueError(f"decode_plan: {M} rows; the decode route takes 1..{WGMMA_MIN_ROWS - 1}")
    groups = K // KERNEL_GROUP
    target = DECODE_CTAS_PER_SM * sms
    for block_n in block_ns:
        tiles = N // block_n
        splits = min(groups, -(-target // tiles))
        if tiles * splits >= target:
            break
    return block_n, splits


_COUNTERS: dict = {}


def _split_counters(device: torch.device, tiles: int) -> torch.Tensor:
    """The decode route's int32 counters, one per column tile: zeros kept
    across calls (each call's last CTA resets its tile's), grown as needed."""
    counters = _COUNTERS.get(device)
    if counters is None or counters.numel() < tiles:
        counters = _COUNTERS[device] = torch.zeros(tiles, dtype=torch.int32, device=device)
    return counters


def _plan_args(xb: torch.Tensor, N: int, block_ns: tuple = DECODE_BLOCK_NS) -> tuple:
    """The decode route's launch arguments after ``out``: the workspace
    (splits, M, N) float32 and the counters (0 and 0 for one split), then
    after M, K, N (and the group) block_n and splits. Returns (pointers,
    (block_n, splits), tensors to keep alive until the launch)."""
    M, K = xb.shape
    block_n, splits = decode_plan(M, K, N, sm_count(xb.device.index), block_ns)
    if splits == 1:
        return (0, 0), (block_n, splits), ()
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=xb.device)
    counters = _split_counters(xb.device, N // block_n)
    return (ws.data_ptr(), counters.data_ptr()), (block_n, splits), (ws, counters)


def kernel_route(M: int) -> str:
    """K7's entry point for M rows: the split-K decode route
    (``int4_matmul``, ``csrc/int4_matmul.cu``) up to WGMMA_MIN_ROWS - 1 rows; the
    warp-specialised wgmma route (``int4_matmul_wgmma``,
    ``csrc/int4_matmul_sm90.cu``, 128-row tiles) from there on, prefill."""
    return "int4_matmul_wgmma" if M >= WGMMA_MIN_ROWS else "int4_matmul"


def int4_matmul(x2: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor, group: int,
                impl: str = "auto") -> torch.Tensor:
    """K7: (M, K) @ the packed (K/2, N) weight, bf16 out, by the route
    ``kernel_route(M)`` picks."""
    if not kernels.use_kernel(x2, impl):
        return int4_matmul_torch(x2, w_p, scale, group)
    if group != KERNEL_GROUP:
        raise ValueError(f"int4_matmul: group {group} not built; the kernel is built for "
                         f"{KERNEL_GROUP}")
    name = kernel_route(x2.shape[0])
    xb, out = _operands(name, x2, w_p, scale)
    (M, K), N = xb.shape, w_p.shape[1]
    if name == "int4_matmul_wgmma":
        kernels.launch(name, xb.data_ptr(), w_p.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K,
                       N, group)
        return out
    ptrs, plan, _keep = _plan_args(xb, N)
    kernels.launch(name, xb.data_ptr(), w_p.data_ptr(), scale.data_ptr(), out.data_ptr(), *ptrs,
                   M, K, N, group, *plan)
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
    K7's decode-route loads and products without the unpack or the scales."""
    if not kernels.use_kernel(x2, impl):
        return int4_matmul_stream_torch(x2, w_p)
    return _probe("int4_matmul_stream", x2, w_p)


def int4_matmul_convert(x2: torch.Tensor, w_p: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """K7a convert (``make_convert``; ``_convert_only_int4`` of
    scripts/profile_int4_pallas.py): K7 without the scales."""
    if not kernels.use_kernel(x2, impl):
        return int4_matmul_convert_torch(x2, w_p)
    return _probe("int4_matmul_convert", x2, w_p)


def _probe(name: str, x2: torch.Tensor, w_p: torch.Tensor) -> torch.Tensor:
    """A K7a probe: a mode of the decode route's kernel, on 128-column tiles
    and the decode plan's splits (up to 64 rows)."""
    xb, out = _operands(name, x2, w_p)
    (M, K), N = xb.shape, w_p.shape[1]
    ptrs, (_, splits), _keep = _plan_args(xb, N, block_ns=(128,))
    kernels.launch(name, xb.data_ptr(), w_p.data_ptr(), out.data_ptr(), *ptrs, M, K, N, splits)
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
