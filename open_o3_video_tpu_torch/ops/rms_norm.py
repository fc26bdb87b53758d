"""RMSNorm: the one norm of every decoder of the port (input, post and
final norms, Qwen3's per-head q/k norms, Kimi-VL's latent ``kv_norm``) and
of Qwen2.5-VL's tower, with its kernel (``csrc/rms_norm.cu``,
``o3v_rms_norm``) and its plain version.

The plain version is nine eager kernels (the cast to float32, pow, mean,
``+ eps``, rsqrt, mul, the weight's cast, mul, the cast back), each reading
and writing the activations through device memory; the kernel is one pass
a row that reads each input byte once and writes each output byte once,
with the same float32 operations in the same order (only the sum of
squares is taken in another order, so an output may differ from the plain
one by one bf16 ulp).

The kernel runs where :func:`kernel_takes` holds, from what the call can
see and nothing else: a CUDA bf16 ``x`` whose width is a multiple of 8 and
whose rows are evenly spaced and 16-byte aligned (a view such as
Kimi-VL's ``ckv[..., :512]``, rows 576 values apart, is read as it lies),
a bf16 or float32 weight, ``impl`` not "torch", and inference mode on
(``InferenceEngine.generate``). Every training forward, the CPU and a
``no_grad`` pass outside inference mode keep the plain version and its
numbers.

``LAUNCHES["rms_norm"]`` (``ops.kernels``) counts the kernel's launches.
"""

from __future__ import annotations

import torch

from . import kernels

CHUNK = 8  # bf16 values a 16-byte load carries
MAX_CHUNKS = 4  # chunks a thread holds (csrc/rms_norm.cu: kMaxChunks)
MAX_ROW_THREADS = 1024  # the widest group of threads a row
MAX_WIDTH = CHUNK * MAX_CHUNKS * MAX_ROW_THREADS
CTA_THREADS = 256  # threads a CTA where a row's group is narrower
SM_THREADS = 2048  # threads an SM holds at once
WEIGHT_DTYPES = (torch.bfloat16, torch.float32)


def rms_norm_torch(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The plain version, in float32, cast back to ``x``'s dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * weight.float()).to(x.dtype)


def row_stride(x: torch.Tensor) -> int | None:
    """The distance in elements between consecutive rows of ``x`` read as
    (rows, width), or None where its last axis is not contiguous or its rows
    are not evenly spaced. A single row reads as rows ``width`` apart."""
    if x.dim() == 0 or x.stride(-1) != 1:
        return None
    stride, span = None, None
    for size, st in zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])):
        if size == 1:
            continue
        if stride is None:
            stride = st
        elif st != span:
            return None
        span = st * size
    return x.shape[-1] if stride is None else stride


def supported(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """True where the kernel takes these tensors as they are (device aside)."""
    d = x.shape[-1] if x.dim() else 0
    stride = row_stride(x)
    return (x.dtype == torch.bfloat16 and 0 < d <= MAX_WIDTH and d % CHUNK == 0
            and x.numel() > 0 and stride is not None and stride % CHUNK == 0
            and x.data_ptr() % 16 == 0
            and weight.dtype in WEIGHT_DTYPES and tuple(weight.shape) == (d,)
            and weight.stride(0) == 1 and weight.data_ptr() % 16 == 0
            and weight.device == x.device)


def kernel_takes(x: torch.Tensor, weight: torch.Tensor, impl: str) -> bool:
    """True where the kernel normalises these inputs on the card: what the
    inputs show (device, dtypes, width, row layout), ``impl``, and inference
    mode, nothing else."""
    return (kernels.use_kernel(x, impl) and torch.is_inference_mode_enabled()
            and supported(x, weight))


def plan(rows: int, d: int, sms: int) -> tuple[int, int, int]:
    """(log2 of the threads a row, rows a CTA, CTAs) for ``rows`` rows of
    width ``d``. A row's group is the least power of two of threads that
    holds its 16-byte chunks at MAX_CHUNKS a thread. A CTA takes up to
    CTA_THREADS threads of rows, fewer where that would leave SMs without a
    CTA (a decode step's 8 rows spread over 8 SMs), in whole warps;
    the grid is at most what the SMs hold at once, and walks the rows."""
    groups = -(-(d // CHUNK) // MAX_CHUNKS)
    log2 = (groups - 1).bit_length()
    tpr = 1 << log2
    most, warp = max(1, CTA_THREADS // tpr), max(1, 32 // tpr)
    per_cta = min(most, -(-rows // (sms * warp)) * warp)  # whole warps
    ctas = -(-rows // per_cta)
    return log2, per_cta, min(ctas, sms * max(1, SM_THREADS // (per_cta * tpr)))


def rms_norm_kernel(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel on ``x`` (any leading shape, rows evenly spaced) and
    ``weight`` (width,); a new contiguous bf16 tensor of ``x``'s shape."""
    if not (x.is_cuda and supported(x, weight)):
        raise ValueError(f"rms_norm: the kernel takes a CUDA bf16 x of a width that is a "
                         f"multiple of {CHUNK} up to {MAX_WIDTH}, 16-byte aligned rows evenly "
                         f"spaced, and a contiguous bf16 or float32 weight of that width; got "
                         f"{x.device} {x.dtype} {tuple(x.shape)} strides {x.stride()}, weight "
                         f"{weight.device} {weight.dtype} {tuple(weight.shape)}")
    d = x.shape[-1]
    rows = x.numel() // d
    log2, per_cta, grid = plan(rows, d, kernels.sm_count(x.device.index or 0))
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    kernels.launch("rms_norm", x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d,
                   row_stride(x), int(weight.dtype == torch.float32), float(eps), log2, per_cta,
                   grid)
    return out


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             impl: str = "auto") -> torch.Tensor:
    """RMSNorm over the last axis: the kernel where :func:`kernel_takes`
    holds, else the plain version."""
    if kernel_takes(x, weight, impl):
        return rms_norm_kernel(x, weight, eps)
    return rms_norm_torch(x, weight, eps)
