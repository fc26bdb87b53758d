"""GQA decode attention on the stored-dtype KV cache: K4.

Counterpart of ``open_o3_video_tpu/ops/decode_attention.py``. Layouts are
the JAX package's: q (B, S <= 8, Hq, D) in the compute dtype; k/v (B, T,
Hkv, D) in the cache's STORED dtype (bf16 or ``torch.float8_e4m3fn``), e.g.
strided layer views of the stacked (L, B, T, Hkv, D) cache; q_positions
(B, S); kv_valid (B, T). Key t is visible to a query iff ``t <= q_position``
and ``kv_valid[b, t]``; a query with no visible key (e.g. q_position -1)
returns 0. The kernel reads the decode step's own tensors as they are (q,
int64 positions, bool validity), so a step launches nothing around it;
other dtypes are converted first.

q is prescaled by D^-1/2 and rounded to its dtype, as for K3 (the kernel
does it as it loads q, to the same bits). The softmax is
the fixed-m inference form: ``p = exp(min(s, 60))``, p cast to q's dtype
before ``p @ v``, float32 accumulation, one division by l at the end.

The JAX kernel's TPU workarounds have no counterpart: its bit-moving e4m3
decode flushes denormals to zero and reads the NaN bytes as +-480, while
here e4m3 converts exactly (``.float()`` in the plain version, Hopper's
native conversion in the kernel), as the JAX package's exact path
``_decode_attention_chunked`` does.
"""

from __future__ import annotations

import torch

from . import kernels
from .flash_attention import flash_attention_gqa_torch

# The stored dtypes K4 is built for.
KV_DTYPES = (torch.bfloat16, torch.float8_e4m3fn)
# The kernel holds all G * S query rows of one kv head in one CTA.
MAX_ROWS = 64
# Its key tile (kTile in csrc/decode_attention.cu): the unit of the split
# plan and of the ring.
TILE_KEYS = 64
# Split-K: about this many CTAs over the card (two per SM of an H100's 132,
# as many as K4's registers let an SM hold: one wave), and at least this
# many keys per split.
SPLIT_CTAS = 264
MIN_SPLIT_KEYS = 256


def decode_attention_gqa_torch(q, k, v, q_positions, kv_valid):
    """Plain version of K4 on the whole layer at once: k/v converted to f32
    exactly, f32 scores, p cast to q's dtype before the PV product. At S = 1
    and T = 81920 the f32 scores of one batch row are ~9 MB. Returns
    (B, S, Hq, D) in q's dtype."""
    return flash_attention_gqa_torch(q, k, v, q_positions, kv_valid)


def _splits(B: int, Hkv: int, T: int) -> int:
    """Key-range splits per (batch row, kv head): fill the card, but give
    each split at least MIN_SPLIT_KEYS slots. Depends on shapes only, so
    the reduction order (and the result's bits) is the same on every run."""
    return max(1, min(SPLIT_CTAS // (B * Hkv), -(-T // MIN_SPLIT_KEYS)))


def split_tiles(n_tiles: int, splits: int) -> list[tuple[int, int]]:
    """The key tiles [tile0, tile1) of each split, as the kernel divides the
    n_tiles tiles of [0, max_pos] (``csrc/decode_attention.cu``); the splits
    are summed in this order."""
    return [(i * n_tiles // splits, (i + 1) * n_tiles // splits) for i in range(splits)]


def decode_attention_gqa(q, k, v, q_positions, kv_valid, impl: str = "auto"):
    """K4: GQA decode attention against a stored-dtype KV buffer. Returns
    (B, S, Hq, D) in q's dtype."""
    if not kernels.use_kernel(q, impl):
        return decode_attention_gqa_torch(q, k, v, q_positions, kv_valid)
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    kernels.check_head_dim("decode_attention_gqa", D, kernels.TEXT_HEAD_DIM)
    if Hq % Hkv or S * (Hq // Hkv) > MAX_ROWS:
        raise ValueError(f"{Hq} query heads over {Hkv} kv heads at S={S}: the kernel holds at "
                         f"most {MAX_ROWS} query rows per kv head")
    if k.dtype != v.dtype:
        raise TypeError(f"k and v must share a stored dtype, got {k.dtype} and {v.dtype}")
    qc = q.contiguous()
    pos = q_positions.to(torch.int64).contiguous()
    valid = (kv_valid if kv_valid.dtype == torch.bool else kv_valid != 0).contiguous()
    kernels.check_tensor("q", qc, torch.bfloat16, (B, S, Hq, D))
    kernels.check_tensor("q_positions", pos, torch.int64, (B, S))
    kernels.check_tensor("kv_valid", valid, torch.bool, (B, T))
    kernels.check_kv("k", k, (B, T, Hkv, D), KV_DTYPES)
    kernels.check_kv("v", v, (B, T, Hkv, D), KV_DTYPES)
    splits = _splits(B, Hkv, T)
    rows = S * (Hq // Hkv)
    part_acc = torch.empty((B, Hkv, splits, rows, D), dtype=torch.float32, device=q.device)
    part_l = torch.empty((B, Hkv, splits, rows), dtype=torch.float32, device=q.device)
    out = torch.empty_like(qc)
    kernels.launch(
        "decode_attention_gqa", qc.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        valid.data_ptr(), out.data_ptr(), part_acc.data_ptr(), part_l.data_ptr(),
        B, S, T, Hq, Hkv, D, int(k.dtype == torch.float8_e4m3fn), splits,
        k.stride(0), k.stride(1), v.stride(0), v.stride(1),
    )
    return out
