"""K3 (causal GQA flash attention, prefill): the port's plain version against
the JAX package's Pallas kernel (interpret mode) and XLA path on the CPU, and
the CUDA kernel against the plain version on the card."""

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_BF16, ATOL_OP, assert_kernel_close, cuda_device, normal, rng

from open_o3_video_tpu_torch.ops import attention as tattn
from open_o3_video_tpu_torch.ops import flash_attention as tfa


def _inputs(r, B, S, T, Hq, Hkv, D, left_pad):
    """Cache-shaped inputs: the S queries sit at the end of a T-slot buffer
    (prefill into a longer cache); row b is left-padded by left_pad[b]."""
    q = normal(r, B, S, Hq, D)
    k = normal(r, B, T, Hkv, D)
    v = normal(r, B, T, Hkv, D)
    q_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    valid = np.zeros((B, T), np.int32)
    valid[:, :S] = 1
    for b, p in enumerate(left_pad):
        valid[b, :p] = 0
    return q, k, v, q_pos, valid


# (B, S, T, Hq, Hkv, D, left padding per row): GQA group 7 at small width,
# a left-padded batch, T > S, and S/T off the 16-row JAX test tile.
CASES = [
    (2, 21, 37, 14, 2, 16, (0, 5)),
    (2, 33, 50, 4, 2, 32, (3, 0)),
]


@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,pad", CASES)
def test_flash_plain_matches_jax(B, S, T, Hq, Hkv, D, pad):
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.attention import causal_attention
    from open_o3_video_tpu.ops.flash_attention import flash_attention_gqa

    q, k, v, q_pos, valid = _inputs(rng(S * T), B, S, T, Hq, Hkv, D, pad)
    ours = tfa.flash_attention_gqa(*map(torch.from_numpy, (q, k, v, q_pos, valid))).numpy()
    pallas = np.asarray(flash_attention_gqa(
        *map(jnp.asarray, (q, k, v, q_pos, valid)), block_q=16, block_k=16, interpret=True
    ))
    xla = np.asarray(causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=jnp.asarray(q_pos),
        kv_mask=jnp.asarray(valid != 0), impl="xla",
    ))
    keep = valid[:, :S] != 0  # query rows that are real tokens
    np.testing.assert_allclose(ours[keep], pallas[keep], atol=ATOL_OP)
    np.testing.assert_allclose(ours[keep], xla[keep], atol=ATOL_OP)
    # causal_attention dispatches S > 8 to the same plain version
    via_dispatch = tattn.causal_attention(
        *map(torch.from_numpy, (q, k, v)), q_positions=torch.from_numpy(q_pos),
        kv_mask=torch.from_numpy(valid != 0),
    ).numpy()
    np.testing.assert_array_equal(via_dispatch, ours)


def test_fully_masked_row_gives_zero():
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.flash_attention import flash_attention_gqa

    q, k, v, q_pos, valid = _inputs(rng(7), 2, 20, 20, 14, 2, 16, (0, 0))
    q_pos[1, :4] = -1  # pad queries see no key
    valid[0, :] = 0  # a row with no valid key at all
    ours = tfa.flash_attention_gqa(*map(torch.from_numpy, (q, k, v, q_pos, valid))).numpy()
    pallas = np.asarray(flash_attention_gqa(
        *map(jnp.asarray, (q, k, v, q_pos, valid)), block_q=16, block_k=16, interpret=True
    ))
    assert (ours[0] == 0).all() and (ours[1, :4] == 0).all()
    np.testing.assert_allclose(ours, pallas, atol=ATOL_OP)


def test_decode_path_matches_jax_xla():
    """S <= 8 runs the plain grouped decode, as JAX's XLA path does."""
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.attention import causal_attention

    r = rng(11)
    B, S, T, Hq, Hkv, D = 2, 1, 40, 14, 2, 16
    q, k, v = normal(r, B, S, Hq, D), normal(r, B, T, Hkv, D), normal(r, B, T, Hkv, D)
    q_pos = np.array([[30], [39]], np.int32)
    valid = np.ones((B, T), bool)
    valid[0, :6] = False
    ours = tattn.causal_attention(
        *map(torch.from_numpy, (q, k, v)), q_positions=torch.from_numpy(q_pos),
        kv_mask=torch.from_numpy(valid),
    ).numpy()
    ref = np.asarray(causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=jnp.asarray(q_pos),
        kv_mask=jnp.asarray(valid), impl="xla",
    ))
    np.testing.assert_allclose(ours, ref, atol=ATOL_OP)


# ---- K3's schedule (host side of csrc/flash_attention.cu) ------------------


@pytest.mark.parametrize("B,S,Hq", [(2, 300, 28), (4, 990, 64), (1, 1, 4), (3, 129, 8),
                                    (1, 8160, 28)])
def test_k3_schedule_covers_each_query_row_and_head_once(B, S, Hq):
    """Every (batch row, head, query row) falls to exactly one CTA, and the
    last query tiles (the longest) come first."""
    plan = tfa.cta_plan(B, S, Hq)
    assert len(plan) == len(set(plan))
    rows = [(b, h, r0 + i) for b, h, r0 in plan for i in range(tfa.CTA_ROWS) if r0 + i < S]
    assert sorted(rows) == [(b, h, s) for b in range(B) for h in range(Hq) for s in range(S)]
    first = [r0 for _, _, r0 in plan]
    assert first == sorted(first, reverse=True)


@pytest.mark.parametrize("source", ["flash_attention.cu", "flash_attention_bwd.cu"])
def test_cta_plan_rows_match_the_kernels(source):
    """cta_plan mirrors the CTA order of K3 and of K5's dq kernel, both from
    csrc/causal_cta.cuh: two consumer warpgroups of kWgRows query rows a
    CTA, the last (longest) query tiles first."""
    import re
    from pathlib import Path

    csrc = Path(tfa.__file__).parents[1] / "csrc"
    assert '#include "causal_cta.cuh"' in (csrc / source).read_text()
    assert "cta_work(s_len, hq)" in (csrc / source).read_text()
    header = (csrc / "causal_cta.cuh").read_text()
    rows = re.findall(r"constexpr int kWgRows = (\d+);", header)
    assert len(rows) == 1 and 2 * int(rows[0]) == tfa.CTA_ROWS
    assert "const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / units;" in header


# ---- on the card: kernel vs plain version, bf16 --------------------------

CUDA_CASES = [
    (2, 1980, 2048, 28, 4, 128, (0, 130)),  # the slice's prefill shape
    (2, 77, 150, 14, 2, 128, (0, 9)),  # S, T off the 64-row tile
    (1, 64, 64, 4, 4, 128, (0,)),  # no grouping
    (3, 130, 130, 8, 2, 128, (1, 64, 129)),
    (4, 990, 1054, 64, 8, 128, (0, 6, 11, 3)),  # the 72B judge's group of 8
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,pad", CUDA_CASES)
def test_flash_kernel_matches_plain(B, S, T, Hq, Hkv, D, pad):
    dev = cuda_device()
    q, k, v, q_pos, valid = _inputs(rng(S + T), B, S, T, Hq, Hkv, D, pad)
    q_pos[0, :2] = -1
    # k/v as strided views of a longer stacked (L, B, T', Hkv, D) cache
    cache = torch.zeros((3, 2, B, T + 16, Hkv, D), dtype=torch.bfloat16, device=dev)
    cache[1, 0, :, :T] = torch.from_numpy(k).to(dev, torch.bfloat16)
    cache[1, 1, :, :T] = torch.from_numpy(v).to(dev, torch.bfloat16)
    kv, vv = cache[1, 0, :, :T], cache[1, 1, :, :T]
    qd = torch.from_numpy(q).to(dev, torch.bfloat16)
    pos = torch.from_numpy(q_pos).to(dev)
    val = torch.from_numpy(valid).to(dev)
    out = tfa.flash_attention_gqa(qd, kv, vv, pos, val)
    ref = tfa.flash_attention_gqa_torch(qd, kv, vv, pos, val)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL_BF16, rtol=0)
    assert (out[0, :2] == 0).all()


def _chunk_inputs(dev, r, S, T, Hq, Hkv, start, holes):
    """One row of S queries at positions start .. start + S - 1 against a
    T-slot buffer (a prefill chunk of a long prompt); with holes, every
    128-key tile has an invalid key, so no tile takes the unmasked path."""
    q = torch.from_numpy(normal(r, 1, S, Hq, 128)).to(dev, torch.bfloat16)
    k, v = (torch.from_numpy(normal(r, 1, T, Hkv, 128)).to(dev, torch.bfloat16) for _ in range(2))
    pos = torch.arange(start, start + S, dtype=torch.int32, device=dev)[None]
    valid = torch.ones((1, T), dtype=torch.int32, device=dev)
    if holes:
        valid[:, 77::128] = 0
    return q, k, v, pos, valid


# (S, T, Hq, Hkv, first position, holes): a long-chunk-like case (the last
# chunk of a long prompt, cut), one whose key tiles are all interior, and
# one whose every tile is masked.
CHUNK_CASES = [(512, 20480, 28, 4, 20000, False), (128, 4096, 28, 4, 4096, False),
               (200, 2048, 16, 2, 1900, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,Hq,Hkv,start,holes", CHUNK_CASES)
def test_flash_kernel_matches_plain_on_a_chunk(S, T, Hq, Hkv, start, holes):
    dev = cuda_device()
    q, k, v, pos, valid = _chunk_inputs(dev, rng(S + T), S, T, Hq, Hkv, start, holes)
    out = tfa.flash_attention_gqa(q, k, v, pos, valid)
    ref = tfa.flash_attention_gqa_torch(q, k, v, pos, valid)
    torch.cuda.synchronize()
    assert_kernel_close(out, ref)
