"""K3 (causal GQA flash attention, prefill): the port's plain version against
the JAX package's Pallas kernel (interpret mode) and XLA path on the CPU, and
the CUDA kernel against the plain version on the card."""

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_BF16, ATOL_OP, cuda_device, normal, rng

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


# ---- on the card: kernel vs plain version, bf16 --------------------------

CUDA_CASES = [
    (2, 1980, 2048, 28, 4, 128, (0, 130)),  # the slice's prefill shape
    (2, 77, 150, 14, 2, 128, (0, 9)),  # S, T off the 64-row tile
    (1, 64, 64, 4, 4, 128, (0,)),  # no grouping
    (3, 130, 130, 8, 2, 128, (1, 64, 129)),
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
