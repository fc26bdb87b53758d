"""K1/K2 (ViT window attention): the port's plain versions against the JAX
package's Pallas kernels (interpret mode) and XLA path on the CPU, and the
CUDA kernels against the plain versions on the card."""

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_BF16, ATOL_OP, cuda_device, normal, packed_ids, rng, row_ids

from open_o3_video_tpu_torch.ops import window_attention as twa

# (N, W, H, D, max windows per row): the slice's W = 64 and W = 128 packed
# rows, and W = 448, a whole 18x24-patch frame (not a power of two).
CASES = [(4, 64, 2, 16, 3), (3, 128, 2, 80, 2), (2, 448, 2, 16, 1)]


def _rope_tables(r, n, w, d):
    freqs = normal(r, n, w, d // 2, scale=3.0)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return freqs, np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


@pytest.mark.parametrize("n,w,h,d,maxw", CASES)
def test_window_attention_plain_matches_jax(n, w, h, d, maxw):
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.attention import segment_attention
    from open_o3_video_tpu.ops.window_attention import window_attention

    r = rng(n * w + d)
    q, k, v = (normal(r, n, w, h, d) for _ in range(3))
    ids = packed_ids(r, n, w, maxw)
    ours = twa.window_attention(*map(torch.from_numpy, (q, k, v, ids))).numpy()
    pallas = np.asarray(window_attention(*map(jnp.asarray, (q, k, v, ids)), True))
    xla = np.asarray(segment_attention(*map(jnp.asarray, (q, k, v, ids)), impl="xla"))
    keep = ids != 0
    np.testing.assert_allclose(ours[keep], pallas[keep], atol=ATOL_OP)
    np.testing.assert_allclose(ours[keep], xla[keep], atol=ATOL_OP)
    assert np.isfinite(ours).all()


@pytest.mark.parametrize("n,w,h,d,maxw", CASES)
def test_fused_window_attention_plain_matches_jax(n, w, h, d, maxw):
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.attention import segment_attention
    from open_o3_video_tpu.ops.rope import apply_rope_vision
    from open_o3_video_tpu.ops.window_attention import fused_window_attention

    r = rng(n * w + d + 1)
    qkv = normal(r, n, w, 3 * h * d)
    freqs, cos, sin = _rope_tables(r, n, w, d)
    ids = packed_ids(r, n, w, maxw)
    ours = twa.fused_window_attention(
        *map(torch.from_numpy, (qkv, cos, sin, ids)), h
    ).numpy()
    pallas = np.asarray(fused_window_attention(
        *map(jnp.asarray, (qkv, cos, sin, ids)), h, interpret=True
    ))
    x = jnp.asarray(qkv).reshape(n * w, 3, h, d)
    qr, kr = apply_rope_vision(x[:, 0], x[:, 1], jnp.asarray(freqs.reshape(n * w, -1)))
    xla = segment_attention(
        qr.reshape(n, w, h, d), kr.reshape(n, w, h, d), x[:, 2].reshape(n, w, h, d),
        jnp.asarray(ids), impl="xla",
    )
    xla = np.asarray(xla).reshape(n, w, h * d)
    keep = ids != 0
    np.testing.assert_allclose(ours[keep], pallas[keep], atol=ATOL_OP)
    np.testing.assert_allclose(ours[keep], xla[keep], atol=ATOL_OP)
    assert np.isfinite(ours).all()


def test_pure_padding_row_gives_zero():
    r = rng(3)
    q, k, v = (torch.from_numpy(normal(r, 2, 64, 2, 16)) for _ in range(3))
    ids = torch.zeros(2, 64, dtype=torch.int32)
    ids[1, :10] = 1
    out = twa.window_attention(q, k, v, ids)
    assert torch.equal(out[0], torch.zeros_like(out[0]))


def test_impl_torch_is_the_plain_version():
    r = rng(4)
    q, k, v = (torch.from_numpy(normal(r, 2, 64, 2, 16)) for _ in range(3))
    ids = torch.from_numpy(packed_ids(r, 2, 64))
    assert torch.equal(
        twa.window_attention(q, k, v, ids, impl="torch"),
        twa.window_attention_torch(q, k, v, ids),
    )
    with pytest.raises(ValueError):
        twa.window_attention(q, k, v, ids, impl="xla")


# ---- K1's and K6's grid at the packed row widths (csrc/window_row.cuh) ---


@pytest.mark.parametrize("n,heads", [(112, 16), (64, 16), (7, 6), (5, 3), (1, 1)])
def test_row_items_cover_each_row_and_head_once_in_order(n, heads):
    """The row kernels' n * heads CTAs take every (row, head) item once,
    row by row, heads in order: at the slice's N = 112 rows of W = 64 and 64
    rows of W = 128 (16 heads), and at row and head counts that are not
    powers of two."""
    assert twa.row_items(n, heads) == [(row, h) for row in range(n) for h in range(heads)]


# ---- on the card: kernel vs plain version, bf16 --------------------------

CUDA_CASES = [
    (112, 64, 16, 80, 3),  # the slice: 16 frames of 18x24 patches
    (5, 128, 2, 80, 2),
    (3, 100, 2, 80, 2),  # W off the 64-row tile
    (2, 448, 4, 80, 1),
    (3, 130, 2, 80, 2),
    (2, 700, 2, 80, 2),  # past K2's resident limit (640): K and V stream
    (2, 1024, 4, 80, 1),  # a whole frame of 32x32 patches
]

# K1's row kernels (W = 64 and 128) besides CUDA_CASES' (N, W, H, D, ids:
# max windows per row, "pads" or "four"); in every case the last head's v
# box runs past the row's end (the TMA fills it with zeros).
FUSED_CUDA_CASES = CUDA_CASES + [
    (64, 128, 16, 80, 3),  # 16 frames of 18x26 patches
    (5, 64, 3, 80, 3), (5, 128, 3, 80, 3),
    (3, 64, 16, 80, "pads"), (3, 128, 16, 80, "pads"),  # rows of pads only
    (4, 64, 16, 80, "four"), (4, 128, 16, 80, "four"),  # four packed windows a row
]


# K2 alone at Qwen3-VL's head_dim 72 (16 heads of 1152): whole frames of
# 16x22 patches (256x352 px at patch 16), resident, and of 28x28 patches
# (448x448 px), streamed. K1 is not built for 72.
K2_CASES = CUDA_CASES + [(16, 352, 16, 72, 1), (8, 784, 16, 72, 1)]


def _bf16(x, dev):
    return torch.from_numpy(x).to(dev, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,h,d,maxw", K2_CASES)
def test_window_attention_kernel_matches_plain(n, w, h, d, maxw):
    dev = cuda_device()
    r = rng(n + w + d)
    q, k, v = (_bf16(normal(r, n, w, h, d), dev) for _ in range(3))
    ids = torch.from_numpy(packed_ids(r, n, w, maxw)).to(dev)
    out = twa.window_attention(q, k, v, ids)
    ref = twa.window_attention_torch(q, k, v, ids)
    torch.cuda.synchronize()
    keep = ids != 0
    torch.testing.assert_close(out[keep].float(), ref[keep].float(), atol=ATOL_BF16, rtol=0)
    assert torch.isfinite(out.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,h,d,kind", FUSED_CUDA_CASES)
def test_fused_window_attention_kernel_matches_plain(n, w, h, d, kind):
    dev = cuda_device()
    r = rng(n + w + d + 1)
    qkv = _bf16(normal(r, n, w, 3 * h * d), dev)
    _, cos, sin = _rope_tables(r, n, w, d)
    cos, sin = (torch.from_numpy(x).to(dev) for x in (cos, sin))
    ids = torch.from_numpy(row_ids(r, n, w, kind)).to(dev)
    out = twa.fused_window_attention(qkv, cos, sin, ids, h)
    ref = twa.fused_window_attention_torch(qkv, cos, sin, ids, h)
    torch.cuda.synchronize()
    keep = ids != 0
    torch.testing.assert_close(out[keep].float(), ref[keep].float(), atol=ATOL_BF16, rtol=0)
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out[~keep], torch.zeros_like(out[~keep]))  # a pad row gives 0
