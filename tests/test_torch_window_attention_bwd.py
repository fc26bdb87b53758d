"""K1/K2's exact modes and K6 (the ViT window-attention backward): the
port's plain versions against the JAX package's Pallas kernels (interpret
mode, through ``jax.vjp``) on the CPU, and the CUDA kernels against the
plain versions on the card."""

import numpy as np
import pytest
import torch

from _torch_parity import (ATOL_OP, assert_kernel_close, cuda_device, normal, packed_ids, rng,
                           row_ids)

from open_o3_video_tpu_torch.ops import window_attention as twa

# (N, W, H, D, max windows per row): the vision head_dim 80 at the packed
# W = 64 rows, and a W = 80 whole-frame row (not a multiple of 64).
CASES = [(4, 64, 2, 80, 3), (3, 80, 2, 80, 1)]


def _rope_tables(r, n, w, d):
    freqs = normal(r, n, w, d // 2, scale=3.0)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def _zero_pad_rows(dout, ids):
    """The tower never reads a pad row's output, so its gradient is 0."""
    dout = dout.copy()
    dout[ids == 0] = 0
    return dout


@pytest.mark.parametrize("n,w,h,d,maxw", CASES)
def test_window_backward_matches_jax_kernel_vjp(n, w, h, d, maxw):
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.window_attention import window_attention

    r = rng(n * w + d)
    q, k, v, dout = (normal(r, n, w, h, d) for _ in range(4))
    ids = packed_ids(r, n, w, maxw)
    jout, vjp = jax.vjp(lambda a, b, c: window_attention(a, b, c, jnp.asarray(ids), True),
                        *map(jnp.asarray, (q, k, v)))
    theirs = [np.asarray(jout), *map(np.asarray, vjp(jnp.asarray(dout)))]
    leaves = [torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v)]
    out = twa.window_attention(*leaves, torch.from_numpy(ids))
    ours = [out.detach().numpy(), *(g.numpy() for g in torch.autograd.grad(
        out, leaves, torch.from_numpy(dout)))]
    # pad rows included: with a finite NEG_INF both attend uniformly there
    for name, a, b in zip(("out", "dq", "dk", "dv"), ours, theirs):
        np.testing.assert_allclose(a, b, atol=ATOL_OP, err_msg=name)
    lse = twa.window_attention_exact_torch(*map(torch.from_numpy, (q, k, v, ids)))[1]
    assert torch.isfinite(lse).all()


# Whole frames at the towers' head_dims: 72 (Qwen3-VL) and 80 (Qwen2-VL,
# Qwen2.5-VL's global blocks); (N, W, H, D, padded tail of frame 0).
FRAME_CASES = [(3, 80, 2, 72, 9), (2, 100, 2, 72, 0), (3, 80, 2, 80, 9)]


@pytest.mark.parametrize("n,w,h,d,tail", FRAME_CASES)
def test_exact_frames_match_jax_segment_attention_and_vjp(n, w, h, d, tail):
    """K2's exact mode (out and lse) and K6 (dq, dk, dv) at whole frames:
    out and the gradients against JAX's Pallas kernel (interpret mode)
    through ``jax.vjp``, lse against the log-sum-exp of JAX's masked
    scores; to ATOL_OP (float32 sums in another order)."""
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.window_attention import window_attention

    r = rng(n * w + d + 7)
    q, k, v, dout = (normal(r, n, w, h, d) for _ in range(4))
    ids = np.ones((n, w), np.int32)
    ids[0, w - tail:] = 0
    jq, jk, jv, jids = map(jnp.asarray, (q, k, v, ids))
    jout, vjp = jax.vjp(lambda a, b, c: window_attention(a, b, c, jids, True), jq, jk, jv)
    s = jnp.einsum("nqhd,nkhd->nhqk", jq, jk) * d ** -0.5
    seen = (jids[:, None, :, None] == jids[:, None, None, :]) & (jids[:, None, None, :] != 0)
    # a pad row sees no key: its lse is that of all W keys at score 0
    jlse = jnp.where(jids[:, None, :] != 0,
                     jax.nn.logsumexp(jnp.where(seen, s, -jnp.inf), axis=-1), np.log(w))
    theirs = [np.asarray(jout), *map(np.asarray, vjp(jnp.asarray(dout)))]
    leaves = [torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v)]
    out = twa.window_attention(*leaves, torch.from_numpy(ids))
    ours = [out.detach().numpy(), *(g.numpy() for g in torch.autograd.grad(
        out, leaves, torch.from_numpy(dout)))]
    for name, a, b in zip(("out", "dq", "dk", "dv"), ours, theirs):
        np.testing.assert_allclose(a, b, atol=ATOL_OP, err_msg=name)
    _, lse = twa.window_attention_exact_torch(*map(torch.from_numpy, (q, k, v, ids)))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL_OP)


@pytest.mark.parametrize("n,w,h,d,maxw", CASES)
def test_fused_backward_matches_jax_kernel_vjp(n, w, h, d, maxw):
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.window_attention import fused_window_attention

    r = rng(n * w + d + 1)
    qkv = normal(r, n, w, 3 * h * d)
    cos, sin = _rope_tables(r, n, w, d)
    ids = packed_ids(r, n, w, maxw)
    dout = normal(r, n, w, h * d)
    jc, js, ji = map(jnp.asarray, (cos, sin, ids))
    jout, vjp = jax.vjp(lambda x: fused_window_attention(x, jc, js, ji, h, interpret=True),
                        jnp.asarray(qkv))
    (jd,) = vjp(jnp.asarray(dout))
    x = torch.from_numpy(qkv.copy()).requires_grad_()
    out = twa.fused_window_attention(x, *map(torch.from_numpy, (cos, sin, ids)), h)
    (dx,) = torch.autograd.grad(out, x, torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=ATOL_OP)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jd), atol=ATOL_OP)
    # the tower's case, no gradient at pad rows: dqkv is finite and zero at
    # every pad row
    dz = twa.fused_window_attention_bwd_torch(
        *map(torch.from_numpy, (qkv, cos, sin, ids)), h,
        torch.from_numpy(_zero_pad_rows(dout, ids)))
    assert torch.isfinite(dz).all()
    assert (dz[torch.from_numpy(ids) == 0] == 0).all()


def test_fused_equals_unfused_exact_path():
    """K1's exact mode equals rope + K2's exact mode, forward and backward."""
    n, w, h, d = 3, 64, 2, 80
    r = rng(5)
    qkv = torch.from_numpy(normal(r, n, w, 3 * h * d))
    cos, sin = map(torch.from_numpy, _rope_tables(r, n, w, d))
    ids = torch.from_numpy(packed_ids(r, n, w, 2))
    a = twa.fused_window_attention_exact_torch(qkv, cos, sin, ids, h)
    q, k, v = twa._rope_qk(qkv, cos, sin, h)
    b = twa.window_attention_exact_torch(q, k, v, ids)[0].reshape(n, w, -1)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


# ---- on the card: kernel vs plain version, bf16 --------------------------
# dout at 0.1, so gradients stay under ~1, where one bf16 ulp is within the
# bound (see test_torch_flash_attention_bwd.py).

def _vision_inputs(dev, r, n, w, h, kind=2):
    d = 80
    cos, sin = (torch.from_numpy(x).to(dev) for x in _rope_tables(r, n, w, d))
    ids = torch.from_numpy(row_ids(r, n, w, kind)).to(dev)
    return cos, sin, ids


# K1's exact mode and K6's fused backward, the row kernels: (N, W, H, ids:
# max windows per row, "pads" or "four"). In every case the last head's v
# and dout boxes run past the row's end (the TMA fills them with zeros).
FUSED_CUDA_CASES = [
    (40, 64, 16, 2), (40, 128, 16, 2),
    (112, 64, 16, 3),  # the SFT step: 16 frames of 18x24 patches
    (64, 128, 16, 3),  # 16 frames of 18x26
    (5, 64, 3, 3), (5, 128, 3, 3),
    (3, 64, 16, "pads"), (3, 128, 16, "pads"),  # rows of pads only
    (4, 64, 16, "four"), (4, 128, 16, "four"),  # four packed windows a row
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,h,kind", FUSED_CUDA_CASES)
def test_fused_kernels_match_plain(n, w, h, kind):
    """Every row compared (a pad row attends uniformly in exact mode), dout
    kept at pad rows so that a row of pads only has a gradient too."""
    dev = cuda_device()
    r = rng(n * w + h)
    cos, sin, ids = _vision_inputs(dev, r, n, w, h, kind)
    qkv = torch.from_numpy(normal(r, n, w, 3 * h * 80)).to(dev, torch.bfloat16)
    dout = torch.from_numpy(normal(r, n, w, h * 80, scale=0.1)).to(dev, torch.bfloat16)
    out = twa.fused_window_attention_exact(qkv, cos, sin, ids, h)
    ref = twa.fused_window_attention_exact_torch(qkv, cos, sin, ids, h)
    got = twa.fused_window_attention_bwd(qkv, cos, sin, ids, h, dout)
    want = twa.fused_window_attention_bwd_torch(qkv, cos, sin, ids, h, dout)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and torch.isfinite(got.float()).all()
    assert_kernel_close(out, ref)
    assert_kernel_close(got, want)
    hd = h * 80
    for part in range(3):  # the last head's dq, dk, dv
        cols = slice(part * hd + hd - 80, part * hd + hd)
        assert_kernel_close(got[..., cols], want[..., cols])


def _frame_kernel_case(w, d, n=6, h=16, scale_odd=1.0):
    """K2's exact mode and K6's dq and dk/dv at whole frames of width w
    (frame 0 with a padded tail), head_dim d: against their plain versions,
    or, with the odd heads' q, k, v, dout scaled by ``scale_odd`` != 1 (whose
    outputs leave the bound's unit scale), run only. Returns the kernels'
    (out, lse, dq, dk, dv)."""
    dev = cuda_device()
    r = rng(w + d)
    q, k, v = (torch.from_numpy(normal(r, n, w, h, d)).to(dev, torch.bfloat16) for _ in range(3))
    do = torch.from_numpy(normal(r, n, w, h, d, scale=0.1)).to(dev, torch.bfloat16)
    for x in (q, k, v, do):
        x[:, :, 1::2] *= scale_odd
    ids = torch.ones((n, w), dtype=torch.int32, device=dev)
    ids[0, w - 30:] = 0  # a frame's padded tail
    do[ids == 0] = 0
    keep = ids != 0
    out, lse = twa.window_attention_exact(q, k, v, ids)
    got = twa.window_attention_bwd(q, k, v, ids, out, lse, do)
    torch.cuda.synchronize()
    for a in (out, *got):
        assert torch.isfinite(a.float()).all()
    if scale_odd == 1.0:
        ref, ref_lse = twa.window_attention_exact_torch(q, k, v, ids)
        assert_kernel_close(out[keep], ref[keep])
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
        for a, b in zip(got, twa.window_attention_bwd_torch(q, k, v, ids, do)):
            assert_kernel_close(a, b)
    return (out, lse, *got)


@pytest.mark.cuda
# 448: the slice's frames; 576 and 640: the largest frames that K6's dk/dv
# and dq (and K2) keep resident; 704 and 1024 stream; 100: one ragged tile.
@pytest.mark.parametrize("w", [448, 100, 1024, 576, 640, 704])
def test_window_kernels_match_plain(w):
    _frame_kernel_case(w, 80)


@pytest.mark.cuda
# Qwen3-VL-8B's frames at head_dim 72: W = 352 (16x22 patches) resident, 784
# (28x28) streamed; 768 the widest that K2 and K6 keep resident; 100 one
# ragged tile.
@pytest.mark.parametrize("w", [352, 784, 768, 100])
def test_window_kernels_match_plain_at_72(w):
    """At 72 a tile holds the head's own 72 columns: with the odd heads'
    inputs scaled by 8, every output of the even heads (out, lse, dq, dk,
    dv) stays bit-equal."""
    base = _frame_kernel_case(w, 72)
    loud = _frame_kernel_case(w, 72, scale_odd=8.0)
    for a, b in zip(base, loud):
        even = slice(0, None, 2)
        a, b = (x[:, even] if x.dim() == 3 else x[:, :, even] for x in (a, b))
        assert torch.equal(a, b)
