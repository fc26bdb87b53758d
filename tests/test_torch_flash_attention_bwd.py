"""K3's exact mode and K5 (the decoder's flash-attention backward): the
port's plain versions against the JAX package's Pallas kernels (interpret
mode, through ``jax.vjp``) and XLA path on the CPU, and the CUDA kernels
against the plain versions on the card."""

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_OP, assert_kernel_close, cuda_device, normal, rng

from open_o3_video_tpu_torch.ops import attention as tattn
from open_o3_video_tpu_torch.ops import flash_attention as tfa

# (B, S, T, Hq, Hkv, D): the decoder's head_dim and GQA group of 7, S and T
# off the 64-row kernel tile and the 16-row JAX test tile.
B, S, T, HQ, HKV, D = 2, 37, 45, 14, 2, 128


def _inputs(seed, pad_row=True):
    """Cache-shaped inputs; row 1 is left-padded by 5 and, with pad_row,
    its first 3 queries carry position -1 (they see nothing)."""
    r = rng(seed)
    q, dout = normal(r, B, S, HQ, D), normal(r, B, S, HQ, D)
    k, v = normal(r, B, T, HKV, D), normal(r, B, T, HKV, D)
    q_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    valid = np.zeros((B, T), np.int32)
    valid[:, :S] = 1
    if pad_row:
        valid[1, :5] = 0
        q_pos[1, :3] = -1
    return q, k, v, q_pos, valid, dout


def _jax_vjp(fn, q, k, v, dout):
    import jax
    import jax.numpy as jnp

    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(out), *map(np.asarray, vjp(jnp.asarray(dout))))


def _port_grads(q, k, v, q_pos, valid, dout, impl="auto"):
    qt, kt, vt = (torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention_gqa(qt, kt, vt, torch.from_numpy(q_pos), torch.from_numpy(valid),
                                  impl=impl)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(dout))
    return (out.detach().numpy(), *(g.numpy() for g in grads))


def test_exact_forward_and_lse_match_jax_kernel():
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.flash_attention import _fwd

    q, k, v, q_pos, valid, _ = _inputs(0)
    out, lse = tfa.flash_attention_gqa_exact(*map(torch.from_numpy, (q, k, v, q_pos, valid)))
    jout, jlse = _fwd(*map(jnp.asarray, (q, k, v, q_pos, valid)), 16, 16, True,
                      exact_softmax=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL_OP)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, :S, 0], rtol=1e-6, atol=ATOL_OP)
    # the pad queries see nothing: output 0 and lse NEG_INF, in both
    assert (out[1, :3] == 0).all() and (lse[1, :, :3] == tfa.NEG_INF).all()


def test_backward_matches_jax_kernel_vjp():
    from open_o3_video_tpu.ops.flash_attention import flash_attention_gqa

    q, k, v, q_pos, valid, dout = _inputs(1)
    theirs = _jax_vjp(lambda a, b, c: flash_attention_gqa(
        a, b, c, q_pos, valid, block_q=16, block_k=16, interpret=True), q, k, v, dout)
    ours = _port_grads(q, k, v, q_pos, valid, dout)
    for name, a, b in zip(("out", "dq", "dk", "dv"), ours, theirs):
        np.testing.assert_allclose(a, b, atol=ATOL_OP, err_msg=name)
    assert (ours[1][1, :3] == 0).all()  # no gradient into the pad queries


def test_backward_matches_jax_xla_grads():
    """Where every query sees a key, JAX's XLA attention differentiated by
    autodiff gives the same gradients."""
    from open_o3_video_tpu.ops.attention import causal_attention

    q, k, v, q_pos, valid, dout = _inputs(2, pad_row=False)
    theirs = _jax_vjp(lambda a, b, c: causal_attention(
        a, b, c, q_positions=q_pos, kv_mask=valid != 0, impl="xla"), q, k, v, dout)
    ours = _port_grads(q, k, v, q_pos, valid, dout)
    for name, a, b in zip(("out", "dq", "dk", "dv"), ours, theirs):
        np.testing.assert_allclose(a, b, atol=ATOL_OP, err_msg=name)


def test_plain_backward_equals_autograd_of_plain_forward_float64():
    """The written-out backward is the derivative of the exact forward: in
    float64 (no rounding casts) it equals torch.autograd through it."""
    q, k, v, q_pos, valid, dout = (torch.from_numpy(x) for x in _inputs(3))
    q, k, v, dout = (x.double() for x in (q, k, v, dout))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = tfa.flash_attention_gqa_exact_torch(*leaves, q_pos, valid)
    auto = torch.autograd.grad(out, leaves, dout)
    plain = tfa.flash_attention_gqa_bwd_torch(q, k, v, q_pos, valid, out.detach(), lse.detach(),
                                              dout)
    for name, a, b in zip(("dq", "dk", "dv"), plain, auto):
        torch.testing.assert_close(a, b, atol=1e-10, rtol=1e-10, msg=name)


def test_inference_calls_keep_the_fixed_m_forward():
    """Without autograd the dispatch runs the fixed-m forward; with it, the
    exact one. Under the clamp the two agree to rounding."""
    q, k, v, q_pos, valid, _ = (torch.from_numpy(x) for x in _inputs(4))
    fixed = tattn.causal_attention(q, k, v, q_positions=q_pos, kv_mask=valid != 0)
    assert torch.equal(fixed, tfa.flash_attention_gqa_torch(q, k, v, q_pos, valid))
    qg = q.clone().requires_grad_()
    exact = tattn.causal_attention(qg, k, v, q_positions=q_pos, kv_mask=valid != 0)
    assert exact.grad_fn is not None
    assert torch.equal(exact.detach(), tfa.flash_attention_gqa_exact_torch(q, k, v, q_pos, valid)[0])
    torch.testing.assert_close(exact.detach(), fixed, atol=ATOL_OP, rtol=0)


def test_dkv_wrapper_passes_a_float32_workspace(monkeypatch):
    """K5's dk/dv wrapper allocates the per-head float32 partials (2, B, T,
    Hq, D) and hands them to its one launch (stubbed here)."""
    from open_o3_video_tpu_torch.ops import kernels

    checked, launched = [], []
    monkeypatch.setattr(kernels, "check_tensor", lambda name, x, *rest: checked.append((name, x)))
    monkeypatch.setattr(kernels, "launch", lambda name, *args: launched.append((name, args)))
    bf = torch.bfloat16
    ops = (torch.zeros(B, S, HQ, D, dtype=bf), torch.zeros(B, T, HKV, D, dtype=bf),
           torch.zeros(B, T, HKV, D, dtype=bf), torch.zeros(B, S, HQ, D, dtype=bf),
           torch.zeros(B, HQ, S), torch.zeros(B, HQ, S), torch.zeros(B, S, dtype=torch.int32),
           torch.ones(B, T, dtype=torch.int32))
    dk, dv = tfa.flash_attention_gqa_bwd_dkv(ops)
    ws = [x for name, x in checked if "workspace" in name]
    assert len(ws) == 1 and ws[0].dtype == torch.float32
    assert tuple(ws[0].shape) == (2, B, T, HQ, D)
    assert len(launched) == 1 and launched[0][0] == "flash_attention_gqa_bwd_dkv"
    assert ws[0].data_ptr() in launched[0][1]
    assert dk.shape == dv.shape == (B, T, HKV, D) and dk.dtype == bf


# ---- on the card: kernel vs plain version, bf16 --------------------------

# (B, S, T, Hq, Hkv, left padding of row 1): the SFT slice's one packed
# example (S = T, right-padded keys), a small ragged case, and the 7B's 7
# heads per kv head with T off the 64-key tile (row 1's first positions -1).
CUDA_CASES = [(1, 3456, 3456, 28, 4, 0), (2, 77, 150, 14, 2, 9), (2, 200, 213, 28, 4, 13),
              (2, 700, 720, 16, 2, 21)]  # the last: a GQA group of 8


# dout at 0.1: gradients then stay under ~1 in magnitude, where one bf16 ulp
# (the kernels sum in another order than the plain version) is within the
# bound; at unit dout, dk/dv reach ~8, where one ulp is 2^-5.
DOUT_SCALE = 0.1


def _cuda_inputs(dev, B, S, T, Hq, Hkv, pad, layout="pad"):
    """layout "pad": positions 0..S-1, the first T - 50 keys valid, row 1
    left-padded by `pad` with its first 2 queries at -1. "offset": a chunk
    at the end of T (S < T), its positions with a hole every 37 rows and -1
    every 53rd row, row 1's in descending order, invalid keys every 128
    from 77 and row 1's last `pad` keys right-padded."""
    r = rng(S + T)
    q = torch.from_numpy(normal(r, B, S, Hq, 128)).to(dev, torch.bfloat16)
    do = torch.from_numpy(normal(r, B, S, Hq, 128, scale=DOUT_SCALE)).to(dev, torch.bfloat16)
    k, v = (torch.from_numpy(normal(r, B, T, Hkv, 128)).to(dev, torch.bfloat16) for _ in range(2))
    if layout == "offset":
        i = torch.arange(S, dtype=torch.int32, device=dev)
        pos = (T - S - S // 37 + i + i // 37).repeat(B, 1)
        pos[:, ::53] = -1
        pos[1] = pos[1].flip(0)
        valid = torch.ones((B, T), dtype=torch.int32, device=dev)
        valid[:, 77::128] = 0
        valid[1, T - pad:] = 0
        return q, k, v, pos.contiguous(), valid, do
    pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
    valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
    valid[:, :S - 50] = 1  # right padding, as pack_sft_batch lays rows out
    if B > 1:
        valid[1, :pad] = 0
        pos[1, :2] = -1
    return q, k, v, pos, valid, do


def _assert_exact_close(q, k, v, pos, valid):
    out, lse = tfa.flash_attention_gqa_exact(q, k, v, pos, valid)
    ref, ref_lse = tfa.flash_attention_gqa_exact_torch(q, k, v, pos, valid)
    torch.cuda.synchronize()
    assert_kernel_close(out, ref)
    seen = ref_lse > tfa.NEG_INF
    torch.testing.assert_close(lse[seen], ref_lse[seen], atol=1e-3, rtol=0)
    assert (lse[~seen] == tfa.NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,Hq,Hkv,pad", CUDA_CASES)
def test_exact_forward_kernel_matches_plain(B, S, T, Hq, Hkv, pad):
    dev = cuda_device()
    _assert_exact_close(*_cuda_inputs(dev, B, S, T, Hq, Hkv, pad)[:5])


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,Hq,Hkv,start,holes", [(512, 20480, 28, 4, 20000, False),
                                                     (128, 4096, 28, 4, 4096, False),
                                                     (200, 2048, 16, 2, 1900, True)])
def test_exact_forward_kernel_matches_plain_on_a_chunk(S, T, Hq, Hkv, start, holes):
    """The long-chunk-like case, all tiles interior, every tile masked (as
    in test_torch_flash_attention.py), with lse."""
    dev = cuda_device()
    q = torch.from_numpy(normal(rng(S), 1, S, Hq, 128)).to(dev, torch.bfloat16)
    k, v = (torch.from_numpy(normal(rng(T + i), 1, T, Hkv, 128)).to(dev, torch.bfloat16)
            for i in range(2))
    pos = torch.arange(start, start + S, dtype=torch.int32, device=dev)[None]
    valid = torch.ones((1, T), dtype=torch.int32, device=dev)
    if holes:
        valid[:, 77::128] = 0
    _assert_exact_close(q, k, v, pos, valid)


# The backward adds the edges of K5's dq (128 query rows of one head a CTA):
# the SFT shape (S = 3136, not a multiple of 128), a GQA group of 8 (64/8
# heads), and chunks at the end of T with holes, -1 rows, positions in
# descending order and right-padded keys.
BWD_CUDA_CASES = [(*c, "pad") for c in CUDA_CASES] + [
    (1, 3136, 3136, 28, 4, 0, "pad"), (2, 300, 300, 64, 8, 7, "pad"),
    (2, 300, 700, 28, 4, 20, "offset"), (2, 200, 1000, 64, 8, 40, "offset")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,Hq,Hkv,pad,layout", BWD_CUDA_CASES)
def test_backward_kernels_match_plain(B, S, T, Hq, Hkv, pad, layout):
    dev = cuda_device()
    q, k, v, pos, valid, do = _cuda_inputs(dev, B, S, T, Hq, Hkv, pad, layout)
    out, lse = tfa.flash_attention_gqa_exact_torch(q, k, v, pos, valid)
    got = tfa.flash_attention_gqa_bwd(q, k, v, pos, valid, out, lse, do)
    ref = tfa.flash_attention_gqa_bwd_torch(q, k, v, pos, valid, out, lse, do)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.isfinite(a.float()).all()
        assert_kernel_close(a, b)
    # dk/dv: per-head partials summed in a fixed order, no atomics
    again = tfa.flash_attention_gqa_bwd(q, k, v, pos, valid, out, lse, do)
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
