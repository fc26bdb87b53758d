"""The kernels at the shapes a tensor group hands each rank (``chip_smoke.py``
phase 24b), each against its plain version on the card (``cuda``; they
skip where there is no card):

- K1 (fused rope + window attention) and K2 (whole frames) at 8 and 4 of
  the 7B tower's 16 heads of 80 (tensor = 2, 4);
- K3 at the 7B's 14/2 and 7/1 heads and the 72B judge's 8/1 (tensor = 8);
- K4 at 7/1 heads over an fp8 cache past 32768 slots;
- K7 on the 72B down_w's column shard at tensor = 4 (N = 2048), at a
  decode and a prefill row count (its two routes).

Training on a mesh (phase 25b and 25d):

- K5 (K3's backward: dq; dk, dv) at the 7B's 14/2 and 7/1 heads;
- K6's fused backward at 8 and 4 of the tower's 16 heads (W = 64), and its
  whole-frame backward at 8 and 4 heads of 80 (W = 448) and of 72 (W =
  352);
- the ring's block calls, as ``ops/ring_attention.RingAttention`` makes
  them over two blocks in one process (K3 exact at shifted positions, the
  online-softmax combine, K5 with the combined output and lse), against
  the plain recurrence over the whole sequence (K3 exact's and K5's plain
  versions), forward and backward.

The bounds are the kernel tests' own (``_torch_parity``). Run on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_shard_kernels.py``.
"""

import numpy as np
import pytest
import torch

from _torch_parity import assert_kernel_close, cuda_device, normal, packed_ids, rng

from open_o3_video_tpu_torch.ops import decode_attention as tda
from open_o3_video_tpu_torch.ops import flash_attention as tfa
from open_o3_video_tpu_torch.ops import int4 as ti4
from open_o3_video_tpu_torch.ops import window_attention as twa


def _bf16(x, dev):
    return torch.from_numpy(x).to(dev, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [8, 4])
@pytest.mark.parametrize("w", [64, 448])
def test_tower_kernels_on_a_ranks_heads(heads, w):
    """W = 64: K1's window rows; W = 448: K2's frames (18 x 24 patches)."""
    dev = cuda_device()
    r = rng(heads + w)
    n, d = 24, 80
    ids = torch.from_numpy(packed_ids(r, n, w, 3 if w == 64 else 1)).to(dev)
    keep = ids != 0
    if w == 64:
        qkv = _bf16(normal(r, n, w, 3 * heads * d), dev)
        freqs = normal(r, n, w, d // 2, scale=3.0)
        emb = np.concatenate([freqs, freqs], -1)
        cos, sin = (torch.from_numpy(f(emb).astype(np.float32)).to(dev) for f in (np.cos, np.sin))
        out = twa.fused_window_attention(qkv, cos, sin, ids, heads)
        ref = twa.fused_window_attention_torch(qkv, cos, sin, ids, heads)
    else:
        q, k, v = (_bf16(normal(r, n, w, heads, d), dev) for _ in range(3))
        out = twa.window_attention(q, k, v, ids)
        ref = twa.window_attention_torch(q, k, v, ids)
    torch.cuda.synchronize()
    assert_kernel_close(out[keep], ref[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv", [(14, 2), (7, 1), (8, 1)])
def test_k3_on_a_ranks_heads(hq, hkv):
    dev = cuda_device()
    r = rng(hq)
    B, S, T = 2, 600, 640
    q = _bf16(normal(r, B, S, hq, 128), dev)
    k, v = (_bf16(normal(r, B, T, hkv, 128), dev) for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S).contiguous()
    valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
    valid[0, :S] = 1
    valid[1, 37:S] = 1  # a left-padded row
    out = tfa.flash_attention_gqa(q, k, v, pos, valid)
    ref = tfa.flash_attention_gqa_torch(q, k, v, pos, valid)
    torch.cuda.synchronize()
    keep = valid[:, :S] != 0
    assert_kernel_close(out[keep], ref[keep])


@pytest.mark.cuda
def test_k4_on_a_ranks_heads_over_fp8():
    dev = cuda_device()
    r = rng(4)
    T, last = 40960, 40900
    k, v = (_bf16(normal(r, 1, T, 1, 128), dev).to(torch.float8_e4m3fn) for _ in range(2))
    q = _bf16(normal(r, 1, 1, 7, 128), dev)
    pos = torch.full((1, 1), last, dtype=torch.int32, device=dev)
    valid = torch.zeros((1, T), dtype=torch.int32, device=dev)
    valid[:, :last + 1] = 1
    out = tda.decode_attention_gqa(q, k, v, pos, valid)
    ref = tda.decode_attention_gqa_torch(q, k, v, pos, valid)
    torch.cuda.synchronize()
    assert_kernel_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 200])
def test_k7_on_the_72b_down_shard(M):
    dev = cuda_device()
    K, N = 29568, 8192 // 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(M)
    w = ti4.quantize_weight_int4(torch.randn(K, N, generator=gen, device=dev) * (0.25 / K ** 0.5))
    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
    before = ti4.kernels.LAUNCHES[ti4.kernel_route(M)]
    out = ti4.int4_dense(x, w)
    assert ti4.kernels.LAUNCHES[ti4.kernel_route(M)] == before + 1  # K7, not a fallback
    ref = ti4.int4_matmul_torch(x, w.w_p, w.scale, w.group)
    torch.cuda.synchronize()
    assert_kernel_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv", [(14, 2), (7, 1)])
def test_k5_on_a_ranks_heads(hq, hkv):
    dev = cuda_device()
    r = rng(hq + 50)
    S = 700
    q, do = (_bf16(normal(r, 1, S, hq, 128), dev) for _ in range(2))
    k, v = (_bf16(normal(r, 1, S, hkv, 128), dev) for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].contiguous()
    valid = torch.ones((1, S), dtype=torch.int32, device=dev)
    valid[:, S - 40:] = 0  # right padding, as a packed SFT batch
    out, lse = tfa.flash_attention_gqa_exact(q, k, v, pos, valid)
    got = tfa.flash_attention_gqa_bwd(q, k, v, pos, valid, out, lse, do)
    want = tfa.flash_attention_gqa_bwd_torch(q, k, v, pos, valid, out, lse, do)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert_kernel_close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [8, 4])
@pytest.mark.parametrize("w,d", [(64, 80), (448, 80), (352, 72)])
def test_k6_on_a_ranks_heads(heads, w, d):
    """W = 64: the fused backward's window rows; else whole frames."""
    dev = cuda_device()
    r = rng(heads + w + d)
    n = 16
    ids = torch.from_numpy(packed_ids(r, n, w, 3 if w == 64 else 1)).to(dev)
    keep = ids != 0
    do = _bf16(normal(r, n, w, heads * d, scale=0.1), dev)
    do[~keep] = 0
    if w == 64:
        qkv = _bf16(normal(r, n, w, 3 * heads * d), dev)
        freqs = normal(r, n, w, d // 2, scale=3.0)
        emb = np.concatenate([freqs, freqs], -1)
        cos, sin = (torch.from_numpy(f(emb).astype(np.float32)).to(dev) for f in (np.cos, np.sin))
        got = twa.fused_window_attention_bwd(qkv, cos, sin, ids, heads, do)
        want = twa.fused_window_attention_bwd_torch(qkv, cos, sin, ids, heads, do)
        torch.cuda.synchronize()
        assert_kernel_close(got, want)
        return
    q, k, v = (_bf16(normal(r, n, w, heads, d), dev) for _ in range(3))
    do = do.view(n, w, heads, d)
    out, lse = twa.window_attention_exact(q, k, v, ids)
    got = twa.window_attention_bwd(q, k, v, ids, out, lse, do)
    want = twa.window_attention_bwd_torch(q, k, v, ids, do)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert_kernel_close(a, b)


@pytest.mark.cuda
def test_ring_block_calls_match_the_plain_recurrence():
    """Two blocks of 640 tokens at the 7B's 28/4 heads: block j's keys at
    positions j * 640 + t, every query meeting both blocks."""
    from open_o3_video_tpu_torch.ops.ring_attention import _combine

    dev = cuda_device()
    r = rng(77)
    S, n = 1280, 2
    h = S // n
    q, do = (_bf16(normal(r, 1, S, 28, 128), dev) for _ in range(2))
    k, v = (_bf16(normal(r, 1, S, 4, 128), dev) for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
    valid = torch.ones((1, S), dtype=torch.int32, device=dev)
    blocks = [(k[:, j * h:(j + 1) * h].contiguous(), v[:, j * h:(j + 1) * h].contiguous(),
               j * h) for j in range(n)]
    acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    lse = torch.full((1, 28, S), tfa.NEG_INF, dtype=torch.float32, device=dev)
    for kb, vb, start in blocks:
        o, lse_j = tfa.flash_attention_gqa_exact(q, kb, vb, pos - start, valid[:, :h])
        acc, lse = _combine(acc, lse, o, lse_j)
    out = acc.to(q.dtype)
    ref_out, ref_lse = tfa.flash_attention_gqa_exact_torch(q, k, v, pos, valid)
    torch.cuda.synchronize()
    assert_kernel_close(out, ref_out)
    torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=0)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    dkv = []
    for kb, vb, start in blocks:
        dq_j, dk_j, dv_j = tfa.flash_attention_gqa_bwd(q, kb, vb, pos - start, valid[:, :h], out,
                                                       lse, do)
        dq += dq_j.float()
        dkv.append((dk_j, dv_j))
    want = tfa.flash_attention_gqa_bwd_torch(q, k, v, pos, valid, ref_out, ref_lse, do)
    torch.cuda.synchronize()
    assert_kernel_close(dq, want[0])
    assert_kernel_close(torch.cat([x[0] for x in dkv], 1), want[1])
    assert_kernel_close(torch.cat([x[1] for x in dkv], 1), want[2])
