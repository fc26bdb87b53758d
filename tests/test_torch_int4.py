"""K7, the int4 weight-only matmul (open_o3_video_tpu_torch/ops/int4.py),
against the JAX package's ops/int4.py on the same numpy weights: packing
byte for byte, the kernel's plain version against JAX's Pallas kernel in
interpret mode (within one bf16 ulp), JAX's ineligible-shape fallback, and
``quantize_params_int4``. The ``cuda`` tests hold K7 and the two K7a probes
against their plain versions on the card."""

import numpy as np
import pytest
import torch

from _torch_parity import assert_kernel_close, cuda_device, normal, rng

from open_o3_video_tpu_torch.ops import int4 as T


def _weight(r, K, N, kind):
    """(K, N) float32 weights: random, or with planted rounding ties (a
    group whose absmax is 7, so scale 1 and the codes land on .5) and an
    all-zero group."""
    w = normal(r, K, N, scale=0.05)
    if kind == "ties":
        w[:128, 0] = np.tile([7.0, 0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, -3.5, -7.0, 6.5, -6.5,
                              4.5, -4.5, 5.5, -5.5], 8)
        w[128:256, 1] = 0.0
    return w


def _pair(w, group=128):
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.int4 import quantize_weight_int4

    return quantize_weight_int4(jnp.asarray(w), group), T.quantize_weight_int4(torch.from_numpy(w),
                                                                                group)


@pytest.mark.parametrize("K,N,group,kind", [(384, 256, 128, "random"), (256, 128, 128, "ties"),
                                            (256, 64, 32, "random")])
def test_quantize_weight_int4_bytes_equal_jax(K, N, group, kind):
    jq, tq = _pair(_weight(rng(0), K, N, kind), group)
    assert tq.w_p.dtype == torch.int8 and tuple(tq.w_p.shape) == (K // 2, N)
    assert tq.scale.dtype == torch.float32 and tuple(tq.scale.shape) == (K // group, N)
    np.testing.assert_array_equal(tq.w_p.numpy(), np.asarray(jq.w_p))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert tq.shape == tuple(jq.shape) and tq.group == jq.group


def test_dequantize_equals_jax():
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.int4 import _unpack_int4_xla

    jq, tq = _pair(_weight(rng(1), 256, 128, "ties"))
    np.testing.assert_array_equal(T.dequantize(tq, torch.float32).numpy(),
                                  np.asarray(_unpack_int4_xla(jq, jnp.float32)))
    codes = T.unpack(tq.w_p)
    assert int(codes.min()) >= -7 and int(codes.max()) <= 7


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    return np.spacing(np.abs(x).astype(np.float32)) * 2.0 ** 16


@pytest.mark.parametrize("N", [128, 384])
@pytest.mark.parametrize("M", [1, 5, 17, 300])
def test_plain_kernel_matches_jax_interpret(M, N):
    """The kernel route rounds x and the output to bf16 (JAX's out_shape is
    bf16 even for float32 x); sums in another order may round one output
    element to the neighbouring bf16 value."""
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.int4 import int4_dense

    r = rng(M * 1000 + N)
    jq, tq = _pair(_weight(r, 256, N, "random"))
    x = normal(r, M, 256)
    ours = T.int4_dense(torch.from_numpy(x), tq).numpy()
    theirs = np.asarray(int4_dense(jnp.asarray(x), jq, interpret=True))
    assert ours.dtype == np.float32 and ours.shape == theirs.shape == (M, N)
    np.testing.assert_array_equal(ours, ours.astype(jnp.bfloat16).astype(np.float32))
    assert (np.abs(ours - theirs) <= _bf16_ulp(theirs)).all()


@pytest.mark.parametrize("N,group", [(64, 128), (128, 24)])
def test_ineligible_fallback_matches_jax_cpu(N, group):
    """N not a multiple of 128, or a group whose half is not a multiple of 8:
    JAX's x @ dequantize(w, x.dtype) on every device."""
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.int4 import int4_dense

    r = rng(7)
    jq, tq = _pair(_weight(r, 384, N, "random"), group)
    assert not T.kernel_eligible(N, group)
    x = normal(r, 3, 5, 384)
    np.testing.assert_allclose(T.int4_dense(torch.from_numpy(x), tq).numpy(),
                               np.asarray(int4_dense(jnp.asarray(x), jq)), atol=1e-5, rtol=0)


def test_kernel_route_raises_under_autograd():
    tq = T.quantize_weight_int4(torch.randn(256, 128))
    x = torch.randn(2, 256, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        T.int4_dense(x, tq)
    with torch.no_grad():
        assert T.int4_dense(x, tq).shape == (2, 128)


def test_quantize_params_int4_matches_jax():
    """The decoder matmuls and the lm_head quantize (group 32 at tiny dims),
    everything else is left as it was; bytes equal JAX's."""
    from _torch_parity import jax_params_numpy, tiny_configs

    from open_o3_video_tpu.ops.int4 import Int4Linear as JaxInt4
    from open_o3_video_tpu.ops.int4 import quantize_params_int4 as jax_quantize
    from open_o3_video_tpu_torch.models.qwen25vl import params as TP

    jcfg, tcfg = tiny_configs()
    tree = jax_params_numpy(jcfg)
    theirs = jax_quantize(tree, group=32)
    ours = T.quantize_params_int4(TP.from_jax_params(tree, tcfg, torch.device("cpu")), group=32)
    for name in ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w"):
        t, j = ours["text"]["layers"][1][name], theirs["text"]["layers"][1][name]
        assert isinstance(t, T.Int4Linear) and isinstance(j, JaxInt4)
        np.testing.assert_array_equal(t.w_p.numpy(), np.asarray(j.w_p))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    assert isinstance(ours["text"]["lm_head"], T.Int4Linear)
    assert isinstance(ours["text"]["embed_tokens"], torch.Tensor)
    assert isinstance(ours["visual"]["blocks"][0]["qkv_w"], torch.Tensor)


@pytest.mark.parametrize("M,route", [(1, "int4_matmul"), (64, "int4_matmul"),
                                     (65, "int4_matmul_wgmma"), (5878, "int4_matmul_wgmma")])
def test_kernel_route_by_rows(M, route):
    """Decode row counts keep the mma.sync entry point, prefill ones (the 7B
    slice's 2 x 2939 rows) take the wgmma one."""
    assert T.kernel_route(M) == route


@pytest.mark.parametrize("M", [64, 65])
def test_int4_matmul_launches_the_route_it_picks(monkeypatch, M):
    """The wrapper launches exactly the entry point ``kernel_route`` names,
    once, with K7's operands (the launch itself is stubbed here): the decode
    route with its plan and, for more than one split, a float32 workspace
    of (splits, M, N) and the zeroed counters of its column tiles."""
    from open_o3_video_tpu_torch.ops import kernels

    launched = []
    monkeypatch.setattr(kernels, "use_kernel", lambda x, impl: True)
    monkeypatch.setattr(kernels, "check_tensor", lambda *args: None)
    monkeypatch.setattr(kernels, "launch", lambda name, *args: launched.append((name, args)))
    monkeypatch.setattr(T, "sm_count", lambda index: 132)
    w = T.quantize_weight_int4(torch.randn(256, 128))
    out = T.int4_matmul(torch.randn(M, 256), w.w_p, w.scale, w.group)
    assert out.shape == (M, 128) and out.dtype == torch.bfloat16
    assert [name for name, _ in launched] == [T.kernel_route(M)]
    if T.kernel_route(M) == "int4_matmul_wgmma":
        assert launched[0][1][4:] == (M, 256, 128, 128)
    else:
        block_n, splits = T.decode_plan(M, 256, 128, 132)
        assert splits > 1 and launched[0][1][4] != 0 and launched[0][1][5] != 0
        assert launched[0][1][6:] == (M, 256, 128, 128, block_n, splits)
        assert T._split_counters(torch.device("cpu"), 128 // block_n).eq(0).all()


# The decode matmuls of both models (M = their decode batch): q/o share
# q_w's shape, v_w k_w's, up_w gate_w's.
DECODE_SHAPES = {
    "7B k_w": (2, 3584, 512), "7B q_w": (2, 3584, 3584), "7B gate_w": (2, 3584, 18944),
    "7B down_w": (2, 18944, 3584), "7B lm_head": (2, 3584, 152064),
    "72B k_w": (4, 8192, 1024), "72B q_w": (4, 8192, 8192), "72B gate_w": (4, 8192, 29568),
    "72B down_w": (4, 29568, 8192),
}


@pytest.mark.parametrize("name", list(DECODE_SHAPES))
def test_decode_plan_reaches_the_cta_target(name):
    """On an H100's 132 SMs every decode shape of both models gets at least
    DECODE_CTAS_PER_SM CTAs on each SM, and its splits cover the groups."""
    M, K, N = DECODE_SHAPES[name]
    block_n, splits = T.decode_plan(M, K, N, 132)
    assert block_n in T.DECODE_BLOCK_NS and N % block_n == 0
    assert 1 <= splits <= K // T.KERNEL_GROUP
    assert (N // block_n) * splits >= T.DECODE_CTAS_PER_SM * 132


@pytest.mark.parametrize("groups,splits", [(2, 1), (28, 10), (28, 17), (28, 28), (64, 33),
                                           (148, 10), (231, 5)])
def test_split_bounds_cover_every_group_once_in_order(groups, splits):
    bounds = T.split_bounds(groups, splits)
    assert len(bounds) == splits
    assert [g for start, end in bounds for g in range(start, end)] == list(range(groups))
    assert all(start < end for start, end in bounds)  # no split is empty
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))  # ascending, contiguous


@pytest.mark.parametrize("K,N", [(256, 128), (3584, 512), (29568, 8192), (3584, 152064)])
def test_decode_plan_for_every_decode_row_count(K, N):
    for M in range(1, T.WGMMA_MIN_ROWS):
        block_n, splits = T.decode_plan(M, K, N, 132)
        assert block_n in T.DECODE_BLOCK_NS and N % block_n == 0
        assert 1 <= splits <= K // T.KERNEL_GROUP
    with pytest.raises(ValueError, match="decode route"):
        T.decode_plan(T.WGMMA_MIN_ROWS, K, N, 132)


# ---- on the card --------------------------------------------------------------


# (M, K, N): the decode route at decode rows, at M = 20 (a 32-row tile) and
# M = 64, with an odd group count (3) as the 72B down_w's 231, at the narrow N
# of the 7B and 72B k_w (32- and 128-column tiles, up to one group a split)
# and the long K of the 7B down_w (148 groups over its splits); a
# prefill-sized M with a ragged last tile. Then the wgmma route: its first
# row counts (65, 128), 7 groups (odd) at M = 1000 with 3 column tiles, and
# the 72B down_w's 231 groups at a small M. Inputs are scaled so outputs have
# std ~0.25: below 2, one bf16 ulp flipped by the summation order stays
# within the bound of assert_kernel_close.
CARD_SHAPES = [(2, 512, 256), (20, 256, 384), (300, 384, 512), (4, 384, 128),
               (2, 3584, 512), (4, 8192, 1024), (2, 18944, 384), (64, 512, 256),
               (65, 256, 256), (128, 384, 128), (1000, 896, 384), (80, 29568, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", CARD_SHAPES)
def test_int4_kernel_matches_plain(M, K, N):
    from open_o3_video_tpu_torch.ops import kernels

    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(M + K + N)
    w = T.quantize_weight_int4(0.25 / K ** 0.5 * torch.randn(K, N, generator=gen, device=dev))
    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
    kernels.reset_launches()
    out = T.int4_matmul(x, w.w_p, w.scale, w.group)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {T.kernel_route(M): 1}
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    assert_kernel_close(out, T.int4_matmul_torch(x, w.w_p, w.scale, w.group))
    # no atomics, a fixed summation order: the same bits twice
    assert torch.equal(out, T.int4_matmul(x, w.w_p, w.scale, w.group))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [16, 40])
def test_k7a_probes_match_plain(M):
    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(M)
    K, N = 512, 256
    w_p = torch.randint(-128, 128, (K // 2, N), generator=gen, device=dev, dtype=torch.int8)
    x = torch.randn(M, K, generator=gen, device=dev)
    # packed bytes have std ~74 as int8 values, unpacked codes ~4.6
    xs = (0.25 / (74 * (K / 2) ** 0.5) * x).to(torch.bfloat16)
    assert_kernel_close(T.int4_matmul_stream(xs, w_p), T.int4_matmul_stream_torch(xs, w_p))
    xc = (0.25 / (4.6 * K ** 0.5) * x).to(torch.bfloat16)
    assert_kernel_close(T.int4_matmul_convert(xc, w_p), T.int4_matmul_convert_torch(xc, w_p))


@pytest.mark.cuda
def test_int4_dense_on_the_card_takes_k7():
    from open_o3_video_tpu_torch.ops import kernels

    dev = cuda_device()
    w = T.quantize_weight_int4(0.05 * torch.randn(256, 128, device=dev))
    kernels.reset_launches()
    out = T.int4_dense(torch.randn(3, 2, 256, device=dev, dtype=torch.bfloat16), w)
    assert out.shape == (3, 2, 128) and kernels.LAUNCHES["int4_matmul"] == 1
    with pytest.raises(ValueError, match="group 64"):
        T.int4_dense(torch.randn(2, 256, device=dev), T.quantize_weight_int4(
            torch.randn(256, 128, device=dev), group=64))
