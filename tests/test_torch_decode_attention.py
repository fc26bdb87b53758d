"""K4 (long-context GQA decode attention): the port's plain version against
the JAX package's Pallas kernel (interpret mode) and its exact XLA path
``_decode_attention_chunked`` on the CPU, the dispatch order of
``causal_attention``, the fp8 cache write, and the CUDA kernel against the
plain version on the card."""

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_BF16, ATOL_OP, assert_kernel_close, cuda_device, normal, rng

from open_o3_video_tpu_torch.models.qwen25vl.text import write_cache
from open_o3_video_tpu_torch.ops import attention as tattn
from open_o3_video_tpu_torch.ops import decode_attention as tdec
from open_o3_video_tpu_torch.ops import flash_attention as tflash

FP8 = torch.float8_e4m3fn


def _inputs(r, B, S, T, Hq, Hkv, D, kv_scale=1.0):
    """Decode-shaped inputs: S queries near the end of a T-slot buffer; row 1
    is left-padded (its first 37 slots invalid) and its first query is a pad
    row (q_pos -1), which sees nothing."""
    q = normal(r, B, S, Hq, D)
    k = normal(r, B, T, Hkv, D, scale=kv_scale)
    v = normal(r, B, T, Hkv, D, scale=kv_scale)
    valid = np.ones((B, T), np.int32)
    valid[1, :37] = 0
    q_pos = np.broadcast_to(np.arange(T - S - 5, T - 5, dtype=np.int32), (B, S)).copy()
    q_pos[1, 0] = -1
    return q, k, v, q_pos, valid


def _fp8_bytes(x):
    """numpy f32 -> e4m3 bytes through JAX's convert (exact below 448)."""
    import jax.numpy as jnp

    return np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(np.uint8)


def _as_fp8(b):
    return torch.from_numpy(b.copy()).view(FP8)


# q in f32 (the compute dtype of the CPU tests) or bf16 (the card's), k/v
# stored in bf16. Tolerance: f32 sums in another order, 1e-5; bf16 output
# rounding, one ulp at |x| < 2 (ATOL_BF16).
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,T", [(1, 300), (3, 333)])  # T off the 128-key tile
def test_plain_matches_jax_kernel_bf16_cache(q_dtype, S, T):
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.decode_attention import decode_attention_gqa

    q, k, v, q_pos, valid = _inputs(rng(S + T), 2, S, T, 14, 2, 128)
    jq = jnp.asarray(q).astype(q_dtype)
    jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (k, v))
    theirs = np.asarray(decode_attention_gqa(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(valid),
                                             block_k=128, interpret=True).astype(jnp.float32))
    # np.array copies: a tensor must own its memory, not alias a JAX buffer
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(getattr(torch, q_dtype))
    tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
    ours = tdec.decode_attention_gqa(tq, tk, tv, torch.from_numpy(q_pos),
                                     torch.from_numpy(valid)).float().numpy()
    np.testing.assert_allclose(ours, theirs, atol=ATOL_OP if q_dtype == "float32" else ATOL_BF16)
    assert (ours[1, 0] == 0).all() and (theirs[1, 0] == 0).all()


# fp8 cache at a value scale where most of v is e4m3 denormal (|x| < 2^-6).
# The plain version converts e4m3 exactly, as JAX's _decode_attention_chunked
# does; the two differ only in the softmax form (fixed-m vs running max, the
# same value below the clamp) and the prescale rounding of q: outputs are
# ~3e-3, agreement to 1e-7 is 3e-5 relative.
ATOL_FP8_EXACT = 1e-7


@pytest.mark.parametrize("S", [1, 3])
def test_plain_matches_jax_exact_path_fp8_denormals(S):
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.attention import _decode_attention_chunked

    T = 300
    q, k, v, q_pos, valid = _inputs(rng(40 + S), 2, S, T, 14, 2, 128, kv_scale=0.01)
    kb, vb = _fp8_bytes(k * 50.0), _fp8_bytes(v)  # k at ~0.5: scores of unit size
    assert ((vb & 0x78) == 0).mean() > 0.5  # most of v is denormal
    mask = (np.arange(T)[None, None, :] <= q_pos[:, :, None]) & (valid[:, None, :] != 0)
    exact = np.asarray(_decode_attention_chunked(
        jnp.asarray(q), jnp.asarray(kb.view(jnp.float8_e4m3fn)),
        jnp.asarray(vb.view(jnp.float8_e4m3fn)), jnp.asarray(mask), chunk=128))
    ours = tdec.decode_attention_gqa(torch.from_numpy(q), _as_fp8(kb), _as_fp8(vb),
                                     torch.from_numpy(q_pos), torch.from_numpy(valid)).numpy()
    keep = q_pos >= 0  # JAX's chunked path gives pad rows 0 as well, via its l-clamp
    np.testing.assert_allclose(ours[keep], exact[keep], rtol=0, atol=ATOL_FP8_EXACT)
    assert (ours[~keep] == 0).all()


def test_jax_kernel_fp8_denormal_flush_is_pinned():
    """The JAX Pallas kernel flushes e4m3 denormals to zero (its documented
    deviation): on the same inputs it is far from the exact path, and equal
    to the port's plain version run on inputs flushed by hand."""
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.decode_attention import decode_attention_gqa

    T = 300
    q, k, v, q_pos, valid = _inputs(rng(50), 2, 1, T, 14, 2, 128, kv_scale=0.01)
    kb, vb = _fp8_bytes(k * 50.0), _fp8_bytes(v)
    pallas = np.asarray(decode_attention_gqa(
        jnp.asarray(q), jnp.asarray(kb.view(jnp.float8_e4m3fn)),
        jnp.asarray(vb.view(jnp.float8_e4m3fn)), jnp.asarray(q_pos), jnp.asarray(valid),
        block_k=128, interpret=True))

    def flushed(b):
        b = b.copy()
        b[(b & 0x78) == 0] &= 0x80  # exponent 0: denormal -> signed zero
        return _as_fp8(b)

    args = (torch.from_numpy(q_pos), torch.from_numpy(valid))
    exact = tdec.decode_attention_gqa(torch.from_numpy(q), _as_fp8(kb), _as_fp8(vb), *args).numpy()
    flush = tdec.decode_attention_gqa(torch.from_numpy(q), flushed(kb), flushed(vb), *args).numpy()
    keep = q_pos >= 0
    assert np.abs(pallas - exact)[keep].max() > 1e-3  # the deviation, ~ the output's size
    np.testing.assert_allclose(pallas, flush, rtol=0, atol=ATOL_FP8_EXACT)


@pytest.mark.parametrize("kv_dtype", ["float8_e4m3fn", "bfloat16", "float32"])
def test_long_decode_dispatch_sees_the_stored_dtype(monkeypatch, kv_dtype):
    """With LONG_DECODE_T patched low on both sides, causal_attention routes a
    decode step to K4 with k/v in the cache's stored dtype (no cast before
    the dispatch), and agrees with the JAX package's long-decode path."""
    import jax.numpy as jnp

    from open_o3_video_tpu.ops import attention as jattn

    B, S, Hq, Hkv, D, T = 1, 1, 4, 2, 16, 300
    r = rng(2)
    q, k, v = normal(r, B, S, Hq, D), normal(r, B, T, Hkv, D), normal(r, B, T, Hkv, D)
    kv_mask = np.arange(T)[None, :] < 222
    q_pos = np.full((B, S), T - 1, np.int32)
    jk, jv = (jnp.asarray(x).astype(getattr(jnp, kv_dtype)) for x in (k, v))
    tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, kv_dtype))
              for x in (jk, jv))
    seen = []

    def spy(q_, k_, v_, *args, **kw):
        seen.append(k_.dtype)
        return tdec.decode_attention_gqa(q_, k_, v_, *args, **kw)

    monkeypatch.setattr(jattn, "LONG_DECODE_T", 256)
    monkeypatch.setattr(tattn, "LONG_DECODE_T", 256)
    monkeypatch.setattr(tattn, "decode_attention_gqa", spy)
    theirs = np.asarray(jattn.causal_attention(
        jnp.asarray(q), jk, jv, q_positions=jnp.asarray(q_pos), kv_mask=jnp.asarray(kv_mask),
        impl="xla"))
    ours = tattn.causal_attention(torch.from_numpy(q), tk, tv,
                                  q_positions=torch.from_numpy(q_pos),
                                  kv_mask=torch.from_numpy(kv_mask)).numpy()
    assert seen == [getattr(torch, kv_dtype)]
    np.testing.assert_allclose(ours, theirs, atol=ATOL_OP)


def test_short_buffer_decode_and_prefill_cast_an_fp8_cache():
    """Below LONG_DECODE_T, and for prefill (S > 8), an fp8 layer is cast to
    the compute dtype first and runs as before, matching JAX's XLA path."""
    import jax.numpy as jnp

    from open_o3_video_tpu.ops import attention as jattn

    B, Hq, Hkv, D, T = 1, 4, 2, 16, 40
    r = rng(3)
    k8 = _fp8_bytes(normal(r, B, T, Hkv, D))
    v8 = _fp8_bytes(normal(r, B, T, Hkv, D))
    for S in (1, 12):
        q = normal(r, B, S, Hq, D)
        q_pos = np.arange(T - S, T, dtype=np.int32)[None]
        ours = tattn.causal_attention(torch.from_numpy(q), _as_fp8(k8), _as_fp8(v8),
                                      q_positions=torch.from_numpy(q_pos)).numpy()
        theirs = np.asarray(jattn.causal_attention(
            jnp.asarray(q), jnp.asarray(k8.view(jnp.float8_e4m3fn)),
            jnp.asarray(v8.view(jnp.float8_e4m3fn)), q_positions=jnp.asarray(q_pos),
            impl="xla"))
        np.testing.assert_allclose(ours, theirs, atol=ATOL_OP)


# (S, Hq, Hkv, D, stored dtype, impl, decode_impl, q requires grad) -> the
# route causal_attention takes with kernels.use_kernel true (a card's tensors)
# at T = 300, far below LONG_DECODE_T.
DISPATCH_CASES = {
    "S=1 bf16 cache": ((1, 28, 4, 128, "bfloat16", "auto", "auto", False), "k4"),
    "S=8 bf16 cache": ((8, 28, 4, 128, "bfloat16", "auto", "auto", False), "k4"),
    "S=1 e4m3 cache": ((1, 32, 4, 128, "float8_e4m3fn", "auto", "auto", False), "k4"),
    "S=8 e4m3 cache, 64 rows": ((8, 32, 4, 128, "float8_e4m3fn", "auto", "auto", False), "k4"),
    "float32 cache": ((1, 28, 4, 128, "float32", "auto", "auto", False), "grouped"),
    "head_dim 64": ((1, 28, 4, 64, "bfloat16", "auto", "auto", False), "grouped"),
    "S*G = 128 rows": ((8, 64, 4, 128, "bfloat16", "auto", "auto", False), "grouped"),
    "impl torch": ((1, 28, 4, 128, "bfloat16", "torch", "auto", False), "grouped"),
    "decode_impl xla": ((1, 28, 4, 128, "bfloat16", "auto", "xla", False), "grouped"),
    "under autograd": ((1, 28, 4, 128, "bfloat16", "auto", "auto", True), "grouped"),
    "decode_impl pallas": ((1, 28, 4, 128, "bfloat16", "auto", "pallas", False), "flash"),
}


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_short_buffer_decode_dispatch_on_the_card(monkeypatch, case):
    """With kernels.use_kernel true (as for CUDA tensors), a decode block
    (S <= 8) far below LONG_DECODE_T reaches K4 with k/v in the cache's
    stored dtype whenever K4 takes the inputs (bf16 q, a bf16 or e4m3
    cache, head_dim 128, S * Hq/Hkv <= 64, no autograd); every other case,
    and impl "torch" and decode_impl "xla", keeps the JAX package's order
    (the cast, then the grouped decode); "pallas" keeps K3."""
    from open_o3_video_tpu_torch.ops import kernels

    (S, Hq, Hkv, D, kv_dtype, impl, decode_impl, grad), route = DISPATCH_CASES[case]
    B, T = 2, 300
    r = rng(S + Hq + D)
    kvd = getattr(torch, kv_dtype)
    q = torch.from_numpy(normal(r, B, S, Hq, D)).to(torch.bfloat16).requires_grad_(grad)
    k, v = (torch.from_numpy(normal(r, B, T, Hkv, D)).to(kvd) for _ in range(2))
    pos = torch.arange(T - S - 3, T - 3).expand(B, S)
    valid = torch.ones((B, T), dtype=torch.bool)
    valid[1, :37] = False
    seen = []

    def spy(name, fn):
        def wrapped(q_, k_, v_, *args, **kw):
            seen.append((name, k_.dtype))
            return fn(q_, k_, v_, *args)
        return wrapped

    monkeypatch.setattr(kernels, "use_kernel", lambda x, impl_: impl_ == "auto")
    monkeypatch.setattr(tattn, "decode_attention_gqa", spy("k4", tdec.decode_attention_gqa_torch))
    monkeypatch.setattr(tattn, "_grouped_decode", spy("grouped", tattn._grouped_decode))
    monkeypatch.setattr(tattn, "flash_attention_gqa",
                        spy("flash", tflash.flash_attention_gqa_torch))
    out = tattn.causal_attention(q, k, v, q_positions=pos, kv_mask=valid, impl=impl,
                                 decode_impl=decode_impl)
    stored = kvd if route == "k4" else torch.bfloat16
    assert seen == [(route, stored)]
    assert out.shape == (B, S, Hq, D) and out.dtype == torch.bfloat16


def _write_fp8(x_bf16: torch.Tensor) -> np.ndarray:
    dst = torch.zeros(x_bf16.shape, dtype=FP8, device=x_bf16.device)
    write_cache(dst, x_bf16)
    return dst.cpu().view(torch.uint8).numpy()


def _write_values():
    """bf16 values: normals of all scales, e4m3 denormals, the edges."""
    r = rng(9)
    x = np.concatenate([
        r.standard_normal(4000) * 3.0, r.standard_normal(2000) * 100.0,
        r.standard_normal(2000) * 0.005,
        [0.0, -0.0, 2.0 ** -9, -(2.0 ** -9), 2.0 ** -10, 0.0137, 448.0, -448.0, 240.0],
    ]).astype(np.float32)
    x = np.clip(x, -448.0, 448.0)
    return torch.from_numpy(x).to(torch.bfloat16)


def test_fp8_cache_write_matches_jax_within_range():
    """Within |x| <= 448 the port's fp8 cache bytes equal JAX's convert of the
    same bf16 values (denormals and round-to-nearest-even included)."""
    import jax.numpy as jnp

    x = _write_values()
    theirs = np.asarray(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                        .astype(jnp.float8_e4m3fn)).view(np.uint8)
    np.testing.assert_array_equal(_write_fp8(x), theirs)


def test_fp8_cache_write_saturates_where_jax_gives_nan():
    """Beyond 464 the port writes +-448 (bytes 0x7e/0xfe) where JAX writes NaN:
    the known divergence kept on purpose (ROADMAP Queue 3)."""
    import jax.numpy as jnp

    x = torch.tensor([472.0, 500.0, 1e4, -470.0, -3e38], dtype=torch.bfloat16)
    ours = _write_fp8(x)
    theirs = np.asarray(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                        .astype(jnp.float8_e4m3fn))
    np.testing.assert_array_equal(ours, [0x7E, 0x7E, 0x7E, 0xFE, 0xFE])
    assert np.isnan(theirs.astype(np.float32)).all()


# ---- the bound the card's K4 is held to -------------------------------------

TILE_KEYS = tdec.TILE_KEYS  # K4's key tile (kTile in csrc/decode_attention.cu)


@pytest.mark.parametrize("variant", ["keys reordered", "zero output", "one split dropped",
                                     "last tile dropped"])
def test_kernel_bound_passes_rounding_and_rejects_dropped_keys(variant):
    """assert_kernel_close at a long decode's output scale (~0.013 here):
    the plain version with its keys summed in another order (rounding
    differences only, as the kernel's) passes; a zero output, or the plain
    version without one of K4's splits or without its last partial tile,
    fails."""
    B, S, T, Hq, Hkv, D = 1, 1, 16384, 28, 4, 128
    w = T - 32  # written slots; the last tile holds 32 keys
    r = rng(11)
    q = torch.from_numpy(normal(r, B, S, Hq, D)).to(torch.bfloat16)
    k, v = (torch.from_numpy(normal(r, B, w, Hkv, D)).to(torch.bfloat16) for _ in range(2))
    pos = torch.full((B, S), w - 1, dtype=torch.int32)
    valid = torch.ones((B, w), dtype=torch.int32)
    ref = tdec.decode_attention_gqa_torch(q, k, v, pos, valid)
    splits, tiles = tdec._splits(B, Hkv, T), -(-w // TILE_KEYS)
    dropped = {"one split dropped": tdec.split_tiles(tiles, splits)[splits // 2],
               "last tile dropped": (tiles - 1, tiles)}
    if variant == "keys reordered":
        perm = torch.from_numpy(r.permutation(w))
        out = tdec.decode_attention_gqa_torch(q, k[:, perm], v[:, perm], pos, valid)
    elif variant == "zero output":
        out = torch.zeros_like(ref)
    else:
        t0, t1 = dropped[variant]
        valid[:, t0 * TILE_KEYS:t1 * TILE_KEYS] = 0
        out = tdec.decode_attention_gqa_torch(q, k, v, pos, valid)
    if variant == "keys reordered":
        assert not torch.equal(out, ref)  # the rounding differs somewhere
        assert_kernel_close(out, ref)
    else:
        with pytest.raises(AssertionError):
            assert_kernel_close(out, ref)


@pytest.mark.parametrize("B,Hkv,T,last", [(1, 4, 81920, 81887), (2, 4, 33000, 32990),
                                          (3, 1, 1000, 997), (1, 8, 300, 5), (4, 8, 40000, 990)])
def test_k4_split_plan_covers_each_key_tile_once_in_order(B, Hkv, T, last):
    """The splits depend on shapes only, stay within SPLIT_CTAS CTAs, and
    split_tiles gives every 64-key tile of [0, last] to exactly one split,
    in order (the order the combine sums them in)."""
    splits = tdec._splits(B, Hkv, T)
    assert 1 <= splits and (splits == 1 or splits * B * Hkv <= tdec.SPLIT_CTAS)
    assert splits <= -(-T // tdec.MIN_SPLIT_KEYS)
    n_tiles = -(-(last + 1) // tdec.TILE_KEYS)
    plan = tdec.split_tiles(n_tiles, splits)
    assert len(plan) == splits
    assert [t for t0, t1 in plan for t in range(t0, t1)] == list(range(n_tiles))


# ---- on the card: kernel vs plain version ----------------------------------

# (B, S, T, Hq, Hkv, q_pos of row 0, stored dtype): the chip_smoke shapes, and
# two small off-tile ones (T, and the key range, not multiples of 64).
CUDA_CASES = [
    (1, 1, 81920, 28, 4, 81887, "float8_e4m3fn"),
    (1, 1, 32768, 28, 4, 32735, "bfloat16"),
    (2, 4, 33000, 28, 4, 32990, "float8_e4m3fn"),
    (2, 3, 333, 14, 2, 300, "bfloat16"),
    (3, 8, 1000, 8, 1, 997, "float8_e4m3fn"),
    (1, 1, 40000, 64, 8, 39990, "float8_e4m3fn"),  # the 72B judge's 64/8 heads
    (2, 1, 5000, 64, 8, 4321, "bfloat16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,Hq,Hkv,last,kv_dtype", CUDA_CASES)
def test_decode_kernel_matches_plain(B, S, T, Hq, Hkv, last, kv_dtype):
    dev = cuda_device()
    D = 128
    r = rng(T + S)
    kvd = getattr(torch, kv_dtype)
    # k/v as strided layer views of a stacked (2, L, B, T, Hkv, D) cache whose
    # tail past the written slots holds garbage the kernel must not read
    cache = torch.full((2, 2, B, T, Hkv, D), float("nan"), device=dev).to(kvd)
    for i in range(2):
        cache[i, 1, :, :last + 1] = torch.from_numpy(
            normal(r, B, last + 1, Hkv, D)).to(dev, kvd)
    k, v = cache[0, 1], cache[1, 1]
    q = torch.from_numpy(normal(r, B, S, Hq, D)).to(dev, torch.bfloat16)
    pos = torch.arange(last - S + 1, last + 1, dtype=torch.int32, device=dev).repeat(B, 1)
    valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
    valid[:, :last + 1] = 1
    if B > 1:
        valid[1, :100] = 0  # left padding
        pos[1, 0] = -1  # a pad row
    out = tdec.decode_attention_gqa(q, k, v, pos, valid)
    # the plain version on the written part only (it multiplies masked v by 0)
    ref = tdec.decode_attention_gqa_torch(q, k[:, :last + 1], v[:, :last + 1], pos,
                                          valid[:, :last + 1])
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert_kernel_close(out, ref)
    if B > 1:
        assert (out[1, 0] == 0).all()
    # the same bits on a second run (fixed-order split reduction)
    assert torch.equal(out, tdec.decode_attention_gqa(q, k, v, pos, valid))


def serving_layout(B, L, ring, written, prompts, holes):
    """A decode step's buffer as the engine lays it out: row b's prompt
    left-padded into [L - prompts[b], L), the ring [L, L + ring) written in
    its first written[b] columns, holes[b] (start, end) inside the prompt
    region left invalid (a prefix row's pad inside the shared block), and
    every query at position T = L + ring, past every column (validity-only
    masking). Returns q_pos (B, 1) int64 and the validity (B, T) bool."""
    T = L + ring
    valid = torch.zeros((B, T), dtype=torch.bool)
    for b in range(B):
        valid[b, L - prompts[b]:L + written[b]] = True
        for h0, h1 in holes.get(b, ()):
            valid[b, h0:h1] = False
    return torch.full((B, 1), T, dtype=torch.int64), valid


# The two cells' decode steps: (B, L, ring, Hq, Hkv, prompt lengths, ring
# columns written, holes). vstar: the 7B's 5 V-STAR queries of ~4.8-5.4k
# tokens, rows 1 and 2 on a shared prefix block with pad inside it, row 4
# done early; the 30B: 8 unshared requests of ~2.6k tokens at a full batch.
SERVING_CASES = {
    "vstar 5 x 5912, 28/4": (5, 5400, 512, 28, 4, (5400, 5310, 5022, 4821, 5398),
                            (300, 300, 300, 300, 121), {1: ((3240, 3300),), 2: ((3160, 3300),)}),
    "30B 8 x 3132, 32/4": (8, 2620, 512, 32, 4, (2620, 2588, 2611, 2533, 2602, 2597, 2560, 2617),
                          (200,) * 8, {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float8_e4m3fn"])
@pytest.mark.parametrize("case", list(SERVING_CASES))
def test_decode_kernel_matches_plain_at_the_serving_layouts(case, kv_dtype):
    """K4 at the cells' own decode shapes and validity (left padding, holes
    in a prefix block, a partly written ring; NaN in every invalid slot,
    which K4 must never read) against its plain version, with the engine's
    int64 positions and bool validity; int32 inputs give the same bits."""
    dev = cuda_device()
    B, L, ring, Hq, Hkv, prompts, written, holes = SERVING_CASES[case]
    D = 128
    pos, valid = serving_layout(B, L, ring, written, prompts, holes)
    pos, valid = pos.to(dev), valid.to(dev)
    T = L + ring
    r = rng(T + B)
    kvd = getattr(torch, kv_dtype)
    cache = torch.from_numpy(normal(r, 2, B, T, Hkv, D)).to(dev, kvd)
    clean = cache.clone()  # finite everywhere, for the plain version
    cache.view(torch.uint8 if kv_dtype == "float8_e4m3fn" else torch.int16)[
        :, ~valid] = 0x7F if kv_dtype == "float8_e4m3fn" else 0x7FC0  # NaN
    q = torch.from_numpy(normal(r, B, 1, Hq, D)).to(dev, torch.bfloat16)
    out = tdec.decode_attention_gqa(q, cache[0], cache[1], pos, valid)
    ref = tdec.decode_attention_gqa_torch(q, clean[0], clean[1], pos, valid)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert_kernel_close(out, ref)
    assert torch.equal(out, tdec.decode_attention_gqa(q, cache[0], cache[1], pos.int(),
                                                      valid.int()))


@pytest.mark.cuda
def test_fp8_cache_write_saturates_on_the_card():
    dev = cuda_device()
    x = torch.tensor([472.0, 500.0, 1e4, -470.0, 448.0, 2.0 ** -9], dtype=torch.bfloat16)
    np.testing.assert_array_equal(_write_fp8(x.to(dev)), [0x7E, 0x7E, 0x7E, 0xFE, 0x7E, 0x01])
