"""The operation and byte counts against values worked out by hand at the
published Qwen2.5-VL-7B shapes."""

from __future__ import annotations

import json
from pathlib import Path

from portbench.lib import counts
from portbench.lib.arch import read_arch
from portbench.lib.weights import count

BENCH_DIR = Path(__file__).resolve().parents[1]
A7 = read_arch(json.loads((BENCH_DIR / "configs" / "qwen25vl-7b.json").read_text()))
A30 = read_arch(json.loads((BENCH_DIR / "configs" / "qwen3vl-30b-a3b.json").read_text()))


def test_parameter_counts_are_the_published_sizes():
    # 8.29B and 31.07B parameters, the published sizes (matrices; the norms
    # and biases add well under a thousandth)
    assert abs(count(A7) / 8.29e9 - 1) < 2e-3
    assert abs(count(A30) / 31.07e9 - 1) < 2e-3


def test_decoder_matrices_a_token_multiplies_by():
    # 7B: q 3584^2, k and v 3584 x 512, o 3584^2, gate, up and down
    # 3584 x 18944 each, times 28 layers
    per_layer = 2 * 3584 * 3584 + 2 * 3584 * 512 + 3 * 3584 * 18944
    assert counts.text_matmul_params(A7) == 28 * per_layer == 6_525_288_448
    # 30B: q 2048 x 4096, k and v 2048 x 512, o 4096 x 2048, the router
    # 2048 x 128, and 8 of 128 experts of 3 x 2048 x 768, times 48
    attn = 2 * 2048 * 4096 + 2 * 2048 * 512 + 2048 * 128
    assert counts.text_matmul_params(A30) == 48 * (attn + 8 * 3 * 2048 * 768)
    assert counts.text_matmul_params(A30, per_token=False) == 48 * (attn + 128 * 3 * 2048 * 768)


def test_causal_pairs_and_prefill_attention():
    assert counts.causal_pairs(3, 3) == 6  # 1 + 2 + 3
    assert counts.causal_pairs(2, 5) == 4 + 5  # keys 0..3 and 0..4
    flops, nbytes = counts.prefill_attention(A7, [(2, 5)])
    # 9 pairs x 4 x 28 heads x 128 x 28 layers; q and out 2 x 2 x 28 x 128,
    # k and v 2 x 5 x 4 x 128, bf16, x 28 layers
    assert flops == 9 * 4 * 28 * 128 * 28
    assert nbytes == 28 * 2 * (2 * 2 * 28 * 128 + 2 * 5 * 4 * 128)


def test_window_pairs_of_a_v_star_frame():
    # a 336 x 588 frame: 24 x 42 patches, 12 x 21 merged units, windows of
    # 4 x 4 units: 15 of 64 patches and 3 of 4 x 1 units (16 patches)
    grid = [(1, 24, 42)]
    n = 24 * 42
    win_pairs, full_pairs = 15 * 64 ** 2 + 3 * 16 ** 2, n * n
    attn = 4 * 1280 * (28 * win_pairs + 4 * full_pairs)
    block = 1280 * 3840 + 1280 * 1280 + 3 * 1280 * 3420
    merger = 5120 * 5120 + 5120 * 3584
    mats = 2 * n * (1176 * 1280 + 32 * block) + 2 * (n // 4) * merger
    assert counts.vision_flops(A7, grid) == mats + attn


def test_decode_floor_bytes():
    # every decoder weight once: the matrices, two norms and the q/k/v
    # biases a layer, the final norm and the lm_head, bf16
    assert counts.text_weight_bytes(A7) == 2 * (6_525_288_448 + 28 * (2 * 3584 + 3584 + 2 * 512)
                                                + 3584 + 3584 * 152064)
    assert counts.kv_bytes_per_token(A7) == 2 * 2 * 28 * 4 * 128
    assert counts.bound_s(989e12, 0) == 1.0 and counts.bound_s(0, 3.35e12) == 1.0
