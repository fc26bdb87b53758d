"""K3's and K4's plans, timed against their yardsticks on one GPU.

    python3 scripts/exp_k3_k4_plans.py [--long]

K3 (csrc/flash_attention.cu) at the main paths' shapes: the 7B slice's
prefill (2 rows of ~2.94k tokens, 28/4 heads, inference), the SFT step (1 x
3136, exact), the 72B judge's prefill (4 x ~990, 64/8 heads, inference);
with --long also run (b)'s last prefill chunk (8160 rows at positions
73728..81887 against an 81920-slot cache, inference); against SDPA with the
boolean causal mask (enable_gqa).

K4 (csrc/decode_attention.cu) at run (b)'s decode step (T = 81920, fp8),
run (a)'s (32768, bf16) and the judge's heads (64/8, T = 40000, fp8), with
ops/decode_attention.py's SPLIT_CTAS at several values, against SDPA on
bf16 copies of the written slots. Then K4 at the serving cells' decode steps
(chip_smoke.py's SERVING_DECODE_CASES: left padding, a prefix block's holes,
a partly written ring, queries at T), with SPLIT_CTAS and MIN_SPLIT_KEYS
over a grid, against SDPA and its plain version; and a whole step's
attention as one CUDA graph of the model's layers (one cache per layer):
K4 as the decode step calls it (int64 positions, bool validity), the int32
conversions and q prescale that K4's wrapper launched before it read those
itself, and the float32 grouped decode that ran below LONG_DECODE_T before.

Each time is chip_smoke.py's time_ms (CUDA events, median of 20, a spin
queued first); each output is held to its plain version with chip_smoke's
bound (at the long chunk, on 64 of its rows). Copied into an older tree,
it times that tree's kernels. Prints one line per case.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from open_o3_video_tpu_torch.ops import attention as attn  # noqa: E402
from open_o3_video_tpu_torch.ops import decode_attention as da  # noqa: E402
from open_o3_video_tpu_torch.ops import flash_attention as fa  # noqa: E402

D = 128
SPLIT_CTAS = (132, 264, 396, 528)
MIN_SPLIT_KEYS = (128, 256, 512)
# Decoder layers of the serving cells' models (Qwen2.5-VL-7B, Qwen3-VL-30B-A3B).
SERVING_LAYERS = {"vstar step": 28, "30B step": 48}


def median_ms(fn, reps=20) -> float:
    return statistics.median(cs.time_ms(fn, reps=reps))


def k3_case(dev, gen, name, B, S, T, Hq, Hkv, starts, valid_rows, exact, rows=None, reps=20):
    """S query rows per batch row at positions starts[b] .. + S - 1, keys
    valid in valid_rows[b] = (first, end)."""
    q = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    pos = torch.stack([torch.arange(s, s + S, dtype=torch.int32, device=dev) for s in starts])
    valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
    for b, (first, end) in enumerate(valid_rows):
        valid[b, first:end] = 1
    flops = 4 * cs.causal_pairs(pos, valid) * Hq * D
    bound, by = cs.bound_ms(flops, cs.nbytes(q, k, v, pos, valid, q))
    mask = cs.causal_mask(pos, valid)
    lib = median_ms(lambda: cs.sdpa_masked(q, k, v, mask), reps) if rows is None else None
    del mask
    kernel = fa.flash_attention_gqa_exact if exact else fa.flash_attention_gqa
    plain = fa.flash_attention_gqa_exact_torch if exact else fa.flash_attention_gqa_torch
    qs, ps = (q, pos) if rows is None else (q[:, rows].contiguous(), pos[:, rows].contiguous())
    ref = plain(qs, k, v, ps, valid)
    out = kernel(qs, k, v, ps, valid)
    torch.cuda.synchronize()
    a = cs.agreement(out[0] if exact else out, ref[0] if exact else ref, None)
    ms = median_ms(lambda: kernel(q, k, v, pos, valid), reps)
    print(f"[k3] {name} B={B} S={S} T={T} heads={Hq}/{Hkv} exact={exact} ms={ms:.4f} "
          f"sdpa_ms={lib if lib is None else round(lib, 4)} bound_ms={bound:.4f} ({by}) "
          f"tflops={flops / ms / 1e9:.1f} rel_l2={a['rel_l2']:.2e} agrees={a['ok']}", flush=True)
    del q, k, v, ref
    torch.cuda.empty_cache()


def k3_cases(dev, gen, long: bool) -> None:
    rows = (2939, 2931)  # the slice's two requests, left-padded into one batch
    L = max(rows)
    k3_case(dev, gen, "slice prefill", 2, L, L + 64, 28, 4, (0, 0),
            [(L - n, L) for n in rows], False)
    k3_case(dev, gen, "sft step", 1, 3136, 3136, 28, 4, (0,), [(0, 3082)], True)
    jobs = (982, 990, 991, 996)
    L = max(jobs)
    k3_case(dev, gen, "judge prefill", 4, L, L + 16, 64, 8, (0,) * 4, [(L - n, L) for n in jobs],
            False)
    if long:
        n, T = 81888, 81920
        c0 = (n - 1) // 8192 * 8192
        k3_case(dev, gen, "long chunk", 1, n - c0, T, 28, 4, (c0,), [(0, n)], False,
                rows=torch.arange(0, n - c0, 128, device=dev)[:64], reps=5)


def k4_cases(dev, gen) -> None:
    for name, B, S, T, last, Hq, Hkv, dtype in (
            ("run (b) step", 1, 1, 81920, 81887, 28, 4, torch.float8_e4m3fn),
            ("run (a) step", 1, 1, 32768, 32735, 28, 4, torch.bfloat16),
            ("judge heads", 1, 1, 40000, 39990, 64, 8, torch.float8_e4m3fn)):
        cache = torch.full((2, B, T, Hkv, D), float("nan"), dtype=torch.bfloat16, device=dev)
        cache[:, :, :last + 1] = torch.randn(cache[:, :, :last + 1].shape, generator=gen,
                                             device=dev).to(torch.bfloat16)
        cache = cache.to(dtype)
        k, v = cache[0], cache[1]
        w = last + 1
        q = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.full((B, S), last, dtype=torch.int32, device=dev)
        valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
        valid[:, :w] = 1
        kb, vb = k[:, :w].to(torch.bfloat16), v[:, :w].to(torch.bfloat16)
        mask = cs.causal_mask(pos, valid[:, :w])
        lib = median_ms(lambda: cs.sdpa_masked(q, kb, vb, mask))
        del kb, vb
        ref = da.decode_attention_gqa_torch(q, k[:, :w], v[:, :w], pos, valid[:, :w])
        bound, by = cs.bound_ms(4 * cs.causal_pairs(pos, valid) * Hq * D,
                                cs.nbytes(q, k[:, :w], v[:, :w], pos, valid, q))
        default = da.SPLIT_CTAS
        for ctas in SPLIT_CTAS:
            da.SPLIT_CTAS = ctas
            out = da.decode_attention_gqa(q, k, v, pos, valid)
            torch.cuda.synchronize()
            a = cs.agreement(out, ref, None)
            same = torch.equal(out, da.decode_attention_gqa(q, k, v, pos, valid))
            ms = median_ms(lambda: da.decode_attention_gqa(q, k, v, pos, valid))
            print(f"[k4] {name} T={T} {str(dtype).split('.')[-1]} heads={Hq}/{Hkv} "
                  f"split_ctas={ctas} splits={da._splits(B, Hkv, T)} ms={ms:.4f} sdpa_ms={lib:.4f} "
                  f"bound_ms={bound:.4f} ({by}) GB/s={cs.nbytes(k[:, :w], v[:, :w]) / ms / 1e6:.0f} "
                  f"rel_l2={a['rel_l2']:.2e} agrees={a['ok']} same_bits={same}", flush=True)
        da.SPLIT_CTAS = default
        del cache, k, v, ref
        torch.cuda.empty_cache()


def graph_ms(body) -> float:
    """Median replay time of `body` captured as one CUDA graph."""
    body()  # warm-up: library load, shared-memory attributes
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        body()
    ms = median_ms(g.replay)
    del g
    return ms


def k4_serving_cases(dev, gen) -> None:
    for name, B, L, ring, Hq, Hkv, prompts, written, holes in cs.SERVING_DECODE_CASES:
        layers, T = SERVING_LAYERS[name], L + ring
        pos, valid = cs.serving_layout(dev, B, L, ring, written, prompts, holes)
        cache = torch.randn((layers, 2, B, T, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
        q = torch.randn((B, 1, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
        k, v = cache[0, 0], cache[0, 1]
        n_valid = int(valid.sum().item())
        bound, by = cs.bound_ms(4 * cs.causal_pairs(pos, valid) * Hq * D,
                                2 * n_valid * Hkv * D * 2 + cs.nbytes(q, pos, valid, q))
        mask = cs.causal_mask(pos, valid)
        lib = median_ms(lambda: cs.sdpa_masked(q, k, v, mask))
        ref = da.decode_attention_gqa_torch(q, k, v, pos, valid)
        plain = median_ms(lambda: da.decode_attention_gqa_torch(q, k, v, pos, valid))
        head = f"[k4] {name} B={B} T={T} valid={n_valid} heads={Hq}/{Hkv}"
        defaults = da.SPLIT_CTAS, da.MIN_SPLIT_KEYS
        for ctas in SPLIT_CTAS:
            for min_keys in MIN_SPLIT_KEYS:
                da.SPLIT_CTAS, da.MIN_SPLIT_KEYS = ctas, min_keys
                out = da.decode_attention_gqa(q, k, v, pos, valid)
                torch.cuda.synchronize()
                a = cs.agreement(out, ref, None)
                ms = median_ms(lambda: da.decode_attention_gqa(q, k, v, pos, valid))
                print(f"{head} split_ctas={ctas} min_split_keys={min_keys} "
                      f"splits={da._splits(B, Hkv, T)} ms={ms:.4f} plain_ms={plain:.4f} "
                      f"sdpa_ms={lib:.4f} bound_ms={bound:.4f} ({by}) "
                      f"GB/s={2 * n_valid * Hkv * D * 2 / ms / 1e6:.0f} rel_l2={a['rel_l2']:.2e} "
                      f"agrees={a['ok']}", flush=True)
        da.SPLIT_CTAS, da.MIN_SPLIT_KEYS = defaults
        grouped_mask = ((torch.arange(T, device=dev)[None, None, :] <= pos[:, :, None])
                        & valid[:, None, :])

        def k4_step():
            for i in range(layers):
                da.decode_attention_gqa(q, cache[i, 0], cache[i, 1], pos, valid)

        def conversions():  # what K4's wrapper launched around it before
            for _ in range(layers):
                pos.to(torch.int32), valid.to(torch.int32), fa._prescale(q)

        def grouped_step():
            for i in range(layers):
                attn._grouped_decode(q, cache[i, 0], cache[i, 1], grouped_mask)

        steps = {f: graph_ms(fn) for f, fn in (("k4", k4_step), ("conversions", conversions),
                                                ("grouped", grouped_step))}
        print(f"{head} step of {layers} layers (one graph): k4_ms={steps['k4']:.4f} "
              f"k4_bound_ms={layers * bound:.4f} conversions_ms={steps['conversions']:.4f} "
              f"grouped_f32_ms={steps['grouped']:.4f}", flush=True)
        del cache, ref, mask, grouped_mask
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--long", action="store_true", help="also time run (b)'s last prefill chunk")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exp_k3_k4_plans: needs a CUDA device")
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k3_cases(dev, gen, args.long)
    k4_cases(dev, gen)
    k4_serving_cases(dev, gen)


if __name__ == "__main__":
    main()
