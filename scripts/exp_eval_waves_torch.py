"""V-STAR's decode waves on one GPU: each item's 5 queries kept in one wave
(waves of 5 of the 8 slots) against full waves of 8 that split items.

    python3 scripts/exp_eval_waves_torch.py [--items 4] [--budgets 256,2048] [--seed 0]

``vstar.evaluate`` through the port's ``QwenVLEngine`` on Qwen2.5-VL-7B at
full width (random bf16 weights from the seed), over chip_smoke's lossless
640x360 AVI (16 frames taken, resized to 336x588: 252 vision tokens a
frame), ``--items`` items in one item batch. ``max_tokens`` is cut to each
budget in turn; random weights never emit EOS, so every row decodes to it.
Each policy is patched into ``eval.waves.split_waves`` for its runs: at the
first budget in the order items, fill, fill, items; at the others items,
fill. Prints, per run, the waves (requests, tower passes, seconds, engine
stage seconds), the run's seconds and its decode ms per step, and how many
of the rows give the same tokens under both policies.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(REPO, "checkpoints", "exp_eval_waves")  # gitignored, removed after


def keep_items(requests, max_slots):
    """Each run of requests sharing one patch array starts a new wave when
    it would not fit in the current one but fits in an empty one."""
    groups = []
    for r in requests:
        if groups and r.pixel_patches is not None and groups[-1][0].pixel_patches is r.pixel_patches:
            groups[-1].append(r)
        else:
            groups.append([r])
    waves, wave = [], []
    for group in groups:
        if wave and len(wave) + len(group) > max_slots and len(group) <= max_slots:
            waves.append(wave)
            wave = []
        for r in group:
            wave.append(r)
            if len(wave) == max_slots:
                waves.append(wave)
                wave = []
    if wave:
        waves.append(wave)
    return waves


def fill(requests, max_slots):
    """Every wave full, in order: an item split across two waves is encoded
    in both."""
    return [list(requests[i : i + max_slots]) for i in range(0, len(requests), max_slots)]


POLICIES = {"items": keep_items, "fill": fill}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=int, default=4)
    ap.add_argument("--budgets", default="256,2048")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("exp_eval_waves_torch: needs a CUDA device")
    import chip_smoke as CS
    from open_o3_video_tpu_torch.data.processor import O3VideoProcessor
    from open_o3_video_tpu_torch.data.raw_media import write_raw_avi
    from open_o3_video_tpu_torch.eval import QwenVLEngine, vstar, waves
    from open_o3_video_tpu_torch.models.qwen25vl import Qwen25VLConfig, params as P
    from open_o3_video_tpu_torch.ops import kernels

    print(CS.card_line(), flush=True)
    kernels.library()
    dev = torch.device("cuda")
    cfg = Qwen25VLConfig()
    params = P.init(cfg, args.seed, dev)
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    os.makedirs(f"{OUT_DIR}/videos")
    rng = np.random.default_rng(args.seed + 16)
    n = int(CS.EVAL_SECONDS * CS.EVAL_FPS)
    avi = f"{OUT_DIR}/videos/bowling.avi"
    write_raw_avi(avi, rng.integers(0, 256, size=(n, CS.EVAL_H, CS.EVAL_W, 3), dtype=np.uint8),
                  CS.EVAL_FPS)
    with open(f"{OUT_DIR}/vstar.json", "w") as f:
        json.dump([CS._vstar_item(i, avi) for i in range(args.items)], f)
    config = CS.eval_config("vstar.yaml")
    model = QwenVLEngine(params, rt_shape=True, cfg=cfg, processor=O3VideoProcessor(), **config)
    tokens: list = []
    generate = model.engine.generate

    def recorded(*a, **kw):
        outs = generate(*a, **kw)
        tokens.extend(o["token_ids"] for o in outs)
        return outs

    model.engine.generate = recorded
    real = waves.split_waves
    budgets = [int(b) for b in args.budgets.split(",")]
    try:
        for bi, budget in enumerate(budgets):
            model.sampling = dataclasses.replace(model.sampling, max_tokens=budget)
            rows = {}
            for policy in ("items", "fill", "fill", "items") if bi == 0 else ("items", "fill"):
                waves.split_waves = POLICIES[policy]
                since, steps0 = len(model.waves), model.engine.decode_steps
                tokens.clear()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                vstar.evaluate(f"{OUT_DIR}/vstar.json", f"{OUT_DIR}/videos", model,
                               f"{OUT_DIR}/out.json", item_batch=args.items)
                seconds = time.perf_counter() - t0
                ran = model.waves[since:]
                decode_s = sum(w["stage_seconds"].get("decode", 0.0) for w in ran)
                steps = model.engine.decode_steps - steps0
                rows.setdefault(policy, list(tokens))
                CS.log("waves", budget=budget, policy=policy, seconds=round(seconds, 3),
                       requests=[w["requests"] for w in ran],
                       tower_passes=[w["tower_passes"] for w in ran],
                       wave_seconds=[round(w["seconds"], 3) for w in ran],
                       stage_seconds=[{k: round(v, 3) for k, v in w["stage_seconds"].items()}
                                      for w in ran],
                       decode_steps=steps, decode_ms_per_step=round(1e3 * decode_s / max(steps, 1), 3),
                       row_tokens=sorted({len(t) for t in tokens}),
                       peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
            same = sum(a == b for a, b in zip(rows["items"], rows["fill"]))
            CS.log("waves", budget=budget, rows=len(rows["items"]), same_tokens_both_policies=same)
    finally:
        waves.split_waves = real
        shutil.rmtree(OUT_DIR, ignore_errors=True)
    print(CS.card_line(), flush=True)


if __name__ == "__main__":
    main()
