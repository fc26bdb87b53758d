"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed 0]

Phases (one line each; any failure raises and the exit code is non-zero):
  1. the card: name and power limit (nvidia-smi), TF32 flags;
  2. build the CUDA kernels from open_o3_video_tpu_torch/csrc (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version at the serving slice's
     shapes, bf16 on the card: max abs error vs a stated bound, and times
     (CUDA events, warmup, median of 20, kernel and plain in turns);
  4. the serving slice at the full width of Qwen2.5-VL-7B (random bf16
     weights drawn on the card from --seed): 2 requests of 16 synthetic
     252x336 frames, processor -> InferenceEngine.generate with the reference
     sampling (temperature 0.7, top_p 0.001, repetition penalty 1.05) for 64
     new tokens; stage times, peak memory, and each kernel's launch count,
     which must be > 0;
  5. the slice's numerics on the engine's prefill layout (the requests as
     one left-padded batch, a cache of L + 64 slots): vision embeddings and
     last-position prefill logits of the kernel path and of the plain bf16
     path (impl="torch"), each against a float32 reference (relative error
     and cosine; the kernel path may be at most SLICE_REL_RATIO further from
     it), and identical tokens from two kernel-path runs.
Then one JSON line with the per-kernel results, and as the last line
{"ok": true, "device": {...}}. Without a CUDA device it raises before any
result is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from open_o3_video_tpu_torch.data.processor import O3VideoProcessor
from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.engine.engine import left_padded_rows
from open_o3_video_tpu_torch.models.qwen25vl import Qwen25VLConfig, params as P
from open_o3_video_tpu_torch.models.qwen25vl.model import (
    build_vision_row_index,
    embed_tokens,
    encode_vision,
    merge_vision_embeddings_by_index,
)
from open_o3_video_tpu_torch.models.qwen25vl.text import (
    init_kv_cache,
    logits_from_hidden,
    text_forward,
)
from open_o3_video_tpu_torch.models.qwen25vl.vision import compute_vision_spec
from open_o3_video_tpu_torch.ops import kernels
from open_o3_video_tpu_torch.ops import flash_attention as fa
from open_o3_video_tpu_torch.ops import window_attention as wa

# The reference's system prompt for grounded free-form video QA
# ("temporal-spatial free-form QA"), so the prompt has its real length.
SYSTEM_PROMPT = (
    "A conversation between user and assistant. The user provides a video and asks a "
    "question, and the Assistant solves it. The assistant MUST first think about the "
    "reasoning process in the mind and then provide the user with the answer. The reasoning "
    "process and answer are enclosed within <think> </think> and <answer> </answer> tags, "
    "respectively. All reasoning must be grounded in visual evidence from the video. When you "
    "mention any related object, person, or specific visual element in the reasoning process, "
    "you must strictly follow the following format: "
    "`<obj>object_name</obj><box>bounding_box</box>at<t>time_in_seconds</t>s`. The answer "
    "part only requires a text response; tags like <obj>, <box>, <t> are not needed."
)
# One request per question; their lengths differ, so one row is left-padded.
QUESTIONS = ["What is the color of the bowling ball?", "What is the first scene about?"]
N_FRAMES, FRAME_H, FRAME_W, FPS = 16, 252, 336, 2.0
MAX_TOKENS = 64

# Kernel vs plain version, bf16 on the card, outputs of unit scale: one bf16
# ulp at |x| < 2 is 2^-7; the kernel's summation order can also flip the
# bf16 rounding of single probabilities. Bound on the max abs error:
KERNEL_ATOL = 2e-2
# Whole slice (numerics_phase): the kernel path's relative error against a
# float32 reference may exceed the plain bf16 path's by at most this factor.
# Both errors are dominated by the bf16 rounding the two paths share; their
# own rounding differences add in quadrature, so equal accuracy gives a
# ratio near 1, and a wrong kernel (errors of order 1) a ratio far above.
SLICE_REL_RATIO = 1.25

TPU_KERNELS = {
    "fused_window_attention": ("open_o3_video_tpu_torch/csrc/window_attention.cu",
                               "open_o3_video_tpu/ops/window_attention.py:359"),
    "window_attention": ("open_o3_video_tpu_torch/csrc/window_attention.cu",
                         "open_o3_video_tpu/ops/window_attention.py:112"),
    "flash_attention_gqa": ("open_o3_video_tpu_torch/csrc/flash_attention.cu",
                            "open_o3_video_tpu/ops/flash_attention.py:48"),
}


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> list[float]:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def compare(name, kernel_fn, plain_fn, keep, results):
    """Max abs error over the kept rows, then times in turns (plain,
    kernel, kernel, plain)."""
    out, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise RuntimeError(f"{name}: non-finite kernel output")
    err = (out.float() - ref.float())[keep].abs().max().item()
    p1, k1, k2, p2 = (time_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
    ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
    log("kernels", name=name, shape=tuple(out.shape), max_abs_err=err, atol=KERNEL_ATOL,
        ms=round(ms, 4), plain_ms=round(plain_ms, 4))
    if not err <= KERNEL_ATOL:
        raise RuntimeError(f"{name}: max abs error {err} > {KERNEL_ATOL}")
    prev = results.get(name)
    if prev is None:  # the first case of a kernel is its main-path shape
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    else:
        prev["max_abs_err"] = max(prev["max_abs_err"], err)


def kernel_phase(dev, cfg, gen, batch_rows, t_total) -> dict:
    """Each kernel vs its plain version at the main path's shapes."""
    v = cfg.vision
    results: dict = {}

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    for grid_hw in ((18, 24), (18, 26)):  # W = 64 (the slice), W = 128 (packed rows)
        spec = compute_vision_spec([(1, *grid_hw)] * N_FRAMES, v)
        w = spec.win_w
        emb = np.concatenate([spec.padded_freqs, spec.padded_freqs], -1)
        cos = torch.from_numpy(np.cos(emb).reshape(-1, w, v.head_dim)).to(dev)
        sin = torch.from_numpy(np.sin(emb).reshape(-1, w, v.head_dim)).to(dev)
        ids = torch.from_numpy(spec.padded_gids.reshape(-1, w)).to(dev)
        qkv = bf16(ids.shape[0], w, 3 * v.hidden_size)
        compare("fused_window_attention",
                lambda: wa.fused_window_attention(qkv, cos, sin, ids, v.num_heads),
                lambda: wa.fused_window_attention_torch(qkv, cos, sin, ids, v.num_heads),
                ids != 0, results)
        if grid_hw == (18, 24):
            frame_ids = torch.from_numpy(
                spec.padded_valid.reshape(-1, spec.frame_w).astype(np.int32)).to(dev)
            q, k, vv = (bf16(*frame_ids.shape, v.num_heads, v.head_dim) for _ in range(3))
            compare("window_attention",
                    lambda: wa.window_attention(q, k, vv, frame_ids),
                    lambda: wa.window_attention_torch(q, k, vv, frame_ids),
                    frame_ids != 0, results)

    t = cfg.text
    B, S = len(batch_rows), max(batch_rows)
    q = bf16(B, S, t.num_attention_heads, t.head_dim)
    cache = torch.zeros((2, t.num_hidden_layers, B, t_total, t.num_key_value_heads, t.head_dim),
                        dtype=torch.bfloat16, device=dev)
    k, vv = cache[0, 3], cache[1, 3]  # layer views of the stacked cache
    k.copy_(bf16(*k.shape))
    vv.copy_(bf16(*vv.shape))
    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    valid = torch.zeros((B, t_total), dtype=torch.int32, device=dev)
    for b, n in enumerate(batch_rows):  # left padding, as the engine lays rows out
        valid[b, S - n:S] = 1
    compare("flash_attention_gqa",
            lambda: fa.flash_attention_gqa(q, k, vv, pos, valid),
            lambda: fa.flash_attention_gqa_torch(q, k, vv, pos, valid),
            valid[:, :S] != 0, results)
    return results


def make_requests(proc, cfg, seed: int) -> list[Request]:
    """One grounded-QA request per question, each over its own 16
    synthetic frames."""
    rng = np.random.default_rng(seed)
    reqs = []
    for question in QUESTIONS:
        frames = rng.integers(0, 256, size=(N_FRAMES, 3, FRAME_H, FRAME_W), dtype=np.uint8)
        frame_prompt = "".join(
            f"Frame {j + 1} at {round(j / FPS, 1)} second: "
            "<|vision_start|><|image_pad|><|vision_end|>\n" for j in range(N_FRAMES)
        )
        prompt = proc.apply_chat_template([
            {"role": "system", "content": [{"type": "text", "text": SYSTEM_PROMPT}]},
            {"role": "user", "content": [{"type": "text", "text": frame_prompt},
                                         {"type": "text", "text": question}]},
        ], add_generation_prompt=True)
        x = proc(prompt, images=list(frames))
        reqs.append(Request(input_ids=x.input_ids, pixel_patches=x.pixel_patches,
                            grid_thw=x.grid_thw, vision_token_id=cfg.image_token_id))
    return reqs


def slice_phase(engine, reqs, sampling) -> list[dict]:
    """The main path, through the entry points a user calls. Returns the
    outputs; every kernel's launch count must be > 0."""
    dev = engine.device
    engine.generate(reqs, SamplingParams(**{**vars(sampling), "max_tokens": 2}))  # warm-up
    engine.stage_seconds.clear()
    engine.decode_steps = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    outs = engine.generate(reqs, sampling)
    e2e = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name] for name in TPU_KERNELS}
    st = engine.stage_seconds
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    log("slice", requests=len(reqs), prompt_tokens=[o["num_prompt_tokens"] for o in outs],
        new_tokens=[len(o["token_ids"]) for o in outs],
        vision_ms=round(1e3 * st["vision"], 3), prefill_ms=round(1e3 * st["prefill"], 3),
        decode_ms_per_token=round(1e3 * st["decode"] / max(engine.decode_steps, 1), 3),
        e2e_s=round(e2e, 3), peak_mem_gib=round(peak, 3))
    log("slice", launches=launches)
    vocab = engine.cfg.text.vocab_size
    for o in outs:
        if not 1 <= len(o["token_ids"]) <= sampling.max_tokens:
            raise RuntimeError(f"bad output length {len(o['token_ids'])}")
        if not all(0 <= t < vocab for t in o["token_ids"]):
            raise RuntimeError("token id out of the vocabulary")
    if dev.type == "cuda" and not all(launches.values()):
        raise RuntimeError(f"a kernel of the path never launched: {launches}")
    return outs


def _agreement(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    a, b = a.double().flatten(), b.double().flatten()
    rel = ((a - b).norm() / b.norm()).item()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
    return rel, cos


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def _vision_and_logits(params, cfg, reqs, impl):
    """Vision embeddings of every request and the last-position prefill
    logits of each row, laid out as InferenceEngine.generate lays out its
    prefill: one tower pass per request, the rows left-padded to L and
    merged by index, a cache of L + MAX_TOKENS slots."""
    dev = params["text"]["embed_tokens"].device
    L = max(len(r.input_ids) for r in reqs)
    ids, mask, position_ids, _ = left_padded_rows(cfg, reqs, L)
    attn_valid = torch.zeros((len(reqs), L + MAX_TOKENS), dtype=torch.bool, device=dev)
    attn_valid[:, :L] = torch.from_numpy(mask).to(dev)
    with torch.inference_mode():
        vis = [encode_vision(params, cfg, torch.from_numpy(r.pixel_patches).to(dev), r.grid_thw,
                             impl=impl) for r in reqs]
        offsets = np.cumsum([0] + [x.shape[0] for x in vis[:-1]]).tolist()
        vis = torch.cat(vis)
        row_index = build_vision_row_index(ids, cfg.image_token_id, offsets)
        embeds = merge_vision_embeddings_by_index(
            embed_tokens(params, torch.from_numpy(ids).to(dev)), vis,
            torch.from_numpy(row_index).to(dev))
        hidden, _ = text_forward(
            params["text"], cfg.text, embeds, torch.from_numpy(position_ids).to(dev),
            attn_valid=attn_valid, attn_impl=impl,
            cache=init_kv_cache(cfg.text, len(reqs), L + MAX_TOKENS, dtype=cfg.dtype,
                                device=dev),
        )
        logits = logits_from_hidden(params["text"], hidden[:, -1])
    return vis.float(), logits.float()


def numerics_phase(params, cfg, reqs) -> None:
    """The slice's numerics at full width, all requests. Two bf16 paths that
    round differently drift apart by a few percent over 60 random-init
    layers, so the kernel path is not held to the plain bf16 path. Both are
    held to a float32 reference (the same weights in f32, plain versions):
    the kernel path must be as close to it as the plain bf16 path is, within
    SLICE_REL_RATIO."""
    kernel = _vision_and_logits(params, cfg, reqs, "auto")
    plain = _vision_and_logits(params, cfg, reqs, "torch")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    ref = _vision_and_logits(_cast(params, torch.float32), cfg32, reqs, "torch")
    torch.cuda.empty_cache()
    for i, what in enumerate(("vision", "logits")):
        rel_k, cos_k = _agreement(kernel[i], ref[i])
        rel_p, cos_p = _agreement(plain[i], ref[i])
        rel_kp, cos_kp = _agreement(kernel[i], plain[i])
        log("numerics", what=what, kernel_vs_f32_rel=rel_k, kernel_vs_f32_cos=cos_k,
            plain_vs_f32_rel=rel_p, plain_vs_f32_cos=cos_p, kernel_vs_plain_rel=rel_kp,
            kernel_vs_plain_cos=cos_kp, max_ratio=SLICE_REL_RATIO)
        if not (torch.isfinite(kernel[i]).all() and rel_k <= SLICE_REL_RATIO * rel_p):
            raise RuntimeError(f"{what}: the kernel path is further from float32 than the "
                               f"plain bf16 path ({rel_k} vs {rel_p})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    log("card", torch=torch.__version__, cuda=torch.version.cuda,
        matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    kernels.library()
    seconds = time.perf_counter() - t0
    regs = [line.split("Used ")[1].split(",")[0]
            for line in (kernels.build_dir() / "build.log").read_text().splitlines()
            if "Used " in line]
    log("build", seconds=round(seconds, 3), dir=kernels.build_dir().name, registers=regs)

    cfg = Qwen25VLConfig()  # Qwen2.5-VL-7B, bf16
    proc = O3VideoProcessor()
    reqs = make_requests(proc, cfg, args.seed)
    rows = [len(r.input_ids) for r in reqs]
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    results = kernel_phase(dev, cfg, gen, rows, max(rows) + MAX_TOKENS)

    t0 = time.perf_counter()
    params = P.init(cfg, args.seed, dev)
    torch.cuda.synchronize()
    log("init", params=P.count(params), seconds=round(time.perf_counter() - t0, 3))
    engine = InferenceEngine(params, cfg)
    sampling = SamplingParams(temperature=0.7, top_p=0.001, repetition_penalty=1.05,
                              max_tokens=MAX_TOKENS, seed=args.seed)
    outs = slice_phase(engine, reqs, sampling)
    launches = {name: kernels.LAUNCHES[name] for name in TPU_KERNELS}
    log("slice", first_token_ids=[o["token_ids"][:8] for o in outs])

    numerics_phase(params, cfg, reqs)
    again = engine.generate(reqs, sampling)
    same = [a["token_ids"] == b["token_ids"] for a, b in zip(outs, again)]
    log("numerics", identical_tokens_across_runs=same)
    if not all(same):
        raise RuntimeError("two kernel-path runs gave different tokens")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], **results[name]}
        for name, (src, tpu) in TPU_KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
