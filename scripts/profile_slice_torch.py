"""Where the time goes in the PyTorch port's serving slice, on one GPU.

    python3 scripts/profile_slice_torch.py [--max-tokens N] [--trace PATH]
                                           [--long a|b | --int4 | --judge]

Runs chip_smoke.py's full-width requests (Qwen2.5-VL-7B, random bf16
weights, 16 frames each) through InferenceEngine.generate once to warm up,
then once under torch.profiler. ``--long a`` or ``--long b`` profiles one of
chip_smoke.py's long-context runs instead (a: a 32736-token prompt with a
bf16 cache; b: 81888 tokens with an fp8 cache, prefilled in 8192-token
chunks), greedy, warmed up with a 2-token run of the same request.
``--int4`` serves the video slice with its decoder in group-128 int4 (K7);
``--judge`` profiles chip_smoke.py's judge call instead: Qwen2.5-72B-Instruct
in int4, EngineJudge's 4 jobs, 16 new tokens. Per engine stage (vision, prefill, decode)
it prints the wall time, the device busy time (sum of kernel durations
inside the stage's range, one stream), the idle share, and the top kernels
by device time. ``--trace PATH`` keeps the Chrome trace (tens of MB).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from open_o3_video_tpu_torch.data.processor import O3VideoProcessor  # noqa: E402
from open_o3_video_tpu_torch.engine import InferenceEngine, SamplingParams  # noqa: E402
from open_o3_video_tpu_torch.eval.judge import QWEN25_72B_INSTRUCT_CONFIG, EngineJudge  # noqa: E402
from open_o3_video_tpu_torch.models.qwen25vl import Qwen25VLConfig, params as P  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-tokens", type=int, default=None,
                    help="new tokens (default 16; with --long, chip_smoke's 32, so that T "
                         "reaches 32768 and decode runs K4)")
    ap.add_argument("--trace", default=None, help="where to keep the Chrome trace")
    ap.add_argument("--long", choices=[name for name, _, _ in cs.LONG_RUNS], default=None,
                    help="profile this long-context run of chip_smoke.py instead")
    ap.add_argument("--int4", action="store_true", help="the decoder in group-128 int4 (K7)")
    ap.add_argument("--judge", action="store_true",
                    help="profile chip_smoke.py's 72B int4 judge call instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice_torch: needs a CUDA device")
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    cfg = Qwen25VLConfig()
    if args.judge:
        cfg = Qwen25VLConfig.from_hf_dict(QWEN25_72B_INSTRUCT_CONFIG)
        judge = EngineJudge(P.init(cfg, 0, dev, quantize_text="int4"), cs.JUDGE_NEW_TOKENS,
                            cfg=cfg, processor=O3VideoProcessor())
        engine, reqs = judge.engine, [judge._request(*job) for job in cs.JUDGE_JOBS]
        sampling = dataclasses.replace(judge.sampling,
                                       max_tokens=args.max_tokens or cs.JUDGE_NEW_TOKENS)
        engine.generate(reqs, dataclasses.replace(sampling, max_tokens=2))  # warm-up
    elif args.long:
        _, n, cache_dtype = next(run for run in cs.LONG_RUNS if run[0] == args.long)
        reqs = [cs.long_request(n)]
        engine = InferenceEngine(P.init(cfg, 0, dev), cfg, cache_dtype=cache_dtype,
                                 long_prefill_chunk=cs.LONG_CHUNK)
        sampling = SamplingParams(temperature=0.0, repetition_penalty=1.05,
                                  max_tokens=args.max_tokens or cs.LONG_NEW_TOKENS)
        engine.generate(reqs, SamplingParams(temperature=0.0, max_tokens=2))  # warm-up
    else:
        reqs = cs.make_requests(O3VideoProcessor(), cfg, seed=0)
        engine = InferenceEngine(P.init(cfg, 0, dev, quantize_text="int4" if args.int4 else False),
                                 cfg)
        sampling = SamplingParams(temperature=0.7, top_p=0.001, repetition_penalty=1.05,
                                  max_tokens=args.max_tokens or 16)
        engine.generate(reqs, sampling)  # warm-up: kernel build, cuBLAS heuristics
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        engine.generate(reqs, sampling)
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or os.path.join(tmp, "slice_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    stages = [e for e in events
              if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("engine.")]
    print(f"kernels={len(kernels)} stages={[s['name'] for s in stages]}", flush=True)
    for st in stages:
        t0, t1 = st["ts"], st["ts"] + st["dur"]
        inside = [k for k in kernels if t0 <= k["ts"] < t1]
        busy = sum(k["dur"] for k in inside)
        by_name: collections.Counter = collections.Counter()
        for k in inside:
            by_name[k["name"][:90]] += k["dur"]
        print(f"[{st['name']}] wall_ms={st['dur'] / 1e3:.3f} busy_ms={busy / 1e3:.3f} "
              f"idle_share={1 - busy / st['dur']:.3f} launches={len(inside)}", flush=True)
        for name, dur in by_name.most_common(8):
            print(f"    {dur / 1e3:9.3f} ms {100 * dur / max(busy, 1):5.1f}%  {name}")


if __name__ == "__main__":
    main()
