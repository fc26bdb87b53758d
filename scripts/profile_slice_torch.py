"""Where the time goes in the PyTorch port's serving slice, on one GPU.

    python3 scripts/profile_slice_torch.py [--max-tokens N] [--trace PATH]
                                           [--long a|b | --int4 | --judge | --gspo | --sched]

Runs chip_smoke.py's full-width requests (Qwen2.5-VL-7B, random bf16
weights, 16 frames each) through InferenceEngine.generate once to warm up,
then once under torch.profiler. ``--long a`` or ``--long b`` profiles one of
chip_smoke.py's long-context runs instead (a: a 32736-token prompt with a
bf16 cache; b: 81888 tokens with an fp8 cache, prefilled in 8192-token
chunks), greedy, warmed up with a 2-token run of the same request.
``--int4`` serves the video slice with its decoder in group-128 int4 (K7);
``--judge`` profiles chip_smoke.py's judge call instead: Qwen2.5-72B-Instruct
in int4, EngineJudge's 4 jobs, 16 new tokens. ``--gspo`` profiles one step
of chip_smoke.py's GSPO phase (PEFT on the 7B, its sample and canned
traces; rollouts of --max-tokens, default 128, tokens a row, after a
warm-up step of the same size), its trainer stages (rollout, reward,
ref_logps, update) beside the engine's. ``--sched`` profiles chip_smoke.py's
phase 17a call: 14 requests (2 videos x 5 queries sharing a prefix, 4 long
texts) through 8 slots in 3 groups, 48 greedy tokens (--max-tokens
overrides), after a warm-up of the same call. Per engine stage (vision, prefill, decode)
it prints the wall time, the device busy time (sum of kernel durations
inside the stage's range, one stream), the idle share, and the top kernels
by device time, and the device time of K1, K2, K3, K4 and K7 (each
kernel family's kernels) in the stage and, for decode, per step.
``--trace PATH`` keeps the Chrome trace (tens of MB).

Decode runs graphed (the engine's default: one step captured as a CUDA
graph, then replayed) unless ``--eager`` is given. For the decode stage the
script also prints the host's launches per decode step: the CUDA runtime
and driver calls that launch work (``cudaLaunchKernel`` and its kin, and
``cudaGraphLaunch``) inside the stage, over the steps that ran. The
capture's range (``engine.decode_capture``) lies inside the decode stage
and counts in its wall time, idle share and launches; its own line gives
its share.
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


# Kernel families by their names or namespaces in csrc/: K1 (the row
# kernels at W = 64 and 128, the general route elsewhere), K2 (whole
# frames), K3 (k3, the prefill attention), K4 (k4, decode attention and its
# split sum), K7 (int4mm, the decode route and its split sum; int4wg, the
# prefill route), and the backward kernels of the training steps: K5 (dq;
# dk/dv per head and its group sum) and K6 (fused rows; whole frames)
FAMILIES = {"K1": ("fused_window_rows", "fused_window_attention"), "K2": ("window_attention_tma",),
            "K3": ("k3::",), "K4": ("k4::",), "K7": ("int4mm", "int4wg"),
            "K5": ("causal_dq_kernel", "causal_dkv_partial_kernel", "dkv_group_sum_kernel"),
            "K6": ("fused_window_bwd_rows_kernel", "window_bwd_frame_kernel")}


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
    ap.add_argument("--gspo", action="store_true",
                    help="profile one GSPO step (PEFT, chip_smoke.py's sample) instead")
    ap.add_argument("--sched", action="store_true",
                    help="profile chip_smoke.py's phase-17a scheduler call instead")
    ap.add_argument("--eager", action="store_true",
                    help="decode eagerly (the engine's decode_graph=False)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice_torch: needs a CUDA device")
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    cfg = Qwen25VLConfig()
    run = None
    if args.gspo:
        from open_o3_video_tpu_torch.train.gspo import GSPOConfig, GSPOTrainer
        from open_o3_video_tpu_torch.train.lora import LoraConfig

        proc = O3VideoProcessor()
        sample = cs.gspo_sample(proc, 0)
        trainer = GSPOTrainer(P.init(cfg, 0, dev), None, cfg,
                              GSPOConfig(max_completion_length=args.max_tokens or 128),
                              detokenize=cs.CannedTraces(proc), lora=LoraConfig(seed=0))
        engine = trainer.engine
        engine.decode_graph = not args.eager
        trainer.step(sample, global_step=0, max_steps=cs.GSPO_MAX_STEPS)  # warm-up

        def run():
            trainer.step(sample, global_step=1, max_steps=cs.GSPO_MAX_STEPS)
    elif args.judge:
        cfg = Qwen25VLConfig.from_hf_dict(QWEN25_72B_INSTRUCT_CONFIG)
        judge = EngineJudge(P.init(cfg, 0, dev, quantize_text="int4"),
                            max_new_tokens=cs.JUDGE_NEW_TOKENS, cfg=cfg,
                            processor=O3VideoProcessor())
        engine, reqs = judge.engine, [judge._request(*job) for job in cs.JUDGE_JOBS]
        engine.decode_graph = not args.eager
        sampling = dataclasses.replace(judge.sampling,
                                       max_tokens=args.max_tokens or cs.JUDGE_NEW_TOKENS)
        engine.generate(reqs, dataclasses.replace(sampling, max_tokens=2))  # warm-up
    elif args.sched:
        reqs = cs.scheduler_requests(O3VideoProcessor(), cfg, 0)
        engine = InferenceEngine(P.init(cfg, 0, dev), cfg, max_slots=cs.SCHED_SLOTS,
                                 decode_segment=cs.SCHED_SEGMENT, decode_graph=not args.eager)
        sampling = SamplingParams(temperature=0.0, repetition_penalty=1.05,
                                  max_tokens=args.max_tokens or cs.SCHED_TOKENS)
        engine.generate(reqs, sampling)  # warm-up
        engine.clear_prefix_cache()  # the profiled call builds its blocks again
    elif args.long:
        _, n, cache_dtype = next(run for run in cs.LONG_RUNS if run[0] == args.long)
        reqs = [cs.long_request(n)]
        engine = InferenceEngine(P.init(cfg, 0, dev), cfg, cache_dtype=cache_dtype,
                                 long_prefill_chunk=cs.LONG_CHUNK, decode_graph=not args.eager)
        sampling = SamplingParams(temperature=0.0, repetition_penalty=1.05,
                                  max_tokens=args.max_tokens or cs.LONG_NEW_TOKENS)
        engine.generate(reqs, SamplingParams(temperature=0.0, max_tokens=2))  # warm-up
    else:
        reqs = cs.make_requests(O3VideoProcessor(), cfg, seed=0)
        engine = InferenceEngine(P.init(cfg, 0, dev, quantize_text="int4" if args.int4 else False),
                                 cfg, decode_graph=not args.eager)
        sampling = SamplingParams(temperature=0.7, top_p=0.001, repetition_penalty=1.05,
                                  max_tokens=args.max_tokens or 16)
        engine.generate(reqs, sampling)  # warm-up: kernel build, cuBLAS heuristics
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    engine.decode_steps = engine.decode_steps_wasted = 0
    with torch.profiler.profile(activities=acts) as prof:
        if run is not None:
            run()
        else:
            engine.generate(reqs, sampling)
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or os.path.join(tmp, "slice_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    host_launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                     and "Launch" in str(e.get("name", ""))]
    stages = [e for e in events if e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith(("engine.", "stage."))]
    captures = [e for e in stages if e["name"] == "engine.decode_capture"]
    print(f"kernels={len(kernels)} stages={[s['name'] for s in stages]} "
          f"decode_graph={engine.decode_graph}", flush=True)
    for st in stages:
        t0, t1 = st["ts"], st["ts"] + st["dur"]
        inside = [k for k in kernels if t0 <= k["ts"] < t1]
        busy = sum(k["dur"] for k in inside)
        wall = st["dur"]
        by_name: collections.Counter = collections.Counter()
        for k in inside:
            by_name[k["name"][:90]] += k["dur"]
        print(f"[{st['name']}] wall_ms={wall / 1e3:.3f} busy_ms={busy / 1e3:.3f} "
              f"idle_share={1 - busy / wall:.3f} launches={len(inside)}", flush=True)
        ran = engine.decode_steps + engine.decode_steps_wasted
        steps = ran if st["name"] == "engine.decode" else 1
        if st["name"] == "engine.decode":
            inside_launches = [e for e in host_launches if t0 <= e["ts"] < t1]
            calls = collections.Counter(e["name"] for e in inside_launches)
            in_capture = sum(any(c["ts"] <= e["ts"] < c["ts"] + c["dur"] for c in captures)
                             for e in inside_launches)
            print(f"    host launches {sum(calls.values())} over {ran} steps "
                  f"({engine.decode_steps} useful, {engine.decode_steps_wasted} wasted): "
                  f"{sum(calls.values()) / max(ran, 1):.1f} a step, {in_capture} of them "
                  f"recorded by the capture; {dict(calls)}", flush=True)
        for family, marks in FAMILIES.items():
            dur = sum(k["dur"] for k in inside if any(ns in k["name"] for ns in marks))
            if dur:
                print(f"    {family} {dur / 1e3:.3f} ms ({100 * dur / max(busy, 1):.1f}%), "
                      f"{dur / 1e3 / max(steps, 1):.3f} ms per step over {steps}", flush=True)
        for name, dur in by_name.most_common(8):
            print(f"    {dur / 1e3:9.3f} ms {100 * dur / max(busy, 1):5.1f}%  {name}")


if __name__ == "__main__":
    main()
