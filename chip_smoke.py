"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed 0]

Phases (one line each; any failure raises and the exit code is non-zero):
  1. the card: name and power limit (nvidia-smi), TF32 flags;
  2. build the CUDA kernels from open_o3_video_tpu_torch/csrc (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version at the serving slice's
     shapes, bf16 on the card: max abs error vs a bound at the reference's
     scale and relative L2 error vs a bound (faults planted in K1's and
     K4's outputs must fail them), and times (CUDA events, warmup, median
     of 20, kernel and plain in turns); K1 at W = 64 (16 frames of 18x24
     patches, its row) and W = 128 (18x26); K2 also at frames of 32x32
     patches (W = 1024, past its resident limit: K and V stream); K3 also
     at the 72B judge's prefill (64/8 heads) and on run (b)'s last prefill
     chunk (8160 rows against 81920 slots: 64 rows compared, the whole
     chunk timed beside its bound and SDPA);
  4. the serving slice at the full width of Qwen2.5-VL-7B (random bf16
     weights drawn on the card from --seed): 2 requests of 16 synthetic
     252x336 frames, processor -> InferenceEngine.generate with the reference
     sampling (temperature 0.7, top_p 0.001, repetition penalty 1.05) for 64
     new tokens; stage times, peak memory, and each kernel's launch count,
     which must be > 0. Every phase decodes graphed, the engine's default:
     one decode step captured as a CUDA graph per generate call and
     replayed, the tokens read back once at the end;
  5. the slice's numerics on the engine's prefill layout (the requests as
     one left-padded batch, a cache of L + 64 slots): vision embeddings and
     last-position prefill logits of the kernel path and of the plain bf16
     path (impl="torch"), each against a float32 reference (relative error
     and cosine; the kernel path may be at most SLICE_REL_RATIO further from
     it); the same requests decoded eagerly (decode_graph=False) must give
     the graphed run's tokens (every decoding path below is held so, with
     ms/token of both, the capture included, the speedup, the capture ms,
     wasted steps and kernel launches per step); then the early-stop
     check: a copy of the config whose EOS is the token that an eager
     greedy run emits at step 5, eager and graphed stopping at the same
     token, wasting at most the done flags' lag, DONE_LAG - 1 steps;
  6. the long-context path (the reference's max_model_len=81920): one
     text-only request per run through InferenceEngine.generate, greedy,
     repetition penalty 1.05, 32 new tokens: (a) a 32736-token prompt with a
     bf16 cache, (b) an 81888-token prompt with an fp8 e4m3 cache, prefilled
     in 8192-token chunks; stage times, peak memory, and K3 and K4 launch
     counts, which must be > 0 in each run;
  7. the long-context numerics: one decode step's logits on (b)'s prefilled
     fp8 cache with K4 (impl="auto") and with its plain version
     (impl="torch"), within LONG_LOGITS_REL / LONG_LOGITS_COS of each other
     and each against a float32 step (SLICE_REL_RATIO); then (a) and (b)
     again, decoding eagerly: the same tokens as the graphed runs.
  8. the training kernels against their plain versions at the SFT slice's
     shapes: the exact (training) modes of K1-K3, out and lse (K1's also at
     W = 128, K2's also at W = 1024, K3's also at 64/8 heads); K5 (dq; dk
     and dv) and K6 (fused dqkv, also at W = 128; the global blocks' dq; dk
     and dv), with their bounds and the time of one PyTorch call computing
     the same function; four planted faults must fail the bound (K5: dq from
     delta = 0, dk/dv over 6 of the 7 group heads; K6: the rope transpose
     left out, frame 0's segment mask ignored in dk/dv);
  9. the SFT slice: 3 full fine-tune steps of Qwen2.5-VL-7B through
     make_train_step on one example of 16 synthetic frames (SFTConfig
     defaults: AdamW lr 1e-6 after a global-norm clip at 1.0, remat), step
     1 first repeated without its update under the profiler; per step the
     seconds, loss, gradient norm and target tokens, the peak memory, and
     each training kernel's launch count, which must be > 0;
 10. the training numerics at full width and 8 ViT blocks / 2 decoder
     layers: loss and gradients of the kernel path and the plain bf16 path
     against float32, per group (ViT, decoder, embedding and lm_head).
 11. K7, the int4 matmul, against its plain version (bf16, the bound of
     phase 3) by the route its row count takes: decode (M <= 64, split-K)
     at the 7B gate_w, lm_head, k_w (N = 512) and down_w (K = 18944) and the
     72B down_w (231 groups), k_w and gate_w; prefill (wgmma) at the 7B
     gate_w and k_w and the 72B down_w (231 groups). Each with
     the bound, the bf16 torch.matmul on the dequantized weight and
     torch._weight_int4pack_mm on the same codes as yardsticks, and the
     same bits from two calls; two planted faults (nibbles swapped, scales
     one group off) must fail the bound. Then the K7a probes (stream,
     convert) and K7 at the TPU scripts' shape, 3584->18944 at M=16, chained
     over 8 weights as scripts/profile_int4_kernel_parts.py chains them;
 12. the 7B video slice with its decoder in int4 (quantize_params_int4 of
     the phase-4 param dict, after phase 9's steps): phase 4's requests and
     sampling through InferenceEngine.generate, stage times, weight and
     peak GiB, K7 launches by route (the prefill's 7 * 28 decoder matmuls
     on the wgmma route, its lm_head at the last positions and 7 * 28 + 1
     per decode step that ran on the mma.sync one), the same requests
     decoded eagerly giving the same tokens; the prefill logits of the K7
     path and of the plain int4 path each against float32 on the same int4
     weights (SLICE_REL_RATIO), and the int4-vs-bf16 distance as
     information;
 13. the judge: Qwen2.5-72B-Instruct at full width and depth (its published
     config.json) in int4 on the card, drawn and quantized leaf by leaf,
     EngineJudge.batch on 4 jobs with 16 new tokens, twice (the second
     call decoding eagerly, which must give the same tokens): init seconds,
     weight and peak GiB, prefill ms, decode ms/token, the scores (-1 with
     random weights), K7 launches by route as in phase 12 (7 * 80 on the
     wgmma route, then 1 + 7 * 80 + 1 per decode step that ran), K3's
     launches in the call (its prefill), and identical scores across the
     two calls.
 14. GSPO (after phase 10, before phase 11; run_grpo_video.sh under
     --use_peft): the phase-4 7B weights frozen, LoRA adapters (rank 16,
     alpha 32, q_proj/v_proj) from --seed, GSPOConfig defaults (G = 4, 768
     completion tokens, beta 0.04, clip 5.0, lr 1e-6) on one
     "temporal-spatial free-form QA" example (the slice's 16 frames and one
     keyframe through rl_sample_from_frames), row r of each group scored as
     the r-th of four canned grounded traces (random weights write text no
     reward scores; the real text's rewards are printed too). Step 1, a
     checkpoint, step 2; step 1's checkpoint restored and step 2 again: the
     same tokens, rewards, loss and kl. Per step the stage seconds, lengths,
     loss, kl, rewards, peak GiB, the rollout's decode ms/token and every
     kernel's launches (K1, K2, K3 in both modes and K5 > 0); B moved off
     0, the base bit for bit unchanged, no sample degraded and vision in
     the reference logps. Then one rollout of the trained policy at 128
     tokens a row, graphed and eager: the same tokens. Then the GSPO
     numerics at 8 ViT blocks / 2 decoder layers (policy logps and adapter
     gradients of the kernel and plain bf16 paths against float32,
     SLICE_REL_RATIO), and one full fine-tune step at full width, 8 ViT
     blocks and 4 decoder layers, against a frozen reference copy (K6 and
     the exact modes of K1 and K2 must launch).
 15. the SFT app (after phase 14, before phase 11): [media] probes g++, the
     libavformat, libavcodec, libavutil and libswscale headers and libraries
     and cv2, and prints the readers the port will use for videos and images
     (decided by the probe before anything is read). With a video reader: a
     raw AVI (32 frames of 252x336 at 16 fps) and a PNG keyframe written
     without an encoder (data/raw_media.py) in the reference's layout, read
     back exactly by every reader present (the native decoder built first,
     its build and decode times printed, when libav is there), fetch_video at
     16 frames. Then 3 PEFT SFT steps of the frozen 7B through
     make_lora_train_step (sft_main's default adapters: LoRA rank 16, alpha
     32 on q_proj/v_proj) on collate_sft_batch of the temporal-spatial
     example over those files (without a reader: collate_sft_frames on
     phase 9's synthetic frames): per step the seconds, loss, gradient norm,
     target tokens and peak GiB, the last step's device time by kernel
     class under the profiler; K1 and K2 in their inference modes, K3
     exact and K5 launched, K6 not; B moved off 0 and the base bit for bit
     unchanged. Then (with a reader) sft_main.main end to end under
     --use_peft on phase 10's cut of the model written as a checkpoint
     directory, over a two-example json (temporal-spatial, General video QA
     MCQ): run A 2 steps, run B 1 step, run C resuming B to 2; C's step 2
     loss and merged export must equal A's bit for bit.
Then one JSON line with the per-kernel results, and as the last line
{"ok": true, "device": {...}}. Without a CUDA device it raises before any
result is printed.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import filecmp
import gc
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from open_o3_video_tpu_torch.data import video as TV
from open_o3_video_tpu_torch.data.processor import O3VideoProcessor
from open_o3_video_tpu_torch.data.raw_media import write_png, write_raw_avi
from open_o3_video_tpu_torch.data.sft_dataset import (
    collate_sft_batch,
    collate_sft_frames,
    pack_sft_batch,
    prepare_sft_example,
)
from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.engine.engine import DONE_LAG, chunked_prefill, left_padded_rows
from open_o3_video_tpu_torch.eval.judge import QWEN25_72B_INSTRUCT_CONFIG, EngineJudge
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
from open_o3_video_tpu_torch.ops import decode_attention as da
from open_o3_video_tpu_torch.ops import flash_attention as fa
from open_o3_video_tpu_torch.ops import int4 as i4
from open_o3_video_tpu_torch.ops import quant
from open_o3_video_tpu_torch.ops import window_attention as wa
from open_o3_video_tpu_torch.data.rl_dataset import rl_sample_from_frames
from open_o3_video_tpu_torch.grounding.prompts import SFT_SYSTEM_PROMPT
from open_o3_video_tpu_torch.grounding.rewards import REWARD_REGISTRY, sum_rewards
from open_o3_video_tpu_torch.native import video_decoder
from open_o3_video_tpu_torch.train import (
    SFTConfig,
    loss_and_grads,
    make_lora_train_step,
    make_optimizer,
    make_train_step,
)
from open_o3_video_tpu_torch.train import checkpoint as CKPT
from open_o3_video_tpu_torch.train import sft_main
from open_o3_video_tpu_torch.train.gspo import GSPOConfig, GSPOTrainer, gspo_loss, completion_logps
from open_o3_video_tpu_torch.train.lora import (
    LoraConfig,
    adapter_leaves,
    apply_adapters,
    init_adapters,
)

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

# Kernel vs plain version, bf16 on the card. At outputs of unit scale one
# bf16 ulp at |x| < 2 is 2^-7, and the kernel's summation order can also flip
# the bf16 rounding of single probabilities; the max abs error is bounded by
# KERNEL_ATOL times the reference's scale, min(1, max|ref|). Attention over t
# random keys gives outputs ~sqrt(e/t) (0.006 at t = 81888), so a bound at
# unit scale would be as large as the output itself. The relative L2 error is
# bounded too: one ulp flip moves an element by at most 2^-7 of itself, while
# dropping n of t keys moves the output by ~sqrt(n/t) (decode_cases plants
# such faults, which must fail).
KERNEL_ATOL = 2e-2
KERNEL_REL_L2 = 1e-2
# Whole slice (numerics_phase): the kernel path's relative error against a
# float32 reference may exceed the plain bf16 path's by at most this factor.
# Both errors are dominated by the bf16 rounding the two paths share; their
# own rounding differences add in quadrature, so equal accuracy gives a
# ratio near 1, and a wrong kernel (errors of order 1) a ratio far above.
SLICE_REL_RATIO = 1.25
# Long-context numerics: K4 vs its plain version inside one full-width decode
# step. Only K4 differs between the two runs, at one query position, so the
# logits may differ by bf16 rounding carried through 28 layers; bounded by
# the whole-prefill kernel/plain difference of the slice (4.5% in logits).
# Both bf16 steps are also held to a float32 step on the same cache: the K4
# step may be at most SLICE_REL_RATIO further from it than the plain one.
LONG_LOGITS_REL = 0.05
LONG_LOGITS_COS = 0.998

# The long-context runs: (name, prompt tokens, cache dtype). T = prompt + 32
# slots: 32768 and 81920 (the reference's max_model_len).
LONG_RUNS = (("a", 32736, torch.bfloat16), ("b", 81888, torch.float8_e4m3fn))
LONG_NEW_TOKENS = 32
LONG_CHUNK = 8192  # the engine's long_prefill_chunk
K4_TILE_KEYS = da.TILE_KEYS  # K4's key tile (kTile in csrc/decode_attention.cu)

TPU_KERNELS = {
    "fused_window_attention": ("open_o3_video_tpu_torch/csrc/window_attention.cu",
                               "open_o3_video_tpu/ops/window_attention.py:359"),
    "window_attention": ("open_o3_video_tpu_torch/csrc/window_attention.cu",
                         "open_o3_video_tpu/ops/window_attention.py:112"),
    "flash_attention_gqa": ("open_o3_video_tpu_torch/csrc/flash_attention.cu",
                            "open_o3_video_tpu/ops/flash_attention.py:48"),
    "decode_attention_gqa": ("open_o3_video_tpu_torch/csrc/decode_attention.cu",
                             "open_o3_video_tpu/ops/decode_attention.py:103"),
    # the training (exact) modes of K1-K3, and K5 and K6
    "fused_window_attention_exact": ("open_o3_video_tpu_torch/csrc/window_attention.cu",
                                     "open_o3_video_tpu/ops/window_attention.py:359"),
    "window_attention_exact": ("open_o3_video_tpu_torch/csrc/window_attention.cu",
                               "open_o3_video_tpu/ops/window_attention.py:112"),
    "flash_attention_gqa_exact": ("open_o3_video_tpu_torch/csrc/flash_attention.cu",
                                  "open_o3_video_tpu/ops/flash_attention.py:48"),
    "flash_attention_gqa_bwd_dq": ("open_o3_video_tpu_torch/csrc/flash_attention_bwd.cu",
                                   "open_o3_video_tpu/ops/flash_attention.py:246"),
    "flash_attention_gqa_bwd_dkv": ("open_o3_video_tpu_torch/csrc/flash_attention_bwd.cu",
                                    "open_o3_video_tpu/ops/flash_attention.py:295"),
    "fused_window_attention_bwd": ("open_o3_video_tpu_torch/csrc/window_attention_bwd.cu",
                                   "open_o3_video_tpu/ops/window_attention.py:406"),
    "window_attention_bwd_dq": ("open_o3_video_tpu_torch/csrc/window_attention_bwd.cu",
                                "open_o3_video_tpu/ops/window_attention.py:158"),
    "window_attention_bwd_dkv": ("open_o3_video_tpu_torch/csrc/window_attention_bwd.cu",
                                 "open_o3_video_tpu/ops/window_attention.py:158"),
    # K7, and the K7a probes of the TPU profiling scripts
    "int4_matmul": ("open_o3_video_tpu_torch/csrc/int4_matmul.cu",
                    "open_o3_video_tpu/ops/int4.py:107"),
    "int4_matmul_wgmma": ("open_o3_video_tpu_torch/csrc/int4_matmul_sm90.cu",
                          "open_o3_video_tpu/ops/int4.py:107"),
    "int4_matmul_stream": ("open_o3_video_tpu_torch/csrc/int4_matmul.cu",
                           "scripts/profile_int4_kernel_parts.py:61"),
    "int4_matmul_convert": ("open_o3_video_tpu_torch/csrc/int4_matmul.cu",
                            "scripts/profile_int4_kernel_parts.py:84"),
}
# The kernels each main path must launch.
SLICE_KERNELS = ("fused_window_attention", "window_attention", "flash_attention_gqa")
LONG_KERNELS = ("flash_attention_gqa", "decode_attention_gqa")
TRAIN_KERNELS = tuple(list(TPU_KERNELS)[4:12])
K7_ROUTES = ("int4_matmul", "int4_matmul_wgmma")  # decode, prefill (i4.kernel_route)
INT4_SLICE_KERNELS = SLICE_KERNELS + K7_ROUTES
PROBE_KERNELS = ("int4_matmul_stream", "int4_matmul_convert", "int4_matmul")
# K7 (phase 11): (case, M, K, N) at the main paths' shapes; the first case
# of each route gives its row. M None: the 7B slice's prefill, its 2 rows of
# L tokens; M 3984: the judge's prefill, 4 jobs of up to 996 tokens.
INT4_CASES = (("7B decode gate_w", 2, 3584, 18944), ("7B prefill gate_w", None, 3584, 18944),
              ("7B decode lm_head", 2, 3584, 152064), ("72B decode down_w", 4, 29568, 8192),
              ("7B decode k_w", 2, 3584, 512), ("7B decode down_w", 2, 18944, 3584),
              ("72B decode k_w", 4, 8192, 1024), ("72B decode gate_w", 4, 8192, 29568),
              ("7B prefill k_w", None, 3584, 512), ("72B prefill down_w", 3984, 29568, 8192))
# The K7a probes' shape and chain (scripts/profile_int4_kernel_parts.py:
# 3584 -> 18944 at M = 16, a scan over distinct weights).
PROBE_M, PROBE_K, PROBE_N, PROBE_CHAIN = 16, 3584, 18944, 8
# Outputs of the int4 comparisons have std ~0.25 (weights scaled by
# 1/sqrt(K)): below 2 one bf16 ulp is within KERNEL_ATOL.
INT4_OUT_STD = 0.25
# The judge (phase 13): the reference's eval_vstar.py judge, greedy.
JUDGE_JOBS = (
    ("What is the color of the bowling ball?", "It is red.", "The ball is red."),
    ("What happens first?", "A man rolls a ball down the lane.", "A dog runs across a field."),
    ("How many pins fall?", "All ten pins fall.", "Most of the pins fall down."),
    ("Where is the bowler standing?", "At the foul line.", "Near the foul line of the lane."),
)
JUDGE_NEW_TOKENS = 16
# The judge's prompts in ByteTokenizer tokens (phase 13 prints them), for K3
# at the judge's prefill shape in phase 3.
JUDGE_PROMPT_ROWS = (982, 990, 991, 996)
# The SFT slice: one grounded example over the serving slice's 16 frames,
# with the reference's SFT system prompt and temporal frame prompt, and a
# target of a few hundred bytes in the reference's answer format.
SFT_TASK = "temporal-spatial free-form QA"
SFT_QUESTION = "What happens to the bowling ball?"
SFT_ANSWER = (
    "<think>At the start a <obj>bowling ball</obj><box>[142,96,198,150]</box>at<t>0.5</t>s "
    "leaves the bowler's hand and rolls down the lane. It hooks toward the head pin, and the "
    "<obj>pins</obj><box>[120,20,230,88]</box>at<t>5.5</t>s scatter when it arrives.</think>\n"
    "<answer>The bowling ball rolls down the lane and knocks the pins down.</answer>"
)
SFT_STEPS = 3
# The training numerics phase: full width, depth cut to 8 ViT blocks (global
# block 7 among them) and 2 decoder layers, so three models (kernel, plain
# bf16, float32) fit beside each other on the card.
NUMERICS_VIT_DEPTH, NUMERICS_TEXT_LAYERS = 8, 2
# Gradients of the kernel tests: dout at 0.1 keeps them under ~1, where one
# bf16 ulp of reordered sums is within KERNEL_ATOL (at unit dout dk reaches
# ~8, where one ulp is 2^-5).
DOUT_SCALE = 0.1
# The GSPO slice (run_grpo_video.sh under --use_peft: LoRA rank 16, alpha 32
# on q_proj/v_proj; GSPOConfig defaults: G = 4, 768 completion tokens, beta
# 0.04, clip 5.0, lr 1e-6): one "temporal-spatial free-form QA" example in
# the RL data's format over the slice's 16 frames and one keyframe.
GSPO_EXAMPLE = {
    "task": "temporal-spatial free-form QA",
    "source": "STR_plm_rdcap",
    "video_path": "synthetic.mp4",
    "question": "What happens to the bowling ball after it leaves the bowler's hand?",
    "answer": "The bowling ball rolls down the lane and knocks the pins down.",
    "key_frames": [{"time": 3.0, "idx": 0, "path": "synthetic_kf_0.jpg"}],
    "key_items": {"0": {"bowling ball": [[0.42, 0.38, 0.59, 0.6]]}},
}
# Random weights give text that no reward scores, so row r of each group is
# scored as the r-th of these traces, of falling quality: the seven rewards
# differ within the group and the advantages are not zero.
GSPO_TRACES = (
    "<think>The <obj>bowling ball</obj><box>[141,96,198,151]</box>at<t>3.0</t>s rolls "
    "toward the pins and they fall at <t>6.5</t>s.</think>\n<answer>The bowling ball rolls "
    "down the lane and knocks the pins down.</answer>",
    "<think>A <obj>bowling ball</obj><box>[20,30,90,110]</box>at<t>1.0</t>s is thrown."
    "</think>\n<answer>The ball rolls down the lane.</answer>",
    "<think>Someone is bowling.</think>\n<answer>A man walks away.</answer>",
    "the pins <answer>nothing",
)
GSPO_MAX_STEPS = 2  # step_percent = (global_step + 1) / GSPO_MAX_STEPS
GSPO_CKPT_DIR = "checkpoints/chip_smoke_gspo"  # in the checkout (gitignored), removed after
# The kernels the GSPO step must launch (PEFT: vision frozen, so K1 and K2
# run their inference modes; the update's decoder runs K3 exact and K5).
GSPO_KERNELS = ("fused_window_attention", "window_attention", "flash_attention_gqa",
                "flash_attention_gqa_exact", "flash_attention_gqa_bwd_dq",
                "flash_attention_gqa_bwd_dkv")
# The full fine-tune branch: full width, depth cut so the trained copy, its
# gradients and AdamW state and the frozen reference fit beside the 7B base.
FT_VIT_DEPTH, FT_TEXT_LAYERS = 8, 4
FT_KERNELS = GSPO_KERNELS + ("fused_window_attention_exact", "window_attention_exact",
                             "fused_window_attention_bwd", "window_attention_bwd_dq",
                             "window_attention_bwd_dkv")
# Decode, graphed (the engine's default) against eager (decode_graph=False),
# on every decoding path: the tokens must be equal. The GSPO rollout is held
# at this many completion tokens a row; the early-stop check's EOS is the
# token the eager greedy run emits at step EARLY_STOP_STEP.
GSPO_CHECK_TOKENS = 128
EARLY_STOP_STEP = 5
# The SFT app (phase 15): a raw AVI of 32 frames of 252x336 at 16 fps and a
# PNG keyframe, written without an encoder, in the reference's media layout;
# a two-example STGR-CoT json (temporal-spatial with the keyframe, General
# video QA MCQ) read at 16 frames a video. The PEFT step is sft_main's
# default adapters (LoRA rank 16, alpha 32 on q_proj/v_proj) over the frozen
# 7B; sft_main runs at phase 10's cut of the model.
SFT_APP_DIR = "checkpoints/chip_smoke_sft_app"  # in the checkout (gitignored), removed after
SFT_APP_FRAMES, SFT_APP_FPS, SFT_APP_NFRAMES = 32, 16.0, 16
SFT_APP_EXAMPLES = [
    {"task": "temporal-spatial free-form QA", "source": "STR_plm_rdcap", "video_path": "clip.avi",
     "question": SFT_QUESTION,
     "reasoning_process": "A <obj>bowling ball</obj><box>[0.42,0.38,0.59,0.6]</box>at<t>1.0</t>s "
                          "rolls down the lane toward the pins.",
     "answer": "The bowling ball rolls down the lane and knocks the pins down.",
     "key_frames": [{"time": 1.0, "idx": 0, "path": "kf0.png"}]},
    {"task": "General video QA MCQ", "source": "videor1_mcq", "video_path": "clip.avi",
     "question": "What rolls down the lane? A. a bowling ball B. a cup C. a dog D. nothing",
     "reasoning_process": "A heavy round ball rolls toward the pins.", "answer": "A"},
]
SFT_APP_STEPS = 3
# PEFT: the frozen tower runs K1 and K2's inference modes, the decoder K3's
# exact mode and K5; no ViT backward, so K6 (and K1/K2's exact modes) never.
SFT_PEFT_KERNELS = GSPO_KERNELS[:2] + GSPO_KERNELS[3:]
SFT_PEFT_ABSENT = ("fused_window_attention_exact", "window_attention_exact",
                   "fused_window_attention_bwd", "window_attention_bwd_dq",
                   "window_attention_bwd_dkv")
# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): bf16 tensor cores and HBM3. The bound of a kernel is the larger of
# its operations and its bytes at these rates.
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
# A spin queued before each timed call (~2 ms at the H100's clock), so the
# host has enqueued the call before its start event runs: the events then
# time the call's device work, not the wrapper's Python.
SPIN_CYCLES = 4_000_000


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> list[float]:
    """CUDA-event times of `fn`, each call behind a SPIN_CYCLES spin
    (torch.cuda._sleep). The spin came in with K4: without it the events
    also timed the wrapper's Python, so K1-K3 read 1-24% lower with it than
    their earlier times in PERF.md."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def agreement(out, ref, keep) -> dict:
    """`out` against `ref` over the kept rows (``keep`` None: all): max abs
    error, its bound (KERNEL_ATOL at the reference's scale), relative L2
    error, and whether both are within their bounds. Tuples of outputs (a
    backward's dq, dk, dv) are held element by element, with a tuple of
    masks; the worst element is reported."""
    if isinstance(out, (tuple, list)):
        keeps = keep if isinstance(keep, (tuple, list)) else (keep,) * len(out)
        parts = [agreement(o, r, k) for o, r, k in zip(out, ref, keeps)]
        worst = max(parts, key=lambda a: a["rel_l2"] / KERNEL_REL_L2
                    + a["max_abs_err"] / max(a["bound"], 1e-30))
        return {**worst, "ok": all(a["ok"] for a in parts),
                "max_abs_err": max(a["max_abs_err"] for a in parts)}
    out, ref = out.float(), ref.float()
    if keep is not None:
        out, ref = out[keep], ref[keep]
    err = (out - ref).abs().max().item()
    bound = KERNEL_ATOL * min(1.0, ref.abs().max().item())
    rel = ((out - ref).norm() / ref.norm()).item()
    return {"max_abs_err": err, "bound": bound, "rel_l2": rel,
            "ok": err <= bound and rel <= KERNEL_REL_L2}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(flops: float, moved: int) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations at
    the bf16 dense peak and the bytes (each input read once, each output
    written once) at the memory rate."""
    t_ops, t_bytes = 1e3 * flops / H100_BF16_FLOPS, 1e3 * moved / H100_HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def causal_pairs(pos, valid) -> int:
    """Visible (query, key) pairs of a causal mask: key t <= position and
    kv_valid[t], counted from this run's data."""
    seen = torch.cumsum(valid.long(), dim=1)  # (B, T) valid keys at or before t
    idx = pos.long().clamp(min=-1, max=valid.shape[1] - 1)
    got = torch.gather(seen, 1, idx.clamp(min=0))
    return int(torch.where(idx >= 0, got, 0).sum().item())


def segment_pairs(ids) -> int:
    """Visible (query, key) pairs of a segment mask (same nonzero id)."""
    g = ids.long()
    counts = torch.zeros((g.shape[0], int(g.max().item()) + 1), dtype=torch.long,
                         device=g.device).scatter_add_(1, g, torch.ones_like(g))
    return int((counts[:, 1:] ** 2).sum().item())


def compare(name, kernel_fn, plain_fn, keep, results, *, flops=0.0, moved=0,
            library_fn=None, case=None):
    """The kernel's agreement with its plain version over the kept rows,
    then times in turns (plain, kernel, kernel, plain), the bound from the
    work (`flops`, `moved` bytes) and, where one PyTorch call computes the
    same function, that call's time. The first case of a kernel is its
    main-path shape and gives its row in the JSON line."""
    out, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    outs = out if isinstance(out, (tuple, list)) else (out,)
    if not all(torch.isfinite(o.float()).all() for o in outs):
        raise RuntimeError(f"{name}: non-finite kernel output")
    a = agreement(out, ref, keep)
    err = a["max_abs_err"]
    p1, k1, k2, p2 = (time_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
    ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
    lib_ms = statistics.median(time_ms(library_fn)) if library_fn is not None else None
    b_ms, b_by = bound_ms(flops, moved)
    log("kernels", name=name, **({} if case is None else {"case": case}),
        shape=tuple(outs[0].shape), max_abs_err=err, bound=a["bound"],
        rel_l2=a["rel_l2"], max_rel_l2=KERNEL_REL_L2, ms=round(ms, 4), plain_ms=round(plain_ms, 4),
        bound_ms=round(b_ms, 4), bound_by=b_by,
        library_ms=None if lib_ms is None else round(lib_ms, 4))
    if not a["ok"]:
        raise RuntimeError(f"{name}: kernel vs plain {a}, max rel L2 {KERNEL_REL_L2}")
    prev = results.get(name)
    if prev is None:
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": lib_ms}
    else:
        prev["max_abs_err"] = max(prev["max_abs_err"], err)
    return ref


def sdpa_masked(q, k, v, mask):
    """One PyTorch call computing masked attention (B, S, H, D) layout in,
    for the library time: scaled_dot_product_attention with a boolean mask
    (B, 1, S, T), GQA by enable_gqa."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                          attn_mask=mask, enable_gqa=True)


def causal_mask(pos, valid):
    """(B, 1, S, T) boolean mask of the decoder's causal attention."""
    t = torch.arange(valid.shape[1], device=valid.device)
    return ((t[None, None, :] <= pos[:, :, None]) & (valid[:, None, :] != 0))[:, None]


def segment_mask(ids):
    g = ids.to(torch.int32)
    return ((g[:, :, None] == g[:, None, :]) & (g[:, None, :] != 0))[:, None]


# K1's and K6's packed window rows: 16 frames of 18x24 patches (W = 64,
# the slice and the SFT step; its case gives the kernels' rows) and of 18x26
# (W = 128, two windows a row).
WINDOW_ROW_GRIDS = ((18, 24), (18, 26))


def window_row_inputs(dev, gen, v, grid_hw):
    """The tower's packed window rows over N_FRAMES frames of grid_hw
    patches: segment ids (N, W), the rope tables cos, sin (N, W, D) float32
    and a random bf16 qkv projection (N, W, 3 * hidden)."""
    spec = compute_vision_spec([(1, *grid_hw)] * N_FRAMES, v)
    w = spec.win_w
    emb = np.concatenate([spec.padded_freqs, spec.padded_freqs], -1)
    cos = torch.from_numpy(np.cos(emb).reshape(-1, w, v.head_dim)).to(dev)
    sin = torch.from_numpy(np.sin(emb).reshape(-1, w, v.head_dim)).to(dev)
    ids = torch.from_numpy(spec.padded_gids.reshape(-1, w)).to(dev)
    qkv = torch.randn((ids.shape[0], w, 3 * v.hidden_size), generator=gen, device=dev)
    return ids, cos, sin, qkv.to(torch.bfloat16)


# K2's frames: the slice's 18x24 patches (W = 448, its K/V resident) and
# 32x32 (W = 1024, a 448x448 frame, streamed); the first gives K2's row.
K2_FRAME_GRIDS = ((18, 24), (32, 32))


def frame_inputs(dev, gen, v, grid_hw, scale=1.0):
    """Segment ids (N_FRAMES, W) of whole frames of grid_hw patches and
    random bf16 q, k, v and dout (dout at `scale`, 0 at pad rows)."""
    spec = compute_vision_spec([(1, *grid_hw)] * N_FRAMES, v)
    ids = torch.from_numpy(spec.padded_valid.reshape(-1, spec.frame_w).astype(np.int32)).to(dev)
    q, k, vv, do = (torch.randn((*ids.shape, v.num_heads, v.head_dim), generator=gen, device=dev)
                    for _ in range(4))
    do = (scale * do).to(torch.bfloat16)
    do[ids == 0] = 0  # the tower never reads a pad row
    return ids, q.to(torch.bfloat16), k.to(torch.bfloat16), vv.to(torch.bfloat16), do


def kernel_phase(dev, cfg, gen, batch_rows, t_total) -> dict:
    """Each kernel vs its plain version at the main path's shapes."""
    v = cfg.vision
    results: dict = {}

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    for grid_hw in WINDOW_ROW_GRIDS:
        ids, cos, sin, qkv = window_row_inputs(dev, gen, v, grid_hw)
        out_bytes = qkv.numel() // 3 * 2
        rq, rk, rv = wa._rope_qk(qkv, cos, sin, v.num_heads)
        seg = segment_mask(ids)
        ref = compare("fused_window_attention",
                      lambda: wa.fused_window_attention(qkv, cos, sin, ids, v.num_heads),
                      lambda: wa.fused_window_attention_torch(qkv, cos, sin, ids, v.num_heads),
                      ids != 0, results,
                      flops=4 * segment_pairs(ids) * v.num_heads * v.head_dim,
                      moved=nbytes(qkv, cos, sin, ids) + out_bytes,
                      library_fn=lambda: sdpa_masked(rq, rk, rv, seg), case=f"W = {ids.shape[1]}")
        if grid_hw == WINDOW_ROW_GRIDS[0]:  # fault: the rope on k left out
            raw_k = qkv.view(*rq.shape[:2], 3, *rq.shape[2:])[:, :, 1]
            planted("fused_window_attention", "rope on k left out",
                    wa.window_attention_torch(rq, raw_k, rv, ids).reshape(ref.shape), ref, ids != 0)
        del qkv, rq, rk, rv, seg, ref
    for grid_hw in K2_FRAME_GRIDS:
        frame_ids, q, k, vv, _ = frame_inputs(dev, gen, v, grid_hw)
        fseg = segment_mask(frame_ids)
        compare("window_attention",
                lambda: wa.window_attention(q, k, vv, frame_ids),
                lambda: wa.window_attention_torch(q, k, vv, frame_ids),
                frame_ids != 0, results,
                flops=4 * segment_pairs(frame_ids) * v.num_heads * v.head_dim,
                moved=nbytes(q, k, vv, frame_ids) + nbytes(q),
                library_fn=lambda: sdpa_masked(q, k, vv, fseg))
        del q, k, vv, fseg

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
    mask = causal_mask(pos, valid)
    compare("flash_attention_gqa",
            lambda: fa.flash_attention_gqa(q, k, vv, pos, valid),
            lambda: fa.flash_attention_gqa_torch(q, k, vv, pos, valid),
            valid[:, :S] != 0, results,
            flops=4 * causal_pairs(pos, valid) * t.num_attention_heads * t.head_dim,
            moved=nbytes(q, k, vv, pos, valid) + nbytes(q),
            library_fn=lambda: sdpa_masked(q, k, vv, mask))
    del cache
    judge_prefill_case(dev, gen, results)
    decode_cases(dev, cfg, gen, results)
    long_chunk_case(dev, cfg, gen, results)
    return results


def judge_prefill_case(dev, gen, results) -> None:
    """K3 at the judge's prefill (phase 13): JUDGE_PROMPT_ROWS tokens,
    left-padded into one batch, a cache of L + JUDGE_NEW_TOKENS slots,
    Qwen2.5-72B's 64/8 heads of 128 (a GQA group of 8)."""
    t = Qwen25VLConfig.from_hf_dict(QWEN25_72B_INSTRUCT_CONFIG).text
    B, S = len(JUDGE_PROMPT_ROWS), max(JUDGE_PROMPT_ROWS)
    T = S + JUDGE_NEW_TOKENS
    q = torch.randn((B, S, t.num_attention_heads, t.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    cache = torch.randn((2, 2, B, T, t.num_key_value_heads, t.head_dim), generator=gen,
                        device=dev).to(torch.bfloat16)
    k, v = cache[0, 1], cache[1, 1]  # layer views of a stacked cache
    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
    for b, n in enumerate(JUDGE_PROMPT_ROWS):
        valid[b, S - n:S] = 1
    mask = causal_mask(pos, valid)
    compare("flash_attention_gqa",
            lambda: fa.flash_attention_gqa(q, k, v, pos, valid),
            lambda: fa.flash_attention_gqa_torch(q, k, v, pos, valid),
            valid[:, :S] != 0, results, case="judge prefill, 64/8 heads",
            flops=4 * causal_pairs(pos, valid) * t.num_attention_heads * t.head_dim,
            moved=nbytes(q, k, v, pos, valid) + nbytes(q),
            library_fn=lambda: sdpa_masked(q, k, v, mask))
    del cache, mask


def _layer_views(dev, gen, cfg, B, T, written, dtype):
    """k/v as layer views of a stacked (2, 2, B, T, Hkv, D) cache in `dtype`:
    random values in the first `written` slots, NaN garbage after them (the
    kernel must never read it)."""
    t = cfg.text
    cache = torch.full((2, 2, B, T, t.num_key_value_heads, t.head_dim), float("nan"),
                       dtype=torch.bfloat16, device=dev)
    cache[:, :, :, :written] = torch.randn(cache[:, :, :, :written].shape, generator=gen,
                                           device=dev).to(torch.bfloat16)
    cache = cache.to(dtype)
    return cache[0, 1], cache[1, 1]


def decode_cases(dev, cfg, gen, results) -> None:
    """K4 vs its plain version on the long-context path's decode shapes. The
    plain version reads the written slots only: it multiplies masked values
    by 0, and the garbage tail is NaN. The first case is K4's main-path row
    (run (b)'s decode step)."""
    t = cfg.text
    # (B, S, T, last written position, stored dtype)
    for B, S, T, last, dtype in ((1, 1, 81920, 81887, torch.float8_e4m3fn),
                                 (1, 1, 32768, 32735, torch.bfloat16),
                                 (2, 4, 40000, 39990, torch.float8_e4m3fn)):
        k, v = _layer_views(dev, gen, cfg, B, T, last + 1, dtype)
        q = torch.randn((B, S, t.num_attention_heads, t.head_dim), generator=gen,
                        device=dev).to(torch.bfloat16)
        pos = torch.arange(last - S + 1, last + 1, dtype=torch.int32, device=dev).repeat(B, 1)
        valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
        valid[:, :last + 1] = 1
        if B > 1:
            valid[1, :1000] = 0  # a left-padded row
            pos[1, 0] = -1  # a pad query row, which sees nothing
        w = last + 1
        kb, vb = k[:, :w].to(torch.bfloat16), v[:, :w].to(torch.bfloat16)  # SDPA takes no fp8
        mask = causal_mask(pos, valid[:, :w])
        compare("decode_attention_gqa",
                lambda: da.decode_attention_gqa(q, k, v, pos, valid),
                lambda: da.decode_attention_gqa_torch(q, k[:, :w], v[:, :w], pos, valid[:, :w]),
                pos >= 0, results,
                flops=4 * causal_pairs(pos, valid) * t.num_attention_heads * t.head_dim,
                moved=nbytes(q, k[:, :w], v[:, :w], pos, valid) + nbytes(q),
                library_fn=lambda: sdpa_masked(q, kb, vb, mask))
        del kb, vb
        if T == 81920:
            planted_faults(q, k[:, :w], v[:, :w], pos, valid[:, :w], T)
        del k, v
    torch.cuda.empty_cache()


def planted_faults(q, k, v, pos, valid, T) -> None:
    """The bound must reject a K4 that returns 0, drops one split of the key
    range, or drops the last (partial) key tile. The faulty outputs are the
    plain version with those keys masked, laid out as K4 splits a T-slot
    buffer: da.split_tiles of the K4_TILE_KEYS-key tiles of [0, w) over
    da._splits splits."""
    B, w, Hkv = k.shape[0], k.shape[1], k.shape[2]
    ref = da.decode_attention_gqa_torch(q, k, v, pos, valid)
    splits, tiles = da._splits(B, Hkv, T), -(-w // K4_TILE_KEYS)
    dropped = {"one split": da.split_tiles(tiles, splits)[splits // 2],
               "last tile": (tiles - 1, tiles)}
    faults = {"zero output": torch.zeros_like(ref)}
    for fault, (t0, t1) in dropped.items():
        masked = valid.clone()
        masked[:, t0 * K4_TILE_KEYS:t1 * K4_TILE_KEYS] = 0
        faults[f"{fault} dropped ({min(t1 * K4_TILE_KEYS, w) - t0 * K4_TILE_KEYS} of {w} keys)"] = (
            da.decode_attention_gqa_torch(q, k, v, pos, masked))
    for fault, out in faults.items():
        a = agreement(out, ref, pos >= 0)
        log("kernels", name="decode_attention_gqa", planted_fault=fault,
            max_abs_err=a["max_abs_err"], bound=a["bound"], rel_l2=a["rel_l2"],
            rejected=not a["ok"])
        if a["ok"]:
            raise RuntimeError(f"K4's bound does not reject a planted fault: {fault}")


def long_chunk_case(dev, cfg, gen, results) -> None:
    """K3 on the last prefill chunk of run (b): 8160 query rows at positions
    73728..81887 against an 81920-slot cache. Compared on 64 of the rows
    (the plain version at the whole chunk would need ~75 GB of f32 scores),
    passed with their positions to both versions; then timed at the whole
    chunk, with its bound (the causal pairs and bytes of the whole chunk)
    and SDPA on the whole chunk with its boolean mask."""
    t = cfg.text
    n, T = LONG_RUNS[1][1], LONG_RUNS[1][1] + LONG_NEW_TOKENS
    c0 = (n - 1) // LONG_CHUNK * LONG_CHUNK
    k, v = _layer_views(dev, gen, cfg, 1, T, T, torch.bfloat16)
    q = torch.randn((1, n - c0, t.num_attention_heads, t.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    pos = torch.arange(c0, n, dtype=torch.int32, device=dev)[None]
    valid = torch.zeros((1, T), dtype=torch.int32, device=dev)
    valid[:, :n] = 1
    rows = torch.arange(0, n - c0, 128, device=dev)[:64]
    qs, ps = q[:, rows].contiguous(), pos[:, rows].contiguous()
    compare("flash_attention_gqa",
            lambda: fa.flash_attention_gqa(qs, k, v, ps, valid),
            lambda: fa.flash_attention_gqa_torch(qs, k, v, ps, valid),
            ps >= 0, results, case="long prefill chunk, 64 of its rows",
            flops=4 * causal_pairs(ps, valid) * t.num_attention_heads * t.head_dim,
            moved=nbytes(qs, k, v, ps, valid, qs))
    full = statistics.median(time_ms(lambda: fa.flash_attention_gqa(q, k, v, pos, valid), reps=5))
    b_ms, b_by = bound_ms(4 * causal_pairs(pos, valid) * t.num_attention_heads * t.head_dim,
                          nbytes(q, k, v, pos, valid, q))
    mask = causal_mask(pos, valid)
    try:  # a yardstick only
        lib = statistics.median(time_ms(lambda: sdpa_masked(q, k, v, mask), reps=3, warmup=1))
    except torch.OutOfMemoryError:
        lib = None
    log("kernels", name="flash_attention_gqa", case="long prefill chunk", shape=tuple(q.shape),
        T=T, ms=round(full, 4), bound_ms=round(b_ms, 4), bound_by=b_by,
        library_ms=None if lib is None else round(lib, 4),
        tflops=round(4 * causal_pairs(pos, valid) * t.num_attention_heads * t.head_dim
                     / full / 1e9, 1))
    del k, v, q, mask
    torch.cuda.empty_cache()


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


def decode_run(engine, call):
    """``call()`` (a generate through ``engine``, or an entry point over
    it) with the engine's decode counters and the launch counts set to 0
    just before. Returns its result and the decode's numbers: ms per token
    (the whole decode stage, the capture included, over the steps that
    emitted a token), capture ms (a part of it), steps, wasted steps
    (enqueued after every row finished), and the hand-written kernels'
    launches made inside the decode loops (``kernels.LAUNCHES``, which
    counts a replayed graph's kernels once per replay) in all and per step
    that ran."""
    engine.stage_seconds.clear()
    engine.decode_steps = engine.decode_steps_wasted = 0
    decode_launches: collections.Counter = collections.Counter()
    real = engine._decode

    def counted(*args, **kw):
        before = collections.Counter(kernels.LAUNCHES)
        out = real(*args, **kw)
        decode_launches.update(collections.Counter(kernels.LAUNCHES) - before)
        return out

    engine._decode = counted
    torch.cuda.synchronize()
    kernels.reset_launches()
    try:
        out = call()
    finally:
        del engine._decode
    st, ran = engine.stage_seconds, engine.decode_steps + engine.decode_steps_wasted
    return out, {"ms_per_token": round(1e3 * st["decode"] / max(engine.decode_steps, 1), 3),
                 "capture_ms": round(1e3 * st["decode_capture"], 3),
                 "steps": engine.decode_steps, "wasted": engine.decode_steps_wasted,
                 "launches": dict(decode_launches),
                 "launches_per_step": round(sum(decode_launches.values()) / max(ran, 1), 3)}


def decode_pair(path: str, graph: dict, eager: dict, graph_tokens, eager_tokens) -> None:
    """A path's graphed decode held against its eager one: ms per token of
    both, the speedup, the capture, wasted steps, and the hand-written
    kernels' launches per step (the same for both: the tokens and the
    decode's kernel launch counts must be equal)."""
    same = graph_tokens == eager_tokens
    log("decode", path=path, graph_ms_per_token=graph["ms_per_token"],
        eager_ms_per_token=eager["ms_per_token"],
        speedup=round(eager["ms_per_token"] / max(graph["ms_per_token"], 1e-9), 3),
        capture_ms=graph["capture_ms"], steps=graph["steps"],
        wasted_steps={"graph": graph["wasted"], "eager": eager["wasted"]},
        kernel_launches_per_step=graph["launches_per_step"],
        decode_kernel_launches=graph["launches"], identical_tokens=same)
    if not same:
        raise RuntimeError(f"{path}: the graphed decode's tokens differ from the eager decode's")
    if graph["launches"] != eager["launches"] or graph["steps"] != eager["steps"]:
        raise RuntimeError(f"{path}: graphed and eager decode counted different launches or "
                           f"steps: {graph} vs {eager}")


def slice_phase(engine, reqs, sampling, names=SLICE_KERNELS) -> tuple[list[dict], dict, dict]:
    """The main path, through the entry points a user calls. Returns the
    outputs, the launch counts of ``names`` (each must be > 0) and the
    decode's numbers (``decode_run``)."""
    dev = engine.device
    engine.generate(reqs, SamplingParams(**{**vars(sampling), "max_tokens": 2}))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs, decode = decode_run(engine, lambda: engine.generate(reqs, sampling))
    e2e = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name] for name in names}
    st = engine.stage_seconds
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    log("slice", requests=len(reqs), prompt_tokens=[o["num_prompt_tokens"] for o in outs],
        new_tokens=[len(o["token_ids"]) for o in outs],
        vision_ms=round(1e3 * st["vision"], 3), prefill_ms=round(1e3 * st["prefill"], 3),
        decode_ms_per_token=decode["ms_per_token"], decode_capture_ms=decode["capture_ms"],
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
    return outs, launches, decode


def eager_pair(path: str, params, cfg, reqs, sampling, graph_outs, graph: dict,
               **engine_kw) -> list[dict]:
    """The same requests through an engine that decodes eagerly, held
    against the graphed run's outputs and numbers (``decode_pair``)."""
    engine = InferenceEngine(params, cfg, decode_graph=False, **engine_kw)
    outs, eager = decode_run(engine, lambda: engine.generate(reqs, sampling))
    decode_pair(path, graph, eager, [o["token_ids"] for o in graph_outs],
                [o["token_ids"] for o in outs])
    return outs


def early_stop_check(params, cfg, req) -> None:
    """A copy of the config whose EOS is the token that an eager greedy run
    emits at step EARLY_STOP_STEP: the eager and the graphed decode must stop
    at the same token, with at most DONE_LAG - 1 steps run after it."""
    sampling = SamplingParams(temperature=0.0, repetition_penalty=1.05, max_tokens=MAX_TOKENS)
    first = InferenceEngine(params, cfg, decode_graph=False).generate([req], sampling)[0]
    eos = first["token_ids"][EARLY_STOP_STEP]
    stop_cfg = dataclasses.replace(cfg, eos_token_id=eos)
    runs = {}
    for graphed in (True, False):
        engine = InferenceEngine(params, stop_cfg, decode_graph=graphed)
        runs[graphed] = decode_run(engine, lambda: engine.generate([req], sampling)[0])
    (g_out, graph), (e_out, eager) = runs[True], runs[False]
    log("decode", path="early stop", eos=eos, stopped_after=len(g_out["token_ids"]))
    decode_pair("early stop", graph, eager, g_out["token_ids"], e_out["token_ids"])
    if g_out["token_ids"][-1] != eos or len(g_out["token_ids"]) > EARLY_STOP_STEP + 1:
        raise RuntimeError(f"the early-stop run did not stop at its EOS {eos}: {g_out}")
    if graph["wasted"] > DONE_LAG - 1:
        raise RuntimeError(f"{graph['wasted']} wasted steps: more than the {DONE_LAG - 1} "
                           "the done flags' lag allows")


def long_request(n: int) -> Request:
    """A text-only prompt of n tokens, made as the JAX bench's long-context
    leg makes it (ids 100 + i % 500, ByteTokenizer byte ids)."""
    return Request(input_ids=[100 + (i % 500) for i in range(n)])


def long_sampling(seed: int) -> SamplingParams:
    """The JAX bench's long-context leg: greedy, repetition penalty 1.05."""
    return SamplingParams(temperature=0.0, repetition_penalty=1.05,
                          max_tokens=LONG_NEW_TOKENS, seed=seed)


def long_run(engine, n, sampling) -> tuple[list[int], dict, dict]:
    """One long-context request through InferenceEngine.generate: stage
    times, peak memory and launch counts; K3 and K4 must both launch.
    Returns the tokens, the launch counts and the decode's numbers."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, decode = decode_run(engine, lambda: engine.generate([long_request(n)], sampling)[0])
    e2e = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name] for name in LONG_KERNELS}
    st = engine.stage_seconds
    log("longctx", prompt_tokens=out["num_prompt_tokens"], cache=str(engine.cache_dtype),
        T=n + sampling.max_tokens, new_tokens=len(out["token_ids"]),
        decode_graph=engine.decode_graph, prefill_ms=round(1e3 * st["prefill"], 3),
        prefill_tok_per_s=round(n / st["prefill"], 1),
        decode_ms_per_token=decode["ms_per_token"], decode_capture_ms=decode["capture_ms"],
        e2e_s=round(e2e, 3), peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    log("longctx", launches=launches)
    vocab = engine.cfg.text.vocab_size
    if not 1 <= len(out["token_ids"]) <= sampling.max_tokens:
        raise RuntimeError(f"bad output length {len(out['token_ids'])}")
    if not all(0 <= t < vocab for t in out["token_ids"]):
        raise RuntimeError("token id out of the vocabulary")
    if not all(launches.values()):
        raise RuntimeError(f"a kernel of the long-context path never launched: {launches}")
    return out["token_ids"], launches, decode


def long_phase(params, cfg, seed) -> tuple[dict, dict, dict]:
    """Runs (a) and (b), after a warm-up at (a)'s size. Returns each run's
    tokens, launch counts and decode numbers."""
    sampling = long_sampling(seed)
    engines = {name: InferenceEngine(params, cfg, cache_dtype=dtype, long_prefill_chunk=LONG_CHUNK)
               for name, _, dtype in LONG_RUNS}
    engines["a"].generate([long_request(LONG_RUNS[0][1])],
                          dataclasses.replace(sampling, max_tokens=2))
    tokens, launches, decode = {}, {}, {}
    t0 = time.perf_counter()
    for name, n, _ in LONG_RUNS:
        tokens[name], launches[name], decode[name] = long_run(engines[name], n, sampling)
    log("longctx", runs_seconds=round(time.perf_counter() - t0, 3),
        first_token_ids={k: v[:8] for k, v in tokens.items()})
    torch.cuda.empty_cache()
    return tokens, launches, decode


def _agreement(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    a, b = a.double().flatten(), b.double().flatten()
    rel = ((a - b).norm() / b.norm()).item()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
    return rel, cos


def _cast(tree, dtype):
    """The param dict in ``dtype``; an int4 weight is dequantized."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    if isinstance(tree, i4.Int4Linear):
        return i4.dequantize(tree, dtype)
    return tree.detach().to(dtype)


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
        logits = logits_from_hidden(params["text"], hidden[:, -1], impl)
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


def long_numerics_phase(params, cfg) -> None:
    """K4 inside the full path: run (b)'s request prefilled by the kernel
    path into a fresh fp8 cache, then one decode step's text_forward with
    attn_impl "auto" (K4) and "torch" (its plain version), each on a copy of
    the cache. A decode step runs no other kernel, so only K4 differs. Both
    are also compared with the same step in float32 (the same weights in
    f32, plain versions, the same fp8 cache)."""
    _, n, dtype = LONG_RUNS[1]
    T = n + LONG_NEW_TOKENS
    dev = params["text"]["embed_tokens"].device
    _, _, position_ids, next_pos = left_padded_rows(cfg, [long_request(n)], n)
    ids = torch.tensor([long_request(n).input_ids], device=dev)
    attn_valid = torch.zeros((1, T), dtype=torch.bool, device=dev)
    attn_valid[:, :n + 1] = True
    with torch.inference_mode():
        cache = init_kv_cache(cfg.text, 1, T, dtype=dtype, device=dev)
        hidden = chunked_prefill(params["text"], cfg.text, embed_tokens(params, ids),
                                 torch.from_numpy(position_ids).to(dev), attn_valid, cache,
                                 LONG_CHUNK)
        token = logits_from_hidden(params["text"], hidden[:, -1]).argmax(-1)
        logits = {}
        for name, weights, impl in (("kernel", params, "auto"), ("plain", params, "torch"),
                                    ("f32", {"text": _cast(params["text"], torch.float32)},
                                     "torch")):
            step_cache = {key: x.clone() for key, x in cache.items()}
            h, _ = text_forward(
                weights["text"], cfg.text, embed_tokens(weights, token[:, None]),
                torch.from_numpy(next_pos).to(dev)[None, :, None].expand(3, 1, 1),
                seq_positions=torch.full((1, 1), n, device=dev), attn_valid=attn_valid,
                cache=step_cache, cache_offset=n, attn_impl=impl)
            logits[name] = logits_from_hidden(weights["text"], h[:, 0])
            del step_cache, weights
    rel, cos = _agreement(logits["kernel"], logits["plain"])
    rel_k, _ = _agreement(logits["kernel"], logits["f32"])
    rel_p, _ = _agreement(logits["plain"], logits["f32"])
    log("numerics", what="long-context decode step logits (fp8 cache, T=81920)",
        kernel_vs_plain_rel=rel, kernel_vs_plain_cos=cos, max_rel=LONG_LOGITS_REL,
        min_cos=LONG_LOGITS_COS, kernel_vs_f32_rel=rel_k, plain_vs_f32_rel=rel_p,
        max_ratio=SLICE_REL_RATIO)
    if not (torch.isfinite(logits["kernel"]).all() and rel <= LONG_LOGITS_REL
            and cos >= LONG_LOGITS_COS and rel_k <= SLICE_REL_RATIO * rel_p):
        raise RuntimeError(f"long-context decode: K4 vs plain logits rel {rel}, cos {cos}; "
                           f"vs float32 {rel_k} (plain {rel_p})")
    del cache
    torch.cuda.empty_cache()


# ---- training ---------------------------------------------------------------


def sft_batch(proc, cfg, seed: int) -> dict:
    """The SFT slice's batch: one example over 16 synthetic frames through
    the port's collate and pack (ByteTokenizer, labels masked)."""
    frames = np.random.default_rng(seed + 1).integers(
        0, 256, size=(N_FRAMES, 3, FRAME_H, FRAME_W), dtype=np.uint8)
    messages = [
        {"role": "system", "content": [{"type": "text", "text": SFT_SYSTEM_PROMPT[SFT_TASK]}]},
        {"role": "user", "content": [{"type": "video", "video": "synthetic"},
                                     {"type": "text", "text": SFT_QUESTION}]},
        {"role": "assistant", "content": [{"type": "text", "text": SFT_ANSWER}]},
    ]
    return pack_sft_batch([collate_sft_frames(messages, list(frames), FPS, proc, cfg)], cfg)


def sdpa_fwd_bwd(q, k, v, dout, **kw):
    """One PyTorch call's forward and backward of the same attention, for
    the library time of a backward kernel: (B, S, H, D) layout in."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw).backward(dout.transpose(1, 2))


def training_kernel_phase(dev, cfg, gen, batch, results) -> None:
    """The training kernels against their plain versions at the SFT slice's
    shapes: the exact forwards of K1-K3 (out and lse), K5 (dq; dk, dv) and
    K6 (fused dqkv; window dq; dk, dv). Faults planted in K5's dq and dk/dv
    and in K6's fused and window dk/dv outputs must fail the bound."""
    v, t = cfg.vision, cfg.text
    H, D = v.num_heads, v.head_dim

    def bf16(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)

    for grid_hw in WINDOW_ROW_GRIDS:
        ids, cos, sin, qkv = window_row_inputs(dev, gen, v, grid_hw)
        do = bf16(*qkv.shape[:2], v.hidden_size, scale=DOUT_SCALE)
        do[ids == 0] = 0  # the tower never reads a pad row
        pairs = segment_pairs(ids) * H * D
        rq, rk, rv = wa._rope_qk(qkv, cos, sin, H)
        seg = segment_mask(ids)
        case = f"W = {ids.shape[1]}"
        compare("fused_window_attention_exact",
                lambda: wa.fused_window_attention_exact(qkv, cos, sin, ids, H),
                lambda: wa.fused_window_attention_exact_torch(qkv, cos, sin, ids, H),
                ids != 0, results, flops=4 * pairs,
                moved=nbytes(qkv, cos, sin, ids) + nbytes(do),  # out has dout's shape
                library_fn=lambda: sdpa_masked(rq, rk, rv, seg), case=case)
        ref = compare("fused_window_attention_bwd",
                      lambda: wa.fused_window_attention_bwd(qkv, cos, sin, ids, H, do),
                      lambda: wa.fused_window_attention_bwd_torch(qkv, cos, sin, ids, H, do),
                      None, results, flops=10 * pairs, moved=nbytes(qkv, cos, sin, ids, do, qkv),
                      library_fn=lambda: sdpa_fwd_bwd(rq, rk, rv, do.view(*rq.shape), attn_mask=seg),
                      case=case)
        if grid_hw == WINDOW_ROW_GRIDS[0]:  # fault: the rope transpose left out of dq and dk
            no_rope = torch.stack(wa._window_bwd_f32(rq, rk, rv, ids, do.view(*rq.shape)), dim=2)
            planted("fused_window_attention_bwd", "rope transpose left out",
                    no_rope.reshape(qkv.shape).to(qkv.dtype), ref, None)
            del no_rope
        del qkv, do, rq, rk, rv, seg, ref

    slice_frames = None
    for grid_hw in K2_FRAME_GRIDS:
        frame_ids, q, k, vv, do = case = frame_inputs(dev, gen, v, grid_hw, DOUT_SCALE)
        if slice_frames is None:  # the slice's frames, for K6 below
            slice_frames = case
        fseg = segment_mask(frame_ids)
        valid_rows = (frame_ids != 0)[:, None, :].expand(-1, H, -1)
        compare("window_attention_exact",
                lambda: wa.window_attention_exact(q, k, vv, frame_ids),
                lambda: wa.window_attention_exact_torch(q, k, vv, frame_ids),
                (frame_ids != 0, valid_rows), results,
                flops=4 * segment_pairs(frame_ids) * H * D,
                moved=nbytes(q, k, vv, frame_ids, q) + 4 * q.numel() // D,
                library_fn=lambda: sdpa_masked(q, k, vv, fseg))
        del case, q, k, vv, do, fseg
    frame_ids, q, k, vv, do = slice_frames
    del slice_frames
    fseg = segment_mask(frame_ids)
    fpairs = segment_pairs(frame_ids) * H * D
    out, lse = wa.window_attention_exact(q, k, vv, frame_ids)
    ops = wa.bwd_operands(q, k, vv, frame_ids, out, lse, do)
    ins = nbytes(*ops)
    compare("window_attention_bwd_dq", lambda: wa.window_attention_bwd_dq(ops),
            lambda: wa.window_attention_bwd_torch(q, k, vv, frame_ids, do)[0],
            None, results, flops=6 * fpairs, moved=ins + nbytes(q),
            library_fn=lambda: sdpa_fwd_bwd(q, k, vv, do, attn_mask=fseg))
    ref = compare("window_attention_bwd_dkv", lambda: wa.window_attention_bwd_dkv(ops),
                  lambda: wa.window_attention_bwd_torch(q, k, vv, frame_ids, do)[1:],
                  None, results, flops=8 * fpairs, moved=ins + 2 * nbytes(q),
                  library_fn=lambda: sdpa_fwd_bwd(q, k, vv, do, attn_mask=fseg))
    # fault: frame 0's segment mask ignored (its padded tail seen as keys)
    ignored = frame_ids.clone()
    ignored[0] = 1
    planted("window_attention_bwd_dkv", "frame 0's segment mask ignored",
            wa.window_attention_bwd_torch(q, k, vv, ignored, do)[1:], ref, None)
    del q, k, vv, do, out, lse, ops, ref, ignored

    # the decoder at the packed example's length, right-padded keys
    L = batch["input_ids"].shape[1]
    valid = torch.from_numpy(batch["attn_valid"].astype(np.int32)).to(dev)
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None].contiguous()
    q = bf16(1, L, t.num_attention_heads, t.head_dim)
    k, vv = (bf16(1, L, t.num_key_value_heads, t.head_dim) for _ in range(2))
    do = bf16(1, L, t.num_attention_heads, t.head_dim, scale=DOUT_SCALE)
    cpairs = causal_pairs(pos, valid) * t.num_attention_heads * t.head_dim
    mask = causal_mask(pos, valid)
    rows = valid != 0
    compare("flash_attention_gqa_exact",
            lambda: fa.flash_attention_gqa_exact(q, k, vv, pos, valid),
            lambda: fa.flash_attention_gqa_exact_torch(q, k, vv, pos, valid),
            (rows, rows[:, None, :].expand(-1, t.num_attention_heads, -1)), results,
            flops=4 * cpairs, moved=nbytes(q, k, vv, pos, valid, q) + 4 * q.numel() // t.head_dim,
            library_fn=lambda: sdpa_masked(q, k, vv, mask))
    exact_group8_case(dev, gen, results)
    out, lse = fa.flash_attention_gqa_exact(q, k, vv, pos, valid)
    ops = fa.bwd_operands(q, k, vv, pos, valid, out, lse, do)
    ins = nbytes(*ops)
    lib = lambda: sdpa_fwd_bwd(q, k, vv, do, is_causal=True)  # noqa: E731
    ref = compare("flash_attention_gqa_bwd_dq", lambda: fa.flash_attention_gqa_bwd_dq(ops),
                  lambda: fa.flash_attention_gqa_bwd_torch(q, k, vv, pos, valid, out, lse, do)[0],
                  None, results, flops=6 * cpairs, moved=ins + nbytes(q), library_fn=lib)
    # fault: dq from delta = 0 (out = 0 gives delta = rowsum(dout * out) = 0)
    planted("flash_attention_gqa_bwd_dq", "dq from delta = 0",
            fa.flash_attention_gqa_bwd_torch(q, k, vv, pos, valid, torch.zeros_like(out), lse,
                                             do)[0], ref, None)
    ref = compare("flash_attention_gqa_bwd_dkv", lambda: fa.flash_attention_gqa_bwd_dkv(ops),
                  lambda: fa.flash_attention_gqa_bwd_torch(q, k, vv, pos, valid, out, lse, do)[1:],
                  None, results, flops=8 * cpairs, moved=ins + nbytes(k, vv), library_fn=lib)
    # fault: dk/dv summed over 6 of the 7 heads of each group
    G = t.num_attention_heads // t.num_key_value_heads
    dropped = do.clone()
    dropped[:, :, G - 1::G] = 0
    fault = fa.flash_attention_gqa_bwd_torch(q, k, vv, pos, valid, out, lse, dropped)[1:]
    planted("flash_attention_gqa_bwd_dkv", f"dk/dv over {G - 1} of {G} group heads", fault, ref,
            None)
    del q, k, vv, do, out, lse, ops, dropped, fault
    torch.cuda.empty_cache()


def exact_group8_case(dev, gen, results) -> None:
    """K3's exact mode (out and lse) at a GQA group of 8, Qwen2.5-72B's
    64/8 heads, on 1024 tokens with the last 40 keys right-padded."""
    Hq, Hkv, D, L = 64, 8, 128, 1024
    q = torch.randn((1, L, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((1, L, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None]
    valid = torch.ones((1, L), dtype=torch.int32, device=dev)
    valid[:, L - 40:] = 0
    rows = valid != 0
    mask = causal_mask(pos, valid)
    compare("flash_attention_gqa_exact",
            lambda: fa.flash_attention_gqa_exact(q, k, v, pos, valid),
            lambda: fa.flash_attention_gqa_exact_torch(q, k, v, pos, valid),
            (rows, rows[:, None, :].expand(-1, Hq, -1)), results, case="64/8 heads",
            flops=4 * causal_pairs(pos, valid) * Hq * D,
            moved=nbytes(q, k, v, pos, valid, q) + 4 * q.numel() // D,
            library_fn=lambda: sdpa_masked(q, k, v, mask))
    del q, k, v, mask


def planted(name, fault, out, ref, keep) -> None:
    """A planted fault's output must fail the kernel bound."""
    a = agreement(out, ref, keep)
    log("kernels", name=name, planted_fault=fault, max_abs_err=a["max_abs_err"], bound=a["bound"],
        rel_l2=a["rel_l2"], rejected=not a["ok"])
    if a["ok"]:
        raise RuntimeError(f"{name}: the bound does not reject a planted fault: {fault}")


DEVICE_CLASSES = (("attention kernels (csrc/)", ("o3v",)),
                  ("matmul", ("gemm", "cutlass", "nvjet", "xmma", "sm90_")),
                  ("optimizer", ("adam",)))


def device_breakdown(prof, wall_s: float) -> dict:
    """Device time of a profiled run by kernel class, the busy share of the
    wall time (kernel time summed, so overlap would count twice), and the
    attention kernels' time by kernel function."""
    by_class = {name: 0.0 for name, _ in DEVICE_CLASSES}
    by_class["other"] = 0.0
    attention: dict = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        key = evt.key.lower()
        cls = next((name for name, marks in DEVICE_CLASSES if any(m in key for m in marks)),
                   "other")
        by_class[cls] += ms
        if cls == DEVICE_CLASSES[0][0]:
            fn = re.search(r"(\w+_kernel(?:<[^>]*>)?)", evt.key)
            name = fn.group(1) if fn else evt.key[:48]
            attention[name] = attention.get(name, 0.0) + ms
    busy = sum(by_class.values())
    return {"device_ms": {k: round(x, 3) for k, x in by_class.items()},
            "busy_share": round(busy / (1e3 * wall_s), 4) if wall_s else None,
            "attention_ms": {k: round(x, 3) for k, x in sorted(attention.items())}}


def sft_phase(params, cfg, batch) -> dict:
    """The SFT slice through make_train_step: SFT_STEPS full fine-tune steps
    of Qwen2.5-VL-7B (AdamW at the SFTConfig defaults, remat on). Step 1's
    loss and gradient norm are first computed without the update, under the
    profiler (device time by kernel class), and must come out identical in
    the step. Returns the launch counts of the training kernels over the
    steps; each must be > 0."""
    train_cfg = SFTConfig()
    opt = make_optimizer(train_cfg)
    P.trainable(params)
    state = opt.init(params)
    step = make_train_step(cfg, train_cfg, opt)
    log("sft", tokens=int(batch["attn_valid"].sum()), padded_len=batch["input_ids"].shape[1],
        target_tokens=int((batch["labels"][:, 1:] != -100).sum()),
        patches=batch["pixel_patches"].shape[0], params=P.count(params))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        first = loss_and_grads(params, cfg, train_cfg, batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log("sft", profiled="forward+backward of step 1 without its update", seconds=round(wall, 3),
        **device_breakdown(prof, wall))
    del prof
    for x in P.leaves(params):
        x.grad = None
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    metrics = []
    for i in range(SFT_STEPS):
        t0 = time.perf_counter()
        _, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        m = {k: float(x) for k, x in m.items()}
        metrics.append(m)
        log("sft", step=i + 1, seconds=round(time.perf_counter() - t0, 3), loss=m["loss"],
            grad_norm=m["grad_norm"], num_target_tokens=int(m["num_target_tokens"]))
    launches = {name: kernels.LAUNCHES[name] for name in TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("sft", launches_per_step={k: n / SFT_STEPS for k, n in launches.items()},
        peak_mem_gib=round(peak, 3))
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in metrics):
        raise RuntimeError(f"non-finite loss or gradient norm: {metrics}")
    same = (float(first["loss"]) == metrics[0]["loss"]
            and float(first["grad_norm"]) == metrics[0]["grad_norm"])
    log("sft", step1_repeat_loss=float(first["loss"]), step1_repeat_grad_norm=float(first["grad_norm"]),
        identical=same)
    if not same:
        raise RuntimeError("step 1 repeated from the same params and state gave another result")
    if not all(launches.values()):
        raise RuntimeError(f"a training kernel never launched: {launches}")
    return launches


def _grad_groups(weights) -> dict:
    """The trainable leaves by group: the ViT, the decoder layers (and the
    final norm), the embedding and the lm_head."""
    text = weights["text"]
    return {
        "vit": P.leaves(weights["visual"]),
        "decoder": P.leaves(text["layers"]) + [text["final_norm"]],
        "embed_lm_head": [text["embed_tokens"], text["lm_head"]],
    }


def _loss_and_grad_copies(weights, cfg, batch, impl) -> tuple[float, dict]:
    """Loss and a copy of every gradient, by group; the leaves' grads are
    then cleared for the next path."""
    m = loss_and_grads(weights, cfg, SFTConfig(), batch, attn_impl=impl)
    grads = {g: [x.grad.clone() for x in xs] for g, xs in _grad_groups(weights).items()}
    for x in P.leaves(weights):
        x.grad = None
    return float(m["loss"]), grads


def _agreement_sums(grads, ref, chunk: int = 1 << 26) -> tuple[float, float]:
    """Relative L2 error and cosine of a list of gradients against a
    reference list, summed in float64 over chunks of the flattened leaves
    (the embedding's gradient alone has 545M elements)."""
    diff = ref_sq = dot = own_sq = 0.0
    for a, b in zip(grads, ref):
        a, b = a.reshape(-1), b.reshape(-1)
        for i in range(0, a.numel(), chunk):
            x, y = a[i:i + chunk].double(), b[i:i + chunk].double()
            diff += ((x - y) ** 2).sum().item()
            ref_sq += (y * y).sum().item()
            dot += (x * y).sum().item()
            own_sq += (x * x).sum().item()
    return float(np.sqrt(diff / ref_sq)), dot / float(np.sqrt(ref_sq * own_sq))


def train_numerics_phase(params, cfg, batch) -> None:
    """Training numerics at full width, depth cut to NUMERICS_VIT_DEPTH ViT
    blocks and NUMERICS_TEXT_LAYERS decoder layers: the loss and gradients
    of the kernel path and of the plain bf16 path (impl="torch"), each
    against a float32 plain reference on the same weights. Per group, the
    kernel path may be at most SLICE_REL_RATIO further from float32 than the
    plain path."""
    small_cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, depth=NUMERICS_VIT_DEPTH),
        text=dataclasses.replace(cfg.text, num_hidden_layers=NUMERICS_TEXT_LAYERS))
    small = {"visual": {**params["visual"], "blocks": params["visual"]["blocks"][:NUMERICS_VIT_DEPTH]},
             "text": {**params["text"], "layers": params["text"]["layers"][:NUMERICS_TEXT_LAYERS]}}
    loss_k, grads_k = _loss_and_grad_copies(small, small_cfg, batch, "auto")
    loss_p, grads_p = _loss_and_grad_copies(small, small_cfg, batch, "torch")
    ref = P.trainable(_cast(small, torch.float32))
    cfg32 = dataclasses.replace(small_cfg, dtype=torch.float32)
    m = loss_and_grads(ref, cfg32, SFTConfig(), batch, attn_impl="torch")
    loss_r, grads_r = float(m["loss"]), {g: [x.grad for x in xs] for g, xs in _grad_groups(ref).items()}
    log("train_numerics", vit_blocks=NUMERICS_VIT_DEPTH, decoder_layers=NUMERICS_TEXT_LAYERS,
        loss_kernel=loss_k, loss_plain=loss_p, loss_f32=loss_r)
    for group in grads_r:
        rel_k, cos_k = _agreement_sums(grads_k[group], grads_r[group])
        rel_p, cos_p = _agreement_sums(grads_p[group], grads_r[group])
        log("train_numerics", group=group, kernel_vs_f32_rel=rel_k, kernel_vs_f32_cos=cos_k,
            plain_vs_f32_rel=rel_p, plain_vs_f32_cos=cos_p, max_ratio=SLICE_REL_RATIO)
        if not rel_k <= SLICE_REL_RATIO * rel_p:
            raise RuntimeError(f"{group} gradients: the kernel path is further from float32 than "
                               f"the plain bf16 path ({rel_k} vs {rel_p})")
    del ref, grads_k, grads_p, grads_r
    torch.cuda.empty_cache()


# ---- GSPO ---------------------------------------------------------------------


def gspo_sample(proc, seed: int) -> dict:
    """GSPO_EXAMPLE through rl_sample_from_frames: 16 synthetic 252x336
    frames at 2 fps and one synthetic keyframe, interleaved by its time."""
    rng = np.random.default_rng(seed + 2)
    frames = rng.integers(0, 256, size=(N_FRAMES, 3, FRAME_H, FRAME_W), dtype=np.uint8)
    keyframe = rng.integers(0, 256, size=(3, FRAME_H, FRAME_W), dtype=np.uint8)
    return rl_sample_from_frames(GSPO_EXAMPLE, proc, list(frames), FPS, [keyframe])


class CannedTraces:
    """The trainer's detokenize: row r of a group reads as GSPO_TRACES[r];
    the ByteTokenizer text of each call is kept in ``real``."""

    def __init__(self, proc):
        self.proc, self.calls, self.real = proc, 0, []

    def __call__(self, ids):
        self.real.append(self.proc.decode(ids))
        text = GSPO_TRACES[self.calls % len(GSPO_TRACES)]
        self.calls += 1
        return text


def _sub(tree, vit_depth, text_layers):
    return {"visual": {**tree["visual"], "blocks": tree["visual"]["blocks"][:vit_depth]},
            "text": {**tree["text"], "layers": tree["text"]["layers"][:text_layers]}}


def _cut_cfg(cfg, vit_depth, text_layers):
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, depth=vit_depth),
        text=dataclasses.replace(cfg.text, num_hidden_layers=text_layers))


def gspo_step(trainer, sample, step: int, tag: str, required) -> dict:
    """One GSPOTrainer.step with the launch counts set to 0 just before it:
    stage seconds, completion lengths, loss, kl, rewards, peak GiB and each
    kernel's launches (those of ``required`` must be > 0)."""
    trainer.timer.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m, decode = decode_run(trainer.engine, lambda: trainer.step(sample, global_step=step,
                                                                max_steps=GSPO_MAX_STEPS))
    seconds = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name] for name in TPU_KERNELS}
    last = trainer.last_step
    stages = {k: v["total_s"] for k, v in trainer.timer.report().items()}
    log("gspo", run=tag, step=step + 1, seconds=round(seconds, 3), stage_seconds=stages,
        prompt_tokens=len(sample["input_ids"]), padded_prompt=last["batch"]["prompt_length"],
        completion_lengths=[len(ids) for ids in last["completion_ids"]],
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
        use_vision=last["use_vision"], degraded=last["n_degraded"],
        rollout_decode_ms_per_token=decode["ms_per_token"], decode_capture_ms=decode["capture_ms"],
        decode_steps=decode["steps"], wasted_steps=decode["wasted"])
    log("gspo", run=tag, step=step + 1, loss=m["loss"], kl=m["kl"], reward=m["reward"],
        advantages=last["advantages"].tolist(),
        rewards={k.split("/")[1]: v for k, v in m.items() if k.startswith("rewards/")})
    log("gspo", run=tag, step=step + 1, launches=launches)
    if not (np.isfinite(m["loss"]) and np.isfinite(m["kl"])):
        raise RuntimeError(f"GSPO {tag}: non-finite loss or kl: {m}")
    if last["n_degraded"] or not last["use_vision"]:
        raise RuntimeError(f"GSPO {tag}: the sample degraded or the reference logps fell back "
                           "to text-only")
    if not np.any(last["advantages"]):
        raise RuntimeError(f"GSPO {tag}: every advantage is 0")
    missing = [name for name in required if not launches[name]]
    if missing:
        raise RuntimeError(f"GSPO {tag}: a kernel of the path never launched: {missing}")
    return {"metrics": m, "tokens": [list(t) for t in last["completion_ids"]],
            "rewards": last["rewards_per_func"].copy(), "launches": launches}


def gspo_phase(params, cfg, proc, seed: int) -> tuple[GSPOTrainer, dict, dict]:
    """GSPO under PEFT on the full 7B (frozen; adapters from --seed): step 1,
    a checkpoint, step 2; then the step-1 checkpoint restored and step 2
    again, which must give the same tokens, rewards, loss and kl. The
    adapters' B must move off 0 and every base weight stay bit for bit.
    Returns the trainer, the sample and step 1's launch counts."""
    for x in P.leaves(params):
        x.requires_grad_(False)
    base = [x.to("cpu", copy=True) for x in P.leaves(params)]  # on the host: no device peak
    sample = gspo_sample(proc, seed)
    detok = CannedTraces(proc)
    lora = LoraConfig(seed=seed)
    trainer = GSPOTrainer(params, None, cfg, GSPOConfig(), detokenize=detok, lora=lora,
                          seed=seed)
    log("gspo", mode="PEFT", lora_rank=lora.rank, lora_alpha=lora.alpha,
        targets=list(lora.target_modules), adapter_params=sum(x.numel() for x in
                                                              adapter_leaves(trainer.adapters)),
        base_params=P.count(params), config=dataclasses.asdict(trainer.cfg),
        images=len(sample["grid_thw"]), patches=sample["pixel_patches"].shape[0])
    first = gspo_step(trainer, sample, 0, "peft", GSPO_KERNELS)
    real = detok.real[-len(first["tokens"]):]
    per_func, total = sum_rewards(
        [[{"role": "assistant", "content": t}] for t in real], list(REWARD_REGISTRY.values()),
        **{k: [v] * len(real) for k, v in {**sample["reward_kwargs"], "step_percent": 0.5}.items()})
    log("gspo", real_text_bytes=[len(t) for t in real], real_text_head=[ascii(t[:24]) for t in real],
        real_text_rewards=total.tolist())
    ckpt_dir = GSPO_CKPT_DIR
    state = {"params": trainer.adapters, "opt_state": trainer.opt_state,
             "meta": {"step": 1, "seed": trainer.seed}}
    t0 = time.perf_counter()
    path = CKPT.save_checkpoint(ckpt_dir, 1, state)
    log("gspo", checkpoint=path, save_seconds=round(time.perf_counter() - t0, 3))
    second = gspo_step(trainer, sample, 1, "peft", GSPO_KERNELS)
    restored, step = CKPT.restore_checkpoint(ckpt_dir, 1, target=state)
    trainer.opt_state = restored["opt_state"]
    again = gspo_step(trainer, sample, 1, "peft, step 2 after restoring step 1", GSPO_KERNELS)
    same = {"tokens": again["tokens"] == second["tokens"],
            "rewards": bool(np.array_equal(again["rewards"], second["rewards"])),
            "loss": again["metrics"]["loss"] == second["metrics"]["loss"],
            "kl": again["metrics"]["kl"] == second["metrics"]["kl"]}
    shutil.rmtree(ckpt_dir)
    log("gspo", restored_step=step, identical_step2=same)
    if not all(same.values()):
        raise RuntimeError(f"step 2 after restoring step 1's checkpoint differs: {same}")
    b_max = max(ab["b"].abs().max().item() for layer in trainer.adapters["layers"]
                for ab in layer.values())
    unchanged = all(torch.equal(x.cpu(), y) for x, y in zip(P.leaves(params), base))
    log("gspo", adapters_b_max_abs=b_max, base_bit_for_bit_unchanged=unchanged,
        safetensors_package=_has_safetensors())
    del base
    if not b_max > 0:
        raise RuntimeError("the adapters' B did not move off 0")
    if not unchanged:
        raise RuntimeError("a base weight changed under PEFT")
    return trainer, sample, first["launches"]


def gspo_rollout_pair(trainer, sample) -> None:
    """One rollout as the GSPO step makes it (the trainer's policy, the base
    with its current adapters grafted on; its sampling and seed; G copies of
    the sample), at GSPO_CHECK_TOKENS tokens a row, graphed and eager: the
    tokens must be equal."""
    cfg = trainer.cfg
    req = Request(input_ids=list(sample["input_ids"]), pixel_patches=sample["pixel_patches"],
                  grid_thw=sample["grid_thw"], vision_token_id=sample.get("vision_token_id"))
    reqs = [req] * cfg.num_generations
    sampling = SamplingParams(temperature=cfg.temperature, top_p=cfg.top_p, repetition_penalty=1.0,
                              max_tokens=GSPO_CHECK_TOKENS, seed=trainer.seed)
    policy = trainer.policy_params()
    engine = InferenceEngine(policy, trainer.model_cfg)
    outs, graph = decode_run(engine, lambda: engine.generate(reqs, sampling))
    eager_pair("GSPO rollout", policy, trainer.model_cfg, reqs, sampling, outs, graph)
    del engine, policy
    torch.cuda.empty_cache()


def _has_safetensors() -> bool:
    try:
        import safetensors  # noqa: F401
    except ImportError:
        return False
    return True


def gspo_full_phase(params, cfg, proc, sample, seed: int) -> dict:
    """The full fine-tune branch at full width and FT_VIT_DEPTH ViT blocks /
    FT_TEXT_LAYERS decoder layers: a trained copy of those weights against
    the frozen originals as ``ref_params``, one GSPOTrainer step. Every
    training kernel, K6 among them, must launch."""
    small_cfg = _cut_cfg(cfg, FT_VIT_DEPTH, FT_TEXT_LAYERS)
    ref = _sub(params, FT_VIT_DEPTH, FT_TEXT_LAYERS)
    trained = _clone(ref)
    trainer = GSPOTrainer(trained, ref, small_cfg, GSPOConfig(), detokenize=CannedTraces(proc),
                          seed=seed)
    log("gspo", mode="full fine-tune", vit_blocks=FT_VIT_DEPTH, decoder_layers=FT_TEXT_LAYERS,
        trained_params=sum(x.numel() for x in trainer.trained_leaves()))
    out = gspo_step(trainer, sample, 0, "full fine-tune", FT_KERNELS)
    moved = sum(int(not torch.equal(a, b)) for a, b in zip(P.leaves(trained), P.leaves(ref)))
    log("gspo", run="full fine-tune", leaves_moved=moved, leaves=len(P.leaves(trained)))
    if not moved:
        raise RuntimeError("the full fine-tune step moved no weight")
    del trainer, trained
    gc.collect()
    torch.cuda.empty_cache()
    return out["launches"]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def _gspo_loss_and_grads(params, adapters, scale, cfg, batch, impl, dtype):
    """The GSPO loss, policy logps and adapter gradients of one path: the
    reference logps recomputed by the same path without grad."""
    b = {k: batch[k] for k in ("pixel_patches", "grid_thw", "vision_token_id", "vision_row_index")}
    common = (batch["input_ids"], batch["position_ids"], batch["attn_valid"])
    Lp = batch["prompt_length"]
    with torch.no_grad():
        ref = completion_logps(params, cfg, *common, Lp, **b, logp_chunk=256, attn_impl=impl)
    ad = {"layers": [{n: {k: x.detach().to(dtype).requires_grad_(True) for k, x in ab.items()}
                      for n, ab in layer.items()} for layer in adapters["layers"]]}
    loss, aux = gspo_loss(apply_adapters(params, ad, scale), cfg, GSPOConfig(),
                          *common, batch["completion_mask"], Lp, ref, batch["advantages"], **b,
                          remat=True, logp_chunk=256, attn_impl=impl)
    loss.backward()
    leaves = adapter_leaves(ad)
    grads = {"a": [x.grad for x in leaves[0::2]], "b": [x.grad for x in leaves[1::2]]}
    return float(loss.detach()), aux["policy_logps"].detach().float(), grads


def gspo_numerics_phase(params, cfg, trainer) -> None:
    """GSPO numerics at full width, NUMERICS_VIT_DEPTH ViT blocks and
    NUMERICS_TEXT_LAYERS decoder layers, on the last step's packed batch and
    the trained adapters of those layers: the policy logps and the adapter
    gradients (A and B) of the kernel path and of the plain bf16 path, each
    against float32. The kernel path may be at most SLICE_REL_RATIO further
    from float32 than the plain path."""
    small_cfg = _cut_cfg(cfg, NUMERICS_VIT_DEPTH, NUMERICS_TEXT_LAYERS)
    small = _sub(params, NUMERICS_VIT_DEPTH, NUMERICS_TEXT_LAYERS)
    adapters = {"layers": trainer.adapters["layers"][:NUMERICS_TEXT_LAYERS]}
    batch = trainer.last_step["batch"]
    scale = trainer.lora.scale
    loss_k, logps_k, grads_k = _gspo_loss_and_grads(small, adapters, scale, small_cfg, batch,
                                                    "auto", torch.bfloat16)
    loss_p, logps_p, grads_p = _gspo_loss_and_grads(small, adapters, scale, small_cfg, batch,
                                                    "torch", torch.bfloat16)
    cfg32 = dataclasses.replace(small_cfg, dtype=torch.float32)
    small32 = _cast(small, torch.float32)
    loss_r, logps_r, grads_r = _gspo_loss_and_grads(small32, adapters, scale, cfg32, batch,
                                                    "torch", torch.float32)
    log("gspo_numerics", vit_blocks=NUMERICS_VIT_DEPTH, decoder_layers=NUMERICS_TEXT_LAYERS,
        loss_kernel=loss_k, loss_plain=loss_p, loss_f32=loss_r)
    rel_k, cos_k = _agreement(logps_k, logps_r)
    rel_p, cos_p = _agreement(logps_p, logps_r)
    checks = [("policy logps", rel_k, rel_p)]
    log("gspo_numerics", what="policy logps", kernel_vs_f32_rel=rel_k, kernel_vs_f32_cos=cos_k,
        plain_vs_f32_rel=rel_p, plain_vs_f32_cos=cos_p, max_ratio=SLICE_REL_RATIO)
    for group in grads_r:
        rel_k, cos_k = _agreement_sums(grads_k[group], grads_r[group])
        rel_p, cos_p = _agreement_sums(grads_p[group], grads_r[group])
        checks.append((f"adapter {group} gradients", rel_k, rel_p))
        log("gspo_numerics", what=f"adapter {group} gradients", kernel_vs_f32_rel=rel_k,
            kernel_vs_f32_cos=cos_k, plain_vs_f32_rel=rel_p, plain_vs_f32_cos=cos_p,
            max_ratio=SLICE_REL_RATIO)
    del small32, grads_k, grads_p, grads_r
    torch.cuda.empty_cache()
    for what, rel_k, rel_p in checks:
        if not (np.isfinite(rel_k) and rel_k <= SLICE_REL_RATIO * rel_p):
            raise RuntimeError(f"GSPO {what}: the kernel path is further from float32 than the "
                               f"plain bf16 path ({rel_k} vs {rel_p})")


# ---- the SFT app -------------------------------------------------------------


def media_phase() -> dict:
    """15a: what the machine offers for reading media, decided before
    anything is read: g++ and the libav headers and libraries (with their
    paths), cv2, and the readers the port will use for videos and images."""
    found = video_decoder.probe_libav()
    missing = video_decoder.missing()
    has_cv2 = TV._has_cv2()
    native = not missing
    media = {
        "native": native, "cv2": has_cv2,
        "video_reader": TV.FORCE_VIDEO_READER or ("native" if native else
                                                  "cv2" if has_cv2 else None),
        "image_reader": "cv2" if has_cv2 else "native" if native else None,
    }
    log("media", gpp=found["g++"], headers=found["headers"], libraries=found["libraries"])
    log("media", libav="present" if native else f"absent (missing {missing})", cv2=has_cv2,
        video_reader=media["video_reader"], image_reader=media["image_reader"],
        decoder="builds at first use" if native else "not built: nothing can be installed")
    return media


def sft_app_data(seed: int, media: dict) -> str:
    """15b: the AVI and the PNG keyframe in the reference's layout under
    SFT_APP_DIR, the dataset json beside them; each lossless file read back
    by every reader present must give the written pixels, and fetch_video
    must give SFT_APP_NFRAMES frames at smart_resize's size. Returns the
    data root."""
    rng = np.random.default_rng(seed + 5)
    frames = rng.integers(0, 256, size=(SFT_APP_FRAMES, FRAME_H, FRAME_W, 3), dtype=np.uint8)
    keyframe = rng.integers(0, 256, size=(FRAME_H, FRAME_W, 3), dtype=np.uint8)
    data = f"{SFT_APP_DIR}/data"
    avis = [f"{data}/videos/stgr/plm/videos/clip.avi", f"{data}/videos/videor1/clip.avi"]
    png = f"{data}/videos/stgr/plm/kfs/kf0.png"
    for path in avis + [png]:
        os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    for path in avis:
        write_raw_avi(path, frames, SFT_APP_FPS)
    write_png(png, keyframe)
    log("media", wrote=avis + [png], avi_mb=round(os.path.getsize(avis[0]) / 2**20, 3),
        write_s=round(time.perf_counter() - t0, 3))
    with open(f"{SFT_APP_DIR}/sft.json", "w") as f:
        json.dump(SFT_APP_EXAMPLES, f)
    exact = {}
    if media["native"]:
        t0 = time.perf_counter()
        lib = video_decoder.build()
        log("media", decoder_build_s=round(time.perf_counter() - t0, 3), library=str(lib))
        meta = video_decoder.probe(avis[0])
        t0 = time.perf_counter()
        got = video_decoder.decode_frames(avis[0], np.arange(SFT_APP_FRAMES))
        decode_s = time.perf_counter() - t0
        exact["native avi"] = bool(np.array_equal(got, frames))
        exact["native png"] = bool(np.array_equal(TV._read_image_native(png), keyframe))
        log("media", probe=vars(meta), decode_32_frames_ms=round(1e3 * decode_s, 3))
    if media["cv2"]:
        import cv2

        cap = cv2.VideoCapture(avis[0])
        got = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            got.append(frame[:, :, ::-1])
        cap.release()
        exact["cv2 avi"] = len(got) == SFT_APP_FRAMES and bool(np.array_equal(np.stack(got), frames))
        exact["cv2 png"] = bool(np.array_equal(TV.read_image(png), keyframe))
    t0 = time.perf_counter()
    video, fps = TV.fetch_video({"video": avis[0], "nframes": SFT_APP_NFRAMES})
    fetch_s = time.perf_counter() - t0
    h, w = TV.smart_resize(FRAME_H, FRAME_W, min_pixels=TV.VIDEO_MIN_PIXELS, max_pixels=max(
        min(TV.VIDEO_MAX_PIXELS, TV.VIDEO_TOTAL_PIXELS / SFT_APP_NFRAMES * TV.FRAME_FACTOR),
        int(TV.VIDEO_MIN_PIXELS * 1.05)))
    log("media", exact=exact, reader=TV.get_video_reader_backend(),
        fetch_video_shape=list(video.shape), sample_fps=fps, fetch_video_ms=round(1e3 * fetch_s, 3))
    if not all(exact.values()):
        raise RuntimeError(f"a lossless file did not read back exactly: {exact}")
    if video.shape != (SFT_APP_NFRAMES, 3, h, w) or not np.isfinite(video).all():
        raise RuntimeError(f"fetch_video gave {video.shape}, expected {(SFT_APP_NFRAMES, 3, h, w)}")
    return data


def sft_peft_phase(params, cfg, batch, seed: int, source: str) -> dict:
    """15c: SFT_APP_STEPS PEFT steps of make_lora_train_step on the frozen 7B
    (sft_main's default adapters from --seed; SFTConfig defaults; the last
    step under the profiler: device time by kernel class, busy share), the
    launch counts set to 0 just before and read just after: K1 and K2 in
    their inference modes, K3 exact and K5 launched, K6 not. The adapters'
    B must move off 0 and the base stay bit for bit."""
    for x in P.leaves(params):
        x.requires_grad_(False)
    # A copy of the base on the card (~10 ms, where a host copy and its
    # check take ~16 s); its bytes are resident through the steps, and
    # allocated bytes add, so the steps' peak is the peak less the copy.
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    base = [x.clone() for x in P.leaves(params)]
    torch.cuda.synchronize()
    copy_bytes = torch.cuda.memory_allocated() - held
    copy_s = time.perf_counter() - t0
    lora = LoraConfig(seed=seed)
    train_cfg = SFTConfig()
    adapters = init_adapters(params, lora, dtype=torch.bfloat16)
    opt = make_optimizer(train_cfg)
    state = opt.init(adapter_leaves(adapters))
    step = make_lora_train_step(cfg, train_cfg, opt, lora.scale)
    log("sft_app", mode="PEFT", input=source, lora_rank=lora.rank, lora_alpha=lora.alpha,
        targets=list(lora.target_modules),
        adapter_params=sum(x.numel() for x in adapter_leaves(adapters)),
        tokens=int(batch["attn_valid"].sum()), images=len(batch["grid_thw"]),
        patches=batch["pixel_patches"].shape[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    for i in range(SFT_APP_STEPS):
        last = i == SFT_APP_STEPS - 1  # the last step runs under the profiler
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=activities) if last else contextlib.nullcontext()
        t0 = time.perf_counter()
        with prof:
            _, state, m = step(adapters, state, batch, params)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if last:
            log("sft_app", profiled=f"step {i + 1}", **device_breakdown(prof, wall))
        log("sft_app", step=i + 1, seconds=round(wall, 3),
            loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
            num_target_tokens=int(m["num_target_tokens"]),
            peak_mem_gib=round((torch.cuda.max_memory_allocated() - copy_bytes) / 2**30, 3))
        if not (np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))):
            raise RuntimeError(f"PEFT SFT step {i + 1}: non-finite loss or gradient norm")
    launches = {name: kernels.LAUNCHES[name] for name in TPU_KERNELS}
    log("sft_app", launches_per_step={k: n / SFT_APP_STEPS for k, n in launches.items() if n})
    missing = [name for name in SFT_PEFT_KERNELS if not launches[name]]
    extra = [name for name in SFT_PEFT_ABSENT if launches[name]]
    if missing or extra:
        raise RuntimeError(f"PEFT SFT launches: never launched {missing}, launched {extra}")
    b_max = max(ab["b"].abs().max().item() for layer in adapters["layers"]
                for ab in layer.values())
    t0 = time.perf_counter()
    unchanged = all(torch.equal(x, y) for x, y in zip(P.leaves(params), base))
    log("sft_app", adapters_b_max_abs=b_max, base_bit_for_bit_unchanged=unchanged,
        base_copy_gib=round(copy_bytes / 2**30, 3), base_copy_s=round(copy_s, 3),
        base_check_s=round(time.perf_counter() - t0, 3))
    del base, adapters, state
    gc.collect()
    torch.cuda.empty_cache()
    if not b_max > 0:
        raise RuntimeError("the adapters' B did not move off 0")
    if not unchanged:
        raise RuntimeError("a base weight changed under PEFT")
    return launches


def _sft_main_run(tag: str, args: list[str]) -> dict:
    """One sft_main.main call: its seconds, peak GiB, the metrics lines it
    printed (by step) and the seconds between them."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        sft_main.main(args)
    seconds = time.perf_counter() - t0
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith('{"step"')]
    steps = {x["step"]: x for x in lines}
    times = [x["time"] for x in lines]
    log("sft_main", run=tag, seconds=round(seconds, 3),
        step_seconds=[round(b - a, 3) for a, b in zip(times, times[1:])],
        losses={k: v["loss"] for k, v in steps.items()},
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    return steps


def sft_main_phase(params, cfg, data: str) -> None:
    """15d: sft_main.main end to end on phase 10's cut of the model (full
    width, NUMERICS_VIT_DEPTH ViT blocks, NUMERICS_TEXT_LAYERS decoder
    layers) written as a checkpoint directory (no tokenizer files), --use_peft
    with its default adapters: run A 2 steps with a checkpoint each step, run
    B 1 step, run C resuming B to 2 steps. C's step 2 loss and its merged
    export must equal A's bit for bit."""
    small_cfg = _cut_cfg(cfg, NUMERICS_VIT_DEPTH, NUMERICS_TEXT_LAYERS)
    model = f"{SFT_APP_DIR}/model"
    t0 = time.perf_counter()
    CKPT.export_safetensors(_sub(params, NUMERICS_VIT_DEPTH, NUMERICS_TEXT_LAYERS), small_cfg,
                            model)
    log("sft_main", model=model, vit_blocks=NUMERICS_VIT_DEPTH,
        decoder_layers=NUMERICS_TEXT_LAYERS,
        gib=round(os.path.getsize(f"{model}/model.safetensors") / 2**30, 3),
        write_s=round(time.perf_counter() - t0, 3))
    common = ["--model_name_or_path", model, "--dataset_name", f"{SFT_APP_DIR}/sft.json",
              "--data_root", data, "--nframes", str(SFT_APP_NFRAMES), "--use_peft"]
    a = _sft_main_run("A: 2 steps, a checkpoint each", common + [
        "--output_dir", f"{SFT_APP_DIR}/a", "--max_steps", "2", "--save_steps", "1"])
    _sft_main_run("B: 1 step", common + ["--output_dir", f"{SFT_APP_DIR}/b", "--max_steps", "1"])
    c = _sft_main_run("C: B resumed to 2 steps", common + [
        "--output_dir", f"{SFT_APP_DIR}/b", "--max_steps", "2",
        "--resume_from_checkpoint", f"{SFT_APP_DIR}/b"])
    same = {"step 2 loss": a[2]["loss"] == c[2]["loss"],
            "step 2 grad norm": a[2]["grad_norm"] == c[2]["grad_norm"],
            "merged export": filecmp.cmp(f"{SFT_APP_DIR}/a/model.safetensors",
                                         f"{SFT_APP_DIR}/b/model.safetensors", shallow=False)}
    log("sft_main", resumed_equals_straight=same)
    if not all(same.values()):
        raise RuntimeError(f"sft_main resumed from step 1 differs from 2 steps straight: {same}")


def sft_app_phase(params, cfg, proc, seed: int) -> dict:
    """Phase 15: [media], then (with a reader) the files and their reads,
    the PEFT SFT step on the 7B over collate_sft_batch of the
    temporal-spatial example (else over phase 9's synthetic frames), then
    sft_main end to end (with a reader). Returns the PEFT step's launches."""
    media = media_phase()
    shutil.rmtree(SFT_APP_DIR, ignore_errors=True)
    try:
        if media["video_reader"]:
            data = sft_app_data(seed, media)
            t0 = time.perf_counter()
            example = prepare_sft_example(SFT_APP_EXAMPLES[0], data)
            batch = collate_sft_batch([example], proc, cfg, data, nframes=SFT_APP_NFRAMES)
            source = f"collate_sft_batch: the AVI and the PNG keyframe ({media['video_reader']})"
            log("sft_app", collate_s=round(time.perf_counter() - t0, 3))
        else:
            log("media", skipped="15b and 15d: no reader for video files on this machine")
            batch, source = sft_batch(proc, cfg, seed), "collate_sft_frames: synthetic frames"
        launches = sft_peft_phase(params, cfg, batch, seed, source)
        if media["video_reader"]:
            sft_main_phase(params, cfg, data)
    finally:
        shutil.rmtree(SFT_APP_DIR, ignore_errors=True)
    return launches


# ---- int4 serving ------------------------------------------------------------


def int4pack_yardstick(x, w):
    """torch._weight_int4pack_mm on K7's codes: unsigned codes + 8 in its
    own packing (N, K/2), bf16 scales, zero points 0, so it computes nearly
    K7's function (bf16 scales, its own sums). Returns (call, note): call is
    None where the card's torch lacks it or refuses these operands."""
    if not hasattr(torch, "_weight_int4pack_mm"):
        return None, "torch has no _weight_int4pack_mm"
    t = (i4.unpack(w.w_p) + 8).t().contiguous()  # (N, K) codes 1..15
    packed = ((t[:, ::2] << 4) | t[:, 1::2]).to(torch.uint8)
    del t
    sz = torch.stack([w.scale, torch.zeros_like(w.scale)], dim=-1).to(torch.bfloat16).contiguous()
    try:  # a yardstick only: the port never calls it
        wp = torch._convert_weight_to_int4pack(packed, 8)
        call = lambda: torch._weight_int4pack_mm(x, wp, i4.KERNEL_GROUP, sz)  # noqa: E731
        call()
    except (RuntimeError, TypeError) as e:
        return None, f"refused: {str(e).splitlines()[0][:120]}"
    return call, "ok"


def int4_case(dev, gen, M, K, N) -> tuple:
    """bf16 x (M, K) and a group-128 int4 weight (K, N), outputs std ~0.25."""
    w = i4.quantize_weight_int4(torch.randn(K, N, generator=gen, device=dev) * (INT4_OUT_STD / K ** 0.5))
    return torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16), w


def int4_kernel_phase(dev, gen, prefill_rows, results) -> None:
    """K7 against its plain version at the main paths' shapes (INT4_CASES),
    each by the route its row count takes, with both yardsticks, the same
    bits from two calls, and the planted faults at the first case."""
    for case, M, K, N in INT4_CASES:
        M = M or prefill_rows
        name = i4.kernel_route(M)
        x, w = int4_case(dev, gen, M, K, N)
        wd = i4.dequantize(w, torch.bfloat16)
        ref = compare(name, lambda: i4.int4_matmul(x, w.w_p, w.scale, w.group),
                      lambda: i4.int4_matmul_torch(x, w.w_p, w.scale, w.group), None, results,
                      flops=2 * M * K * N, moved=K * N // 2 + 4 * N * K // 128 + 2 * M * K + 2 * M * N,
                      library_fn=lambda: torch.matmul(x, wd))
        del wd
        same = torch.equal(i4.int4_matmul(x, w.w_p, w.scale, w.group),
                           i4.int4_matmul(x, w.w_p, w.scale, w.group))
        call, note = int4pack_yardstick(x, w)
        pack_ms = statistics.median(time_ms(call)) if call is not None else None
        pack_rel = None if call is None else _agreement(call().float(), ref.float())[0]
        log("kernels", name=name, case=case, M=M, K=K, N=N, groups=K // w.group,
            int4pack_ms=None if pack_ms is None else round(pack_ms, 4), int4pack=note,
            int4pack_vs_plain_rel=pack_rel, same_bits_twice=same)
        if not same:
            raise RuntimeError(f"{name} {case}: two calls gave different bits")
        results[name].setdefault("int4pack_ms", pack_ms)
        if case == INT4_CASES[0][0]:
            p = w.w_p.to(torch.int32)
            swapped = (((p & 0xF) << 4) | ((p >> 4) & 0xF)).to(torch.int8)
            planted("int4_matmul", "nibbles swapped",
                    i4.int4_matmul_torch(x, swapped, w.scale, w.group), ref, None)
            planted("int4_matmul", "scales one group off",
                    i4.int4_matmul_torch(x, w.w_p, torch.roll(w.scale, 1, 0), w.group), ref, None)
        del x, w, ref, call
        torch.cuda.empty_cache()


def probe_phase(dev, gen, results) -> dict:
    """The K7a probes and K7 at the TPU scripts' shape against their plain
    versions, then their own path: each chained over PROBE_CHAIN distinct
    weights as profile_int4_kernel_parts.py chains them (x <- tanh(x +
    1e-3 * y[:, :K])), the counts reset before and read after. Returns the
    probes' launch counts."""
    M, K, N = PROBE_M, PROBE_K, PROBE_N
    x, w = int4_case(dev, gen, M, K, N)
    xr = x.float()
    xs = (INT4_OUT_STD / (w.w_p.float().std().item() * (K / 2) ** 0.5) * xr).to(torch.bfloat16)
    codes = i4.unpack(w.w_p)
    xc = (INT4_OUT_STD / (codes.float().std().item() * K ** 0.5) * xr).to(torch.bfloat16)
    packed_bf16, codes_bf16 = w.w_p.to(torch.bfloat16), codes.to(torch.bfloat16)
    del codes
    compare("int4_matmul_stream", lambda: i4.int4_matmul_stream(xs, w.w_p),
            lambda: i4.int4_matmul_stream_torch(xs, w.w_p), None, results,
            flops=2 * M * (K // 2) * N, moved=K * N // 2 + M * K + 2 * M * N,
            library_fn=lambda: torch.matmul(xs[:, :K // 2], packed_bf16))
    compare("int4_matmul_convert", lambda: i4.int4_matmul_convert(xc, w.w_p),
            lambda: i4.int4_matmul_convert_torch(xc, w.w_p), None, results,
            flops=2 * M * K * N, moved=K * N // 2 + 2 * M * K + 2 * M * N,
            library_fn=lambda: torch.matmul(xc, codes_bf16))
    wd = i4.dequantize(w, torch.bfloat16)
    compare("int4_matmul", lambda: i4.int4_matmul(x, w.w_p, w.scale, w.group),
            lambda: i4.int4_matmul_torch(x, w.w_p, w.scale, w.group), None, results,
            flops=2 * M * K * N, moved=K * N // 2 + 4 * N * K // 128 + 2 * M * K + 2 * M * N,
            library_fn=lambda: torch.matmul(x, wd))
    del packed_bf16, codes_bf16, wd
    ws = [w] + [int4_case(dev, gen, 1, K, N)[1] for _ in range(PROBE_CHAIN - 1)]
    calls = {"int4_matmul_stream": lambda x, w: i4.int4_matmul_stream(x, w.w_p),
             "int4_matmul_convert": lambda x, w: i4.int4_matmul_convert(x, w.w_p),
             "int4_matmul": lambda x, w: i4.int4_matmul(x, w.w_p, w.scale, w.group)}
    torch.cuda.synchronize()
    kernels.reset_launches()
    chained = {}
    for name, call in calls.items():
        h = xs if name == "int4_matmul_stream" else x
        t0 = time.perf_counter()
        for wi in ws:
            h = torch.tanh(h + call(h, wi)[:, :K] * 1e-3)
        torch.cuda.synchronize()
        chained[name] = round(1e3 * (time.perf_counter() - t0) / PROBE_CHAIN, 4)
    launches = {name: kernels.LAUNCHES[name] for name in PROBE_KERNELS}
    log("kernels", probe_chain=PROBE_CHAIN, ms_per_chained_call_host_clock=chained, launches=launches)
    if not all(launches.values()):
        raise RuntimeError(f"a probe never launched: {launches}")
    del ws, x, xs, xc, w
    torch.cuda.empty_cache()
    return launches


def forward_steps(engine) -> int:
    """Forwards of the decoder in the engine's last generate: the prefill
    (one forward below the long-prompt threshold) and each decode step that
    ran, wasted ones included (a replayed step counts its kernels)."""
    return 1 + engine.decode_steps + engine.decode_steps_wasted


def k7_expected(engine, layers: int) -> dict:
    """K7's launches by route in the engine's last generate: the prefill
    forward's 7 * layers decoder matmuls on the wgmma route and its lm_head
    at the last positions (M = batch) on the mma.sync one, then 7 * layers
    + 1 per decode step that ran on the mma.sync route."""
    return {"int4_matmul": 1 + (7 * layers + 1) * (forward_steps(engine) - 1),
            "int4_matmul_wgmma": 7 * layers}


def int4_slice_phase(qparams, cfg, reqs, sampling, bf16_logits) -> dict:
    """The 7B video slice with its decoder in int4 through the same engine.
    Returns the launch counts; K7's must match k7_expected route by route."""
    log("int4", weights_gib=round(quant.param_bytes(qparams) / 2**30, 3), params=P.count(qparams))
    engine = InferenceEngine(qparams, cfg)
    outs, launches, decode = slice_phase(engine, reqs, sampling, INT4_SLICE_KERNELS)
    expected = k7_expected(engine, cfg.text.num_hidden_layers)
    got = {name: launches[name] for name in K7_ROUTES}
    log("int4", first_token_ids=[o["token_ids"][:8] for o in outs], k7_launches=got,
        expected=expected, forwards=forward_steps(engine))
    if got != expected:
        raise RuntimeError(f"K7 launched {got} times by route, expected {expected}: "
                           "a decoder matmul did not take its route")
    eager_pair("int4 slice", qparams, cfg, reqs, sampling, outs, decode)
    del engine
    kernel = _vision_and_logits(qparams, cfg, reqs, "auto")[1]
    plain = _vision_and_logits(qparams, cfg, reqs, "torch")[1]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    ref = _vision_and_logits(_cast(qparams, torch.float32), cfg32, reqs, "torch")[1]
    torch.cuda.empty_cache()
    rel_k, cos_k = _agreement(kernel, ref)
    rel_p, cos_p = _agreement(plain, ref)
    rel_b, cos_b = _agreement(kernel, bf16_logits)
    log("numerics", what="int4 prefill logits", kernel_vs_f32_rel=rel_k, kernel_vs_f32_cos=cos_k,
        plain_vs_f32_rel=rel_p, plain_vs_f32_cos=cos_p, max_ratio=SLICE_REL_RATIO,
        int4_vs_bf16_rel=rel_b, int4_vs_bf16_cos=cos_b)
    if not (torch.isfinite(kernel).all() and rel_k <= SLICE_REL_RATIO * rel_p):
        raise RuntimeError(f"int4 logits: the K7 path is further from float32 than the plain int4 "
                           f"path ({rel_k} vs {rel_p})")
    return launches


def judge_phase(dev, seed) -> dict:
    """Qwen2.5-72B-Instruct in int4 on the card through EngineJudge.batch,
    twice. Returns K7's launch counts by route in the first call."""
    cfg = Qwen25VLConfig.from_hf_dict(QWEN25_72B_INSTRUCT_CONFIG)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = P.init(cfg, seed, dev, quantize_text="int4")
    torch.cuda.synchronize()
    log("judge", model="Qwen2.5-72B-Instruct", layers=cfg.text.num_hidden_layers,
        hidden=cfg.text.hidden_size, params=P.count(params),
        init_s=round(time.perf_counter() - t0, 3),
        weights_gib=round(quant.param_bytes(params) / 2**30, 3),
        init_peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    judge = EngineJudge(params, JUDGE_NEW_TOKENS, cfg=cfg, processor=O3VideoProcessor())
    engine = judge.engine
    engine.generate([judge._request(*JUDGE_JOBS[0])],
                    dataclasses.replace(judge.sampling, max_tokens=2))  # warm-up
    tokens = []  # each judge call's token ids, for the graphed/eager comparison
    generate = engine.generate

    def recorded(*args, **kw):
        outs = generate(*args, **kw)
        tokens.append([o["token_ids"] for o in outs])
        return outs

    engine.generate = recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scores, decode = decode_run(engine, lambda: judge.batch(list(JUDGE_JOBS)))
    e2e = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name] for name in K7_ROUTES}
    k3_launches = kernels.LAUNCHES["flash_attention_gqa"]
    expected = k7_expected(engine, cfg.text.num_hidden_layers)
    st = engine.stage_seconds
    log("judge", jobs=len(JUDGE_JOBS), prompt_tokens=[len(judge._request(*j).input_ids) for j in JUDGE_JOBS],
        prefill_ms=round(1e3 * st["prefill"], 3),
        decode_ms_per_token=decode["ms_per_token"], decode_capture_ms=decode["capture_ms"],
        decode_steps=engine.decode_steps, e2e_s=round(e2e, 3),
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3), scores=scores,
        k7_launches=launches, expected=expected, k3_launches=k3_launches)
    if launches != expected:
        raise RuntimeError(f"K7 launched {launches} times by route in the judge call, "
                           f"expected {expected}")
    engine.decode_graph = False  # the second call decodes eagerly: the reference
    again, eager = decode_run(engine, lambda: judge.batch(list(JUDGE_JOBS)))
    decode_pair("judge", decode, eager, tokens[0], tokens[1])
    log("judge", identical_scores_across_calls=again == scores, scores_again=again)
    if again != scores:
        raise RuntimeError("two judge calls gave different scores")
    del judge, engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    t_start = time.perf_counter()
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
    outs, launches, decode = slice_phase(engine, reqs, sampling)
    log("slice", first_token_ids=[o["token_ids"][:8] for o in outs])

    numerics_phase(params, cfg, reqs)
    eager_pair("video slice", params, cfg, reqs, sampling, outs, decode)
    early_stop_check(params, cfg, reqs[0])

    long_tokens, long_launches, long_decode = long_phase(params, cfg, args.seed)
    long_numerics_phase(params, cfg)
    for name, n, dtype in LONG_RUNS:  # each run again, decoding eagerly
        eager = InferenceEngine(params, cfg, cache_dtype=dtype, long_prefill_chunk=LONG_CHUNK,
                                decode_graph=False)
        again, _, eager_decode = long_run(eager, n, long_sampling(args.seed))
        decode_pair(f"run ({name})", long_decode[name], eager_decode, long_tokens[name], again)
        del eager
        torch.cuda.empty_cache()
    # K4's main path is run (b), the 81920-slot fp8 one
    launches["decode_attention_gqa"] = long_launches["b"]["decode_attention_gqa"]

    # the training slice, after the serving engines and caches are freed
    del engine, outs
    gc.collect()
    torch.cuda.empty_cache()
    batch = sft_batch(proc, cfg, args.seed)
    training_kernel_phase(dev, cfg, gen, batch, results)
    t0 = time.perf_counter()
    launches.update(sft_phase(params, cfg, batch))
    gc.collect()  # the AdamW state
    torch.cuda.empty_cache()
    train_numerics_phase(params, cfg, batch)
    log("sft", phases_seconds=round(time.perf_counter() - t0, 3))

    # GSPO: PEFT on the frozen 7B, its numerics, then the full fine-tune branch
    t0 = time.perf_counter()
    trainer, gsample, gspo_launches = gspo_phase(params, cfg, proc, args.seed)
    gspo_rollout_pair(trainer, gsample)
    gspo_numerics_phase(params, cfg, trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    ft_launches = gspo_full_phase(params, cfg, proc, gsample, args.seed)
    log("gspo", phases_seconds=round(time.perf_counter() - t0, 3),
        launches_per_step={"peft": gspo_launches, "full fine-tune": ft_launches})

    # the SFT app: media, the PEFT SFT step of the 7B, sft_main end to end
    t0 = time.perf_counter()
    sft_app_phase(params, cfg, proc, args.seed)
    log("sft_app", phases_seconds=round(time.perf_counter() - t0, 3))

    # int4 serving: K7 and the probes, the 7B slice in int4, the 72B judge
    t0 = time.perf_counter()
    int4_kernel_phase(dev, gen, len(reqs) * max(rows), results)
    probe_launches = probe_phase(dev, gen, results)
    for name in ("int4_matmul_stream", "int4_matmul_convert"):  # their own path
        launches[name] = probe_launches[name]
    with torch.no_grad():
        bf16_logits = _vision_and_logits(params, cfg, reqs, "auto")[1]
        qparams = i4.quantize_params_int4(params)
    del params  # the bf16 decoder; qparams shares the ViT, embedding, norms, biases
    gc.collect()
    torch.cuda.empty_cache()
    int4_launches = int4_slice_phase(qparams, cfg, reqs, sampling, bf16_logits)
    launches.update({name: int4_launches[name] for name in K7_ROUTES})
    del qparams, bf16_logits
    gc.collect()
    torch.cuda.empty_cache()
    judge_launches = judge_phase(dev, args.seed)
    log("int4", phases_seconds=round(time.perf_counter() - t0, 3), judge_k7_launches=judge_launches)

    log("total", seconds=round(time.perf_counter() - t_start, 3))
    print(card_line(), flush=True)  # again, so that the output's tail holds it
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
