"""Import guard: the port runs where neither JAX nor PIL is installed (the
GPU machine has neither, nor rouge_score or nltk). A subprocess blocks those
imports, imports every module of the port, runs a tiny generate on the CPU
(with a bf16 cache, and with an fp8 cache through the long-context path),
one tiny SFT train step, a generate with an int4 decoder (K7's plain
version), a judge call, one tiny PEFT GSPO step on a free-form example (its
ROUGE reward scored), and the SFT app's data path (a raw AVI and a PNG
keyframe read by the port's reader, ``collate_sft_batch``) with one PEFT SFT
step, and checks that nothing of the JAX package was imported along the
way."""

import os
import subprocess
import sys

from _torch_parity import REPO_ROOT

SCRIPT = r"""
import sys
sys.modules["jax"] = None   # any `import jax` now raises ImportError
sys.modules["PIL"] = None
sys.modules["rouge_score"] = None
sys.modules["nltk"] = None
import importlib
import numpy as np
import torch

MODULES = [
    "open_o3_video_tpu_torch",
    "open_o3_video_tpu_torch.ops.kernels",
    "open_o3_video_tpu_torch.ops.preprocess",
    "open_o3_video_tpu_torch.ops.rope",
    "open_o3_video_tpu_torch.ops.sampling",
    "open_o3_video_tpu_torch.ops.window_attention",
    "open_o3_video_tpu_torch.ops.flash_attention",
    "open_o3_video_tpu_torch.ops.decode_attention",
    "open_o3_video_tpu_torch.ops.attention",
    "open_o3_video_tpu_torch.data.processor",
    "open_o3_video_tpu_torch.models.qwen25vl",
    "open_o3_video_tpu_torch.models.qwen25vl.config",
    "open_o3_video_tpu_torch.models.qwen25vl.vision",
    "open_o3_video_tpu_torch.models.qwen25vl.text",
    "open_o3_video_tpu_torch.models.qwen25vl.model",
    "open_o3_video_tpu_torch.models.qwen25vl.params",
    "open_o3_video_tpu_torch.engine",
    "open_o3_video_tpu_torch.grounding.prompts",
    "open_o3_video_tpu_torch.data.sft_dataset",
    "open_o3_video_tpu_torch.train",
    "open_o3_video_tpu_torch.train.sft",
    "open_o3_video_tpu_torch.ops.int4",
    "open_o3_video_tpu_torch.ops.quant",
    "open_o3_video_tpu_torch.ops.resize",
    "open_o3_video_tpu_torch.data.video",
    "open_o3_video_tpu_torch.eval",
    "open_o3_video_tpu_torch.eval.judge",
    "open_o3_video_tpu_torch.utils",
    "open_o3_video_tpu_torch.utils.metrics",
    "open_o3_video_tpu_torch.utils.profiling",
    "open_o3_video_tpu_torch.grounding.iou",
    "open_o3_video_tpu_torch.grounding.coords",
    "open_o3_video_tpu_torch.grounding.tags",
    "open_o3_video_tpu_torch.grounding.rouge",
    "open_o3_video_tpu_torch.grounding.rewards",
    "open_o3_video_tpu_torch.data.media_roots",
    "open_o3_video_tpu_torch.data.rl_dataset",
    "open_o3_video_tpu_torch.train.lora",
    "open_o3_video_tpu_torch.train.gspo",
    "open_o3_video_tpu_torch.train.checkpoint",
    "open_o3_video_tpu_torch.train.grpo_main",
    "open_o3_video_tpu_torch.train.launch",
    "open_o3_video_tpu_torch.train.sft_main",
    "open_o3_video_tpu_torch.native",
    "open_o3_video_tpu_torch.native.video_decoder",
    "open_o3_video_tpu_torch.data.raw_media",
]
for m in MODULES:
    importlib.import_module(m)

from open_o3_video_tpu_torch.data.processor import ByteTokenizer, O3VideoProcessor
from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.models.qwen25vl import Qwen25VLConfig, params

cfg = Qwen25VLConfig.tiny()
proc = O3VideoProcessor(tokenizer=ByteTokenizer.for_config(cfg))
imgs = list(np.random.default_rng(0).integers(0, 256, (2, 3, 56, 84), dtype=np.uint8))
x = proc("<|vision_start|><|image_pad|><|vision_end|>" * 2 + "Why?", images=imgs)
weights = params.init(cfg, 0, torch.device("cpu"))
req = Request(x.input_ids, x.pixel_patches, x.grid_thw, cfg.image_token_id)
out = InferenceEngine(weights, cfg).generate([req], SamplingParams(max_tokens=4))
assert 1 <= len(out[0]["token_ids"]) <= 4, out
# the long-context path at a tiny size: fp8 cache, chunked prefill, and
# decode through K4's route (its plain version on the CPU)
from open_o3_video_tpu_torch.ops import attention
attention.LONG_DECODE_T = 16
engine = InferenceEngine(weights, cfg, cache_dtype=torch.float8_e4m3fn,
                         long_prefill_threshold=8, long_prefill_chunk=5)
out = engine.generate([req], SamplingParams(max_tokens=4))
assert 1 <= len(out[0]["token_ids"]) <= 4 and len(req.input_ids) >= 16, out
# one SFT step of the full fine-tune: vision and decoder backward, AdamW
from open_o3_video_tpu_torch.data.sft_dataset import collate_sft_frames, pack_sft_batch
from open_o3_video_tpu_torch.train import SFTConfig, make_optimizer, make_train_step
messages = [
    {"role": "user", "content": [{"type": "video"}, {"type": "text", "text": "Why?"}]},
    {"role": "assistant", "content": [{"type": "text", "text": "<answer>ok</answer>"}]},
]
batch = pack_sft_batch([collate_sft_frames(messages, imgs, 2.0, proc, cfg)], cfg)
weights = params.trainable(weights)
train_cfg = SFTConfig(learning_rate=1e-3)
opt = make_optimizer(train_cfg)
_, state, m = make_train_step(cfg, train_cfg, opt)(weights, opt.init(weights), batch)
assert state["count"] == 1 and float(m["num_target_tokens"]) > 0, m
assert torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0, m
# int4 serving: a decoder of K7's shapes (hidden 256, heads of 128) drawn
# into int4, a text-only generate, and the judge on the same weights
import dataclasses
from open_o3_video_tpu_torch.eval import EngineJudge
from open_o3_video_tpu_torch.ops.int4 import Int4Linear
qcfg = dataclasses.replace(cfg, text=dataclasses.replace(
    cfg.text, hidden_size=256, num_attention_heads=2, num_key_value_heads=1,
    intermediate_size=384, mrope_section=(16, 24, 24)))
qweights = params.init(qcfg, 0, torch.device("cpu"), quantize_text="int4")
assert isinstance(qweights["text"]["layers"][0]["down_w"], Int4Linear)
out = InferenceEngine(qweights, qcfg).generate([Request(proc("Why?").input_ids)],
                                               SamplingParams(max_tokens=3))
assert 1 <= len(out[0]["token_ids"]) <= 3, out
judge = EngineJudge(qweights, 2, cfg=qcfg, processor=proc)
assert judge.batch([("What color?", "red", "blue")]) in ([-1], [0], [1], [2], [3])
# one PEFT GSPO step: a free-form example through rl_sample_from_frames, the
# seven rewards (ROUGE among them) on canned traces, the update
from open_o3_video_tpu_torch.data.rl_dataset import rl_sample_from_frames
from open_o3_video_tpu_torch.train.gspo import GSPOConfig, GSPOTrainer
from open_o3_video_tpu_torch.train.lora import LoraConfig
gcfg = dataclasses.replace(cfg, vision_start_token_id=300, vision_end_token_id=301,
                           image_token_id=303, video_token_id=304)
gproc = O3VideoProcessor(tokenizer=ByteTokenizer.for_config(gcfg))
example = {"task": "temporal-spatial free-form QA", "question": "What rolls?",
           "answer": "the red ball rolls", "key_frames": [{"time": 0.0, "idx": 0}],
           "key_items": {"0": {"ball": [[0.1, 0.1, 0.5, 0.5]]}}}
sample = rl_sample_from_frames(example, gproc, imgs, 2.0, [imgs[0]])
traces = iter(["<think>a <obj>ball</obj><box>[5,5,40,30]</box>at<t>0.0</t>s</think>"
               "<answer>the red balls rolled</answer>", "<answer>a cup</answer>", "x", "y"])
trainer = GSPOTrainer(params.init(gcfg, 0, torch.device("cpu")), None, gcfg,
                      GSPOConfig(max_completion_length=4), detokenize=lambda ids: next(traces),
                      lora=LoraConfig(rank=2))
m = trainer.step(sample, global_step=0, max_steps=1)
assert trainer.last_step["use_vision"] and 0 < m["rewards/ans_acc_reward"] < 1, m
# the SFT app's data path: a temporal-spatial example over a raw AVI and a PNG
# keyframe written without an encoder, read by the port's reader, collated
# and packed, then one PEFT SFT step
import json, os, tempfile
from open_o3_video_tpu_torch.data.raw_media import write_png, write_raw_avi
from open_o3_video_tpu_torch.data.sft_dataset import (collate_sft_batch, load_sft_dataset,
                                                      prepare_sft_example)
from open_o3_video_tpu_torch.train import make_lora_train_step
from open_o3_video_tpu_torch.train.lora import adapter_leaves, init_adapters
with tempfile.TemporaryDirectory() as root:
    for sub in ("videos/stgr/plm/videos", "videos/stgr/plm/kfs"):
        os.makedirs(os.path.join(root, sub))
    rgb = np.random.default_rng(1).integers(0, 256, (4, 28, 56, 3), dtype=np.uint8)
    write_raw_avi(os.path.join(root, "videos/stgr/plm/videos/clip.avi"), rgb, 2.0)
    write_png(os.path.join(root, "videos/stgr/plm/kfs/kf.png"), rgb[1])
    with open(os.path.join(root, "sft.json"), "w") as f:
        json.dump([{"task": "temporal-spatial free-form QA", "source": "STR_plm_rdcap",
                    "video_path": "clip.avi", "question": "What rolls?",
                    "reasoning_process": "a <obj>ball</obj><box>[0.1,0.2,0.5,0.8]</box>",
                    "answer": "a ball", "key_frames": [{"time": 0.5, "idx": 0, "path": "kf.png"}]}],
                  f)
    prepared = [prepare_sft_example(ex, root) for ex in load_sft_dataset(os.path.join(root, "sft.json"))]
    sft_batch = collate_sft_batch(prepared, proc, cfg, root, nframes=2)
assert len(sft_batch["grid_thw"]) == 3, sft_batch["grid_thw"]  # 2 frames and the keyframe
base = params.init(cfg, 0, torch.device("cpu"))
adapters = init_adapters(base, LoraConfig(rank=2), dtype=torch.float32)
opt = make_optimizer(SFTConfig(learning_rate=1e-3))
state = opt.init(adapter_leaves(adapters))
_, state, m = make_lora_train_step(cfg, SFTConfig(), opt, 2.0)(adapters, state, sft_batch, base)
assert state["count"] == 1 and torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0, m
assert sys.modules["jax"] is None and sys.modules["PIL"] is None
assert sys.modules["rouge_score"] is None and sys.modules["nltk"] is None
assert not [m for m in sys.modules if m.split(".")[0] == "open_o3_video_tpu"]
print("NO_JAX_OK")
"""


def test_port_imports_and_generates_without_jax_or_pil():
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO_ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
