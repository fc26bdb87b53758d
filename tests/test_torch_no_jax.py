"""Import guard: the port runs where neither JAX nor PIL is installed (the
GPU machine has neither). A subprocess blocks both imports, imports every
module of the port, runs a tiny generate on the CPU (with a bf16 cache, and
with an fp8 cache through the long-context path) and one tiny SFT train
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
assert sys.modules["jax"] is None and sys.modules["PIL"] is None
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
