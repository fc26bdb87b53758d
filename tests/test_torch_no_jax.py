"""Import guard, imports, serving and eval: the port runs where neither JAX
nor PIL is installed, nor rouge_score or nltk, and imports none of them.
Each test runs its check in a subprocess of its own under those blocks
(``_torch_no_jax.py``; the training and mesh checks are in
``test_torch_no_jax_train.py``):

- imports every module of the port, then serves tiny generates on the CPU:
  with a bf16 cache, a tiny Qwen3-VL through its deepstack taps, a tiny
  Qwen3-VL-MoE, a tiny Aria from ``Request.vision_embeds``, raw frames with
  ``resize_hw``, w8a8, an fp8 cache through the long-context path, and
  greedy and sampled speculative generates (the latter replaying streams);
- eval: a generate with an int4 decoder (K7's plain version), a judge call,
  V-STAR over a raw AVI through the port's ``QwenVLEngine`` and the judge's
  ``evaluate_json`` on its results, VideoMMMU's ``evaluate`` over its three
  parquet splits (an MCQ, an open-ended item and an MCQ with a PNG query
  image: pandas reads them) under a trace;
- the mixture-of-experts families' training: a full fine-tune SFT step of
  the tiny Qwen3-VL-MoE (the routed experts' backward) and a PEFT GSPO step
  of the tiny Aria over an image (rollouts by ``vision_embeds``, the update
  over ``pixel_values``).

Each ends by checking that nothing of the JAX package was imported."""

from _torch_no_jax import SETUP, run

IMPORTS_AND_SERVING = r"""
import importlib

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
    "open_o3_video_tpu_torch.models",
    "open_o3_video_tpu_torch.models.aria",
    "open_o3_video_tpu_torch.models.aria.config",
    "open_o3_video_tpu_torch.models.aria.vision",
    "open_o3_video_tpu_torch.models.aria.params",
    "open_o3_video_tpu_torch.models.aria.model",
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
    "open_o3_video_tpu_torch.eval.metrics_vstar",
    "open_o3_video_tpu_torch.eval.mcq",
    "open_o3_video_tpu_torch.eval.tts",
    "open_o3_video_tpu_torch.eval.mcq_harness",
    "open_o3_video_tpu_torch.eval.model_engine",
    "open_o3_video_tpu_torch.eval.vstar",
    "open_o3_video_tpu_torch.eval.tvgbench",
    "open_o3_video_tpu_torch.eval.cli",
    "open_o3_video_tpu_torch.eval.dataloaders",
    "open_o3_video_tpu_torch.eval.dataloaders.videomme",
    "open_o3_video_tpu_torch.eval.dataloaders.worldsense",
    "open_o3_video_tpu_torch.eval.dataloaders.videommmu",
    "open_o3_video_tpu_torch.eval.videomme",
    "open_o3_video_tpu_torch.eval.worldsense",
    "open_o3_video_tpu_torch.eval.videommmu",
    "open_o3_video_tpu_torch.utils.xlsx",
    "open_o3_video_tpu_torch.ops.sharded",
    "open_o3_video_tpu_torch.parallel",
    "open_o3_video_tpu_torch.parallel.mesh",
    "open_o3_video_tpu_torch.parallel.distributed",
    "open_o3_video_tpu_torch.parallel.context",
    "open_o3_video_tpu_torch.parallel.pipeline",
    "open_o3_video_tpu_torch.ops.ring_attention",
    "open_o3_video_tpu_torch.eval.visualization",
]
for m in MODULES:
    importlib.import_module(m)
""" + SETUP + r"""
out = InferenceEngine(weights, cfg).generate([req], SamplingParams(max_tokens=4))
assert 1 <= len(out[0]["token_ids"]) <= 4, out
# Qwen3-VL: the same images through a tiny Qwen3-VL tower with deepstack taps
from open_o3_video_tpu_torch.models.qwen25vl.config import tiny_qwen3
q3cfg = tiny_qwen3()
q3 = params.init(q3cfg, 0, torch.device("cpu"))
q3req = Request(x.input_ids, x.pixel_patches, x.grid_thw, q3cfg.image_token_id)
out = InferenceEngine(q3, q3cfg).generate([q3req], SamplingParams(max_tokens=4))
assert 1 <= len(out[0]["token_ids"]) <= 4 and len(q3["visual"]["deepstack"]) == 2, out
# Qwen3-VL-MoE: the same request through the routed experts
from open_o3_video_tpu_torch.models.qwen25vl.config import tiny_qwen3_moe
moecfg = tiny_qwen3_moe()
out = InferenceEngine(params.init(moecfg, 0, torch.device("cpu")), moecfg).generate(
    [q3req], SamplingParams(max_tokens=4))
assert 1 <= len(out[0]["token_ids"]) <= 4, out
# Aria: an image's features through the tower and projector, into the
# engine as Request.vision_embeds
from open_o3_video_tpu_torch.models import aria
acfg = aria.tiny_aria()
aw = aria.params.init(acfg, 0, torch.device("cpu"))
feats = aria.get_image_features(aw, acfg, torch.randn(1, 3, 28, 28))
aids = [5, 6] + [acfg.image_token_id] * feats.shape[0] + [7, 8]
out = InferenceEngine(aw, acfg).generate(
    [Request(aids, vision_embeds=feats, vision_token_id=acfg.image_token_id)],
    SamplingParams(max_tokens=4))
assert 1 <= len(out[0]["token_ids"]) <= 4, out
# the uint8 frame path: raw frames resized on the device to the processor's
# size, then w8a8 (int8 decoder and ViT blocks, a8_prefill) on the same request
raw = np.random.default_rng(3).integers(0, 256, (2, 3, 70, 100), dtype=np.uint8)
framed = Request(x.input_ids, frames=raw, resize_hw=(56, 84), grid_thw=x.grid_thw,
                 vision_token_id=cfg.image_token_id)
out = InferenceEngine(weights, cfg).generate([framed], SamplingParams(max_tokens=4))
assert 1 <= len(out[0]["token_ids"]) <= 4, out
from open_o3_video_tpu_torch.ops import quant
w8a8 = params.init(cfg, 0, torch.device("cpu"), quantize_text=True, quantize_vision=True)
out = InferenceEngine(w8a8, cfg, a8_prefill=True).generate([req], SamplingParams(max_tokens=4))
assert 1 <= len(out[0]["token_ids"]) <= 4 and quant.A8_MATMULS["exact"] > 0, out
# the long-context path at a tiny size: fp8 cache, chunked prefill, and
# decode through K4's route (its plain version on the CPU)
from open_o3_video_tpu_torch.ops import attention
attention.LONG_DECODE_T = 16
engine = InferenceEngine(weights, cfg, cache_dtype=torch.float8_e4m3fn,
                         long_prefill_threshold=8, long_prefill_chunk=5)
out = engine.generate([req], SamplingParams(max_tokens=4))
assert 1 <= len(out[0]["token_ids"]) <= 4 and len(req.input_ids) >= 16, out
attention.LONG_DECODE_T = 32768
# speculative decoding: the greedy path on the vision request, the sampled
# path on two rows replaying period-3 streams
greedy = SamplingParams(temperature=0.0, repetition_penalty=1.0, max_tokens=12)
spec = InferenceEngine(weights, cfg, spec_decode=True, spec_draft=4)
assert spec.generate([req], greedy) == InferenceEngine(weights, cfg).generate([req], greedy)
assert spec.spec_stats["verify_steps"] > 0, spec.spec_stats
spec = InferenceEngine(weights, cfg, spec_sample=True, spec_draft=4, spec_surplus=16)
spec.spec_warmup = 0
streams = np.tile([10, 20, 30], (2, 6))
out = spec.generate([Request([5, 6, 7]), Request([8, 9])], SamplingParams(max_tokens=12),
                    replay_tokens=streams)
assert [o["token_ids"][1:] for o in out] == streams[:, 1:12].tolist(), out
"""

EVAL = SETUP + r"""
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
judge = EngineJudge(qweights, max_new_tokens=2, cfg=qcfg, processor=proc)
assert judge.batch([("What color?", "red", "blue")]) in ([-1], [0], [1], [2], [3])
import json, os, tempfile
from open_o3_video_tpu_torch.data.raw_media import write_raw_avi
rgb = np.random.default_rng(1).integers(0, 256, (4, 28, 56, 3), dtype=np.uint8)
# the eval path: V-STAR over a raw AVI through QwenVLEngine (frames by cv2),
# then the judge's evaluate_json on its results file with the int4 judge
from open_o3_video_tpu_torch.eval import QwenVLEngine, evaluate_json
from open_o3_video_tpu_torch.eval import vstar
with tempfile.TemporaryDirectory() as root:
    write_raw_avi(os.path.join(root, "v.avi"), rgb[:2], 1.0)
    item = {"vid": "v", "video_path": os.path.join(root, "v.avi"), "question": "What rolls?",
            "temporal_question": "When?", "spatial_question": "Where?",
            "spatial_question_2": "Where exactly?", "timestamps": [0.0, 1.0], "frame_count": 2,
            "fps": 1.0, "width": 56, "height": 28, "answer": "a ball",
            "bboxes": [{"timestamp": 0, "xmin": 1, "ymin": 1, "xmax": 9, "ymax": 9}]}
    with open(os.path.join(root, "anno.json"), "w") as f:
        json.dump([item], f)
    model = QwenVLEngine(params.init(cfg, 0, torch.device("cpu")), cfg=cfg, processor=proc,
                         max_tokens=2, video_max_frames=2)
    out = os.path.join(root, "vstar_results.json")
    results = vstar.evaluate(os.path.join(root, "anno.json"), root, model, out)
    assert len(results) == 1 and "answer_spatial_pre_2" in results[0], results
    stats = evaluate_json(out, judge, log=lambda s: None)
    assert "mAM" in stats["overall"] and len(stats["scored_items"]) == 1, stats
# VideoMMMU: the three splits written with pandas, the Adaptation item's PNG
# decoded without PIL, under a trace
import _torch_bench_data as BD
from open_o3_video_tpu_torch.eval import videommmu
from open_o3_video_tpu_torch.utils import start_trace, stop_trace, trace_annotation
with tempfile.TemporaryDirectory() as root:
    BD.write_videommmu(root, np.random.default_rng(2), (2, 28, 56, 3), 1.0, rgb[0, :, :, :])
    start_trace(os.path.join(root, "trace"))
    with trace_annotation("videommmu"):
        acc = videommmu.evaluate(model, root, os.path.join(root, "mmmu.json"), item_batch=2)
    trace = stop_trace()
    with open(os.path.join(root, "mmmu.json")) as f:
        written = json.load(f)
    assert [r["category"] for r in written["results"]] == ["Perception", "Comprehension",
                                                           "Adaptation"], written
    assert written["errors"] == [] and 0 <= acc <= 1 and "videommmu" in open(trace).read()
"""

MOE_TRAINING = r"""
import numpy as np
import torch

from open_o3_video_tpu_torch.data.processor import ByteTokenizer, O3VideoProcessor
from open_o3_video_tpu_torch.data.sft_dataset import collate_sft_frames, pack_sft_batch
from open_o3_video_tpu_torch.models import aria
from open_o3_video_tpu_torch.models.qwen25vl import params
from open_o3_video_tpu_torch.models.qwen25vl.config import tiny_qwen3_moe
from open_o3_video_tpu_torch.train import SFTConfig, make_optimizer, make_train_step
from open_o3_video_tpu_torch.train.gspo import GSPOConfig, GSPOTrainer
from open_o3_video_tpu_torch.train.lora import LoraConfig

cfg = tiny_qwen3_moe()
proc = O3VideoProcessor(tokenizer=ByteTokenizer.for_config(cfg), patch_size=cfg.vision.patch_size)
imgs = list(np.random.default_rng(0).integers(0, 256, (2, 3, 56, 84), dtype=np.uint8))
messages = [
    {"role": "user", "content": [{"type": "video"}, {"type": "text", "text": "Why?"}]},
    {"role": "assistant", "content": [{"type": "text", "text": "<answer>ok</answer>"}]},
]
batch = pack_sft_batch([collate_sft_frames(messages, imgs, 2.0, proc, cfg)], cfg)
weights = params.trainable(params.init(cfg, 0, torch.device("cpu")))
before = weights["text"]["layers"][0]["moe_fc1"].clone()
train_cfg = SFTConfig(learning_rate=1e-3)
opt = make_optimizer(train_cfg)
_, state, m = make_train_step(cfg, train_cfg, opt)(weights, opt.init(weights), batch)
assert state["count"] == 1 and torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0, m
assert not torch.equal(weights["text"]["layers"][0]["moe_fc1"], before)
acfg = aria.tiny_aria()
q = acfg.query_num(acfg.vision.num_patches_per_side ** 2)
trainer = GSPOTrainer(aria.params.init(acfg, 0, torch.device("cpu")), None, acfg,
                      GSPOConfig(max_completion_length=4),
                      detokenize=lambda ids: "<answer>a ball</answer>", lora=LoraConfig(rank=2))
m = trainer.step({"input_ids": [5, 6] + [acfg.image_token_id] * q + [7, 8],
                  "pixel_values": np.zeros((1, 3, 28, 28), np.float32),
                  "reward_kwargs": {"task": "temporal-spatial free-form QA", "answer": "a ball",
                                    "key_frames": [], "key_items": {}}},
                 global_step=0, max_steps=1)
assert np.isfinite(m["loss"]) and trainer.last_step["use_vision"], m
"""


def test_port_imports_and_generates_without_jax_or_pil():
    run(IMPORTS_AND_SERVING)


def test_port_evaluates_without_jax_or_pil():
    run(EVAL)


def test_moe_families_train_without_jax_or_pil():
    run(MOE_TRAINING)
