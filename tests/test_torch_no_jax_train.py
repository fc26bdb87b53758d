"""Import guard, training and the mesh (see ``test_torch_no_jax.py`` for the
imports, serving and eval): each test runs its check in a subprocess of
its own where neither JAX nor PIL is installed, nor rouge_score or nltk
(``_torch_no_jax.py``):

- training: one tiny SFT step of the full fine-tune (and one each of the
  tiny Qwen3-VL, full fine-tune, and Qwen2-VL, PEFT), one tiny PEFT GSPO
  step on a free-form example (its ROUGE reward scored), and the SFT app's
  data path (a raw AVI and a PNG keyframe read by the port's reader,
  ``collate_sft_batch``) with one PEFT SFT step;
- the mesh, on a world-1 gloo group: a tiny generate (tokens equal to the
  mesh-less engine's), a PEFT and a full fine-tune SFT step through the
  mesh's collectives (equal to the mesh-less steps), a ring attention call
  (forward and backward against K3's exact plain version), a pipelined
  forward, and the GIF visualizer over a raw AVI.

Each ends by checking that nothing of the JAX package was imported."""

from _torch_no_jax import SETUP, run

TRAINING = SETUP + r"""
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
# the other families: a full fine-tune step of the tiny Qwen3-VL (its
# deepstack mergers get gradients) and a PEFT step of the tiny Qwen2-VL
from open_o3_video_tpu_torch.models.qwen25vl.config import tiny_qwen2, tiny_qwen3
q3cfg = tiny_qwen3()
from open_o3_video_tpu_torch.train import make_lora_train_step
from open_o3_video_tpu_torch.train import lora as tlora
q3w = params.trainable(params.init(q3cfg, 0, torch.device("cpu")))
q3batch = pack_sft_batch([collate_sft_frames(messages, imgs, 2.0, proc, q3cfg)], q3cfg)
m = make_train_step(q3cfg, train_cfg, opt)(q3w, opt.init(q3w), q3batch)[2]
assert torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0, m
q2cfg = tiny_qwen2()
q2w = params.init(q2cfg, 0, torch.device("cpu"))
ad = tlora.init_adapters(q2w, tlora.LoraConfig(rank=2), dtype=torch.float32)
q2batch = pack_sft_batch([collate_sft_frames(messages, imgs, 2.0, proc, q2cfg)], q2cfg)
m = make_lora_train_step(q2cfg, train_cfg, opt, 2.0)(
    ad, opt.init(tlora.adapter_leaves(ad)), q2batch, q2w)[2]
assert torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0, m
import dataclasses
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
"""

MESH = SETUP + r"""
# a world-1 gloo mesh: the engine on it gives the mesh-less engine's tokens
import os
import tempfile
import torch.distributed as dist
from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.parallel import distributed, make_mesh
with tempfile.TemporaryDirectory() as root:
    assert not distributed.initialize("file://" + os.path.join(root, "store"), 1, 0, device="cpu")
    mesh = make_mesh()
    qcfg = params.Qwen25VLConfig.tiny()
    qw = params.init(qcfg, 0, torch.device("cpu"))
    reqs = [Request(input_ids=list(range(40, 52)))]
    greedy = SamplingParams(temperature=0.0, max_tokens=4)
    on_mesh = InferenceEngine(qw, qcfg, mesh=mesh, prompt_buckets=(64,)).generate(reqs, greedy)
    plain = InferenceEngine(qw, qcfg, prompt_buckets=(64,)).generate(reqs, greedy)
    assert on_mesh[0]["token_ids"] == plain[0]["token_ids"] and mesh.collectives["all_reduce"]
    # SFT steps through the mesh's collectives: PEFT, then the full fine-tune
    from open_o3_video_tpu_torch.data.sft_dataset import collate_sft_frames, pack_sft_batch
    from open_o3_video_tpu_torch.parallel import shard_params
    from open_o3_video_tpu_torch.train import (SFTConfig, make_lora_train_step, make_optimizer,
                                               make_train_step)
    from open_o3_video_tpu_torch.train.lora import LoraConfig, adapter_leaves, init_adapters
    messages = [
        {"role": "user", "content": [{"type": "video"}, {"type": "text", "text": "Why?"}]},
        {"role": "assistant", "content": [{"type": "text", "text": "<answer>ok</answer>"}]},
    ]
    batch = pack_sft_batch([collate_sft_frames(messages, imgs, 2.0, proc, cfg)], cfg)
    tc = SFTConfig(learning_rate=1e-3)
    opt = make_optimizer(tc)
    runs = []
    for on in (None, mesh):
        base = params.init(cfg, 0, torch.device("cpu"))
        ad = init_adapters(base, LoraConfig(rank=2), dtype=torch.float32)
        if on is not None:
            base = shard_params(base, on, cfg)
        m = make_lora_train_step(cfg, tc, opt, 2.0, mesh=on)(
            ad, opt.init(adapter_leaves(ad)), batch, base)[2]
        full = params.init(cfg, 0, torch.device("cpu"))
        full = params.trainable(full if on is None else shard_params(full, on, cfg))
        f = make_train_step(cfg, tc, opt, mesh=on)(full, opt.init(full), batch)[2]
        runs.append((float(m["loss"]), float(m["grad_norm"]), adapter_leaves(ad),
                     float(f["loss"]), float(f["grad_norm"])))
    (l0, n0, a0, fl0, fn0), (l1, n1, a1, fl1, fn1) = runs
    assert (l0, n0, fl0, fn0) == (l1, n1, fl1, fn1) and n0 > 0, runs
    assert all(torch.equal(p, q) for p, q in zip(a0, a1))
    # ring attention on a ring of one, forward and backward, against K3's
    # exact plain version over the whole sequence
    from open_o3_video_tpu_torch.ops import flash_attention as FA
    from open_o3_video_tpu_torch.ops.ring_attention import ring_attention
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 12, h, 8, generator=g).requires_grad_() for h in (4, 2, 2))
    pos = torch.arange(12)[None]
    valid = torch.ones(1, 12, dtype=torch.bool)
    ring = ring_attention(q, k, v, pos, pos, valid, dist.group.WORLD)
    grads = torch.autograd.grad(ring.sum(), (q, k, v))
    ref = FA.flash_attention_gqa_exact_torch(q, k, v, pos, valid)[0]
    want = torch.autograd.grad(ref.sum(), (q, k, v))
    assert torch.allclose(ring, ref, atol=1e-6)
    assert all(torch.allclose(a, b, atol=1e-5) for a, b in zip(grads, want))
    # a pipelined train step on a pipe of one stage, against the sequential one
    from open_o3_video_tpu_torch.parallel.pipeline import dryrun_pipeline_step
    res = dryrun_pipeline_step(1, 2, check_sequential=True)
    assert res["loss"] == res["sequential_loss"] and res["grad_err"] < 1e-6, res
    dist.destroy_process_group()
    # the GIF visualizer over a raw AVI
    from open_o3_video_tpu_torch.data.raw_media import write_raw_avi
    from open_o3_video_tpu_torch.eval.visualization import VideoQAGIFGenerator
    video = os.path.join(root, "v.avi")
    write_raw_avi(video, np.zeros((4, 32, 48, 3), np.uint8), fps=2.0)
    gif = VideoQAGIFGenerator(panel_width=96).create_demo_gif(
        video, "Where?", "<think><obj>x</obj><box>[1, 2, 20, 20]</box>at<t>1</t>s</think>"
        "<answer>here</answer>", os.path.join(root, "a.gif"))
    assert open(gif, "rb").read(6) == b"GIF89a"
"""


def test_port_trains_without_jax_or_pil():
    run(TRAINING)


def test_mesh_runs_without_jax_or_pil():
    run(MESH)
