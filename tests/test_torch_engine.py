"""The port's engine against the JAX package's, same tiny weights, f32, on
the CPU: greedy token ids for two requests at once (4 frames + text, and a
shorter text-only prompt), repetition penalty 1.05, 16 new tokens."""

import numpy as np
import torch

from _torch_parity import frames, model_pair, rng

from open_o3_video_tpu_torch.data.processor import ByteTokenizer, O3VideoProcessor
from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams


def _requests(cfg):
    proc = O3VideoProcessor(tokenizer=ByteTokenizer.for_config(cfg))
    body = "".join(f"Frame {i + 1}: <|vision_start|><|image_pad|><|vision_end|>\n"
                   for i in range(4))
    prompt = f"<|im_start|>user\n{body}Where is the ball?<|im_end|>\n<|im_start|>assistant\n"
    x = proc(prompt, images=list(frames(rng(5), 4, 56, 84)))
    text_only = proc("<|im_start|>user\nDescribe it.<|im_end|>\n<|im_start|>assistant\n")
    return [(x.input_ids, x.pixel_patches, x.grid_thw), (text_only.input_ids, None, None)]


def test_greedy_tokens_match_jax_engine():
    import jax.numpy as jnp

    from open_o3_video_tpu.engine import InferenceEngine as JaxEngine
    from open_o3_video_tpu.engine import Request as JaxRequest
    from open_o3_video_tpu.engine import SamplingParams as JaxSampling

    jcfg, jparams, tcfg, tparams = model_pair(0)
    reqs = _requests(tcfg)
    sampling = dict(temperature=0.0, repetition_penalty=1.05, max_tokens=16)
    # f32 KV caches on both sides: a bf16 cache would round k/v computed in
    # two summation orders, and a near-tie could then flip an argmax.
    ours = InferenceEngine(tparams, tcfg, cache_dtype=torch.float32).generate(
        [Request(i, p, g, tcfg.image_token_id if p is not None else None) for i, p, g in reqs],
        SamplingParams(**sampling),
    )
    theirs = JaxEngine(jparams, jcfg, prompt_buckets=(128,), cache_dtype=jnp.float32).generate(
        [JaxRequest(i, p, g, jcfg.image_token_id if p is not None else None) for i, p, g in reqs],
        JaxSampling(**sampling),
    )
    assert len(reqs[0][0]) != len(reqs[1][0])
    for o, t in zip(ours, theirs):
        assert o["num_prompt_tokens"] == t["num_prompt_tokens"]
        assert o["token_ids"] == [int(x) for x in t["token_ids"]]
        assert 1 <= len(o["token_ids"]) <= 16


def test_unsupported_request_fields_raise():
    _, _, tcfg, tparams = model_pair(0)
    engine = InferenceEngine(tparams, tcfg)
    for field in ("frames", "resize_hw", "vision_embeds", "second_per_grid_ts"):
        try:
            engine.generate([Request([5, 6], **{field: np.zeros(2)})])
        except NotImplementedError:
            continue
        raise AssertionError(f"{field} did not raise")


def test_sampled_generate_is_reproducible():
    _, _, tcfg, tparams = model_pair(0)
    engine = InferenceEngine(tparams, tcfg)
    reqs = [Request(i, p, g, tcfg.image_token_id if p is not None else None)
            for i, p, g in _requests(tcfg)]
    sp = SamplingParams(temperature=0.7, top_p=0.9, repetition_penalty=1.05, max_tokens=6, seed=3)
    assert engine.generate(reqs, sp) == engine.generate(reqs, sp)
    assert engine.decode_steps > 0 and engine.stage_seconds["prefill"] > 0


def test_inference_example_tiny_demo_runs():
    """scripts/inference_example_torch.py --tiny-demo: processor -> engine ->
    text, on the CPU with synthetic frames."""
    import os
    import subprocess
    import sys

    from _torch_parity import REPO_ROOT

    proc = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "scripts", "inference_example_torch.py"),
         "--tiny-demo", "--device", "cpu", "--nframes", "2", "--max_tokens", "3",
         "--questions", "What is shown?"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[tiny-demo on cpu: 3 tokens generated" in proc.stdout
