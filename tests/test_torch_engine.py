"""The port's engine against the JAX package's, same tiny weights, on the
CPU: greedy token ids for two requests at once (4 frames + text, and a
shorter text-only prompt), repetition penalty 1.05, 16 new tokens, f32; and
the long-context path (chunked prefill, decode through K4's route) with an
f32 and an fp8 cache."""

import numpy as np
import pytest
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


# fp8 cache: both engines store the same e4m3 bytes unless a k/v value sits
# on a rounding boundary, where the two packages' f32 sums can round it
# apart by one e4m3 step (1/16 relative); one such element moves logits of
# this tiny model by well under 1e-3. f32 cache: the whole-model bound.
LONGCTX_ATOL = {"float32": 1e-4, "float8_e4m3fn": 1e-3}


@pytest.mark.parametrize("cache", ["float32", "float8_e4m3fn"])
def test_long_context_path_matches_jax_engine(monkeypatch, cache):
    """A 60-token prompt with long_prefill_threshold 32 and chunk 16: the port
    prefills 16+16+16+12 tokens (a ragged last chunk), the JAX engine its
    64-token bucket in 4 chunks; with LONG_DECODE_T patched to 64 on both
    sides every decode step takes the long-decode route (K4's plain version
    here, JAX's exact chunked path). Greedy tokens are equal; the first-step
    logits and every emitted token's log-probability agree within
    LONGCTX_ATOL."""
    import jax.numpy as jnp

    from open_o3_video_tpu.engine import InferenceEngine as JaxEngine
    from open_o3_video_tpu.engine import Request as JaxRequest
    from open_o3_video_tpu.engine import SamplingParams as JaxSampling
    from open_o3_video_tpu.ops import attention as jattn
    from open_o3_video_tpu_torch.engine import engine as tengine
    from open_o3_video_tpu_torch.ops import attention as tattn
    from open_o3_video_tpu_torch.ops import decode_attention as tdec

    jcfg, jparams, tcfg, tparams = model_pair(0)
    monkeypatch.setattr(jattn, "LONG_DECODE_T", 64)
    monkeypatch.setattr(tattn, "LONG_DECODE_T", 64)
    k4_calls, chunks, logits = [], [], []
    real_forward, real_sample = tengine.text_forward, tengine.sample_token

    def decode_spy(q, k, *args, **kw):
        k4_calls.append(k.dtype)
        return tdec.decode_attention_gqa(q, k, *args, **kw)

    def forward_spy(params, cfg, embeds, *args, **kw):
        chunks.append(embeds.shape[1])
        return real_forward(params, cfg, embeds, *args, **kw)

    def sample_spy(gen, lg, **kw):
        logits.append(lg.clone())
        return real_sample(gen, lg, **kw)

    monkeypatch.setattr(tattn, "decode_attention_gqa", decode_spy)
    monkeypatch.setattr(tengine, "text_forward", forward_spy)
    monkeypatch.setattr(tengine, "sample_token", sample_spy)

    prompt = rng(21).integers(5, 400, size=60).tolist()
    sampling = dict(temperature=0.0, repetition_penalty=1.05, max_tokens=8)
    ours = InferenceEngine(tparams, tcfg, cache_dtype=getattr(torch, cache),
                           long_prefill_threshold=32, long_prefill_chunk=16).generate(
        [Request(prompt)], SamplingParams(**sampling))[0]
    jax_engine = JaxEngine(jparams, jcfg, prompt_buckets=(64,), cache_dtype=getattr(jnp, cache),
                           max_slots=1, long_prefill_threshold=32, long_prefill_chunk=16)
    first_sample, jax_first = jax_engine._first_sample, []

    def jax_first_spy(key, lg, *args, **kw):
        jax_first.append(np.asarray(lg))
        return first_sample(key, lg, *args, **kw)

    jax_engine._first_sample = jax_first_spy
    theirs = jax_engine.generate([JaxRequest(prompt)], JaxSampling(**sampling),
                                 return_logprobs=True)[0]

    assert chunks[:4] == [16, 16, 16, 12]
    decode_steps = len(ours["token_ids"]) - 1
    assert decode_steps > 0 and k4_calls == [getattr(torch, cache)] * (2 * decode_steps)
    assert ours["token_ids"] == [int(t) for t in theirs["token_ids"]]
    atol = LONGCTX_ATOL[cache]
    np.testing.assert_allclose(logits[0].numpy(), jax_first[0], atol=atol)
    ours_lp = [float(torch.log_softmax(lg, -1)[0, t]) for lg, t in zip(logits, ours["token_ids"])]
    np.testing.assert_allclose(ours_lp, theirs["logprobs"], atol=atol)


def test_prompt_over_the_context_limit_raises():
    _, _, tcfg, tparams = model_pair(0)
    engine = InferenceEngine(tparams, tcfg)
    with pytest.raises(ValueError, match="81920"):
        engine.generate([Request([5] * 81921)], SamplingParams(max_tokens=1))


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


@pytest.mark.parametrize("kv_cache", ["bf16", "fp8"])
def test_inference_example_tiny_demo_runs(kv_cache):
    """scripts/inference_example_torch.py --tiny-demo: processor -> engine ->
    text, on the CPU with synthetic frames, with either KV cache dtype."""
    import os
    import subprocess
    import sys

    from _torch_parity import REPO_ROOT

    proc = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "scripts", "inference_example_torch.py"),
         "--tiny-demo", "--device", "cpu", "--nframes", "2", "--max_tokens", "3",
         "--questions", "What is shown?", "--kv_cache", kv_cache],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[tiny-demo on cpu: 3 tokens generated" in proc.stdout


def test_inference_example_refuses_the_cpu_unless_asked():
    """Without --device the script runs on the card; where there is none it
    exits with an error instead of falling back to the CPU."""
    import os
    import subprocess
    import sys

    from _torch_parity import REPO_ROOT

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "scripts", "inference_example_torch.py"),
         "--tiny-demo", "--nframes", "2", "--max_tokens", "3"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "--device cpu" in proc.stderr
    assert "tokens generated" not in proc.stdout
