"""The port's engine against the JAX package's, same tiny weights, on the
CPU: greedy token ids and log-probabilities for two requests at once (4
frames + text, and a shorter text-only prompt), repetition penalty 1.05, 16
new tokens, f32, at several budgets and with an EOS inside the decode
run; the decode step's cache write at a column on the device;
and the long-context path (chunked prefill, decode through K4's route) with
an f32 and an fp8 cache. On the card: the graphed decode against the eager
one."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_MODEL, cuda_device, frames, model_pair, normal, rng

from open_o3_video_tpu_torch.data.processor import ByteTokenizer, O3VideoProcessor
from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.engine.engine import DONE_LAG
from open_o3_video_tpu_torch.models.qwen25vl import Qwen25VLConfig
from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.models.qwen25vl.text import write_cache, write_cache_at


def _requests(cfg):
    proc = O3VideoProcessor(tokenizer=ByteTokenizer.for_config(cfg))
    body = "".join(f"Frame {i + 1}: <|vision_start|><|image_pad|><|vision_end|>\n"
                   for i in range(4))
    prompt = f"<|im_start|>user\n{body}Where is the ball?<|im_end|>\n<|im_start|>assistant\n"
    x = proc(prompt, images=list(frames(rng(5), 4, 56, 84)))
    text_only = proc("<|im_start|>user\nDescribe it.<|im_end|>\n<|im_start|>assistant\n")
    return [(x.input_ids, x.pixel_patches, x.grid_thw), (text_only.input_ids, None, None)]


def _port_requests(cfg):
    return [Request(i, p, g, cfg.image_token_id if p is not None else None)
            for i, p, g in _requests(cfg)]


# Greedy, with the reference's penalty. f32 KV caches on both sides: a bf16
# cache would round k/v computed in two summation orders, and a near-tie
# could then flip an argmax.
GREEDY = dict(temperature=0.0, repetition_penalty=1.05, max_tokens=16)


@functools.cache
def _jax_greedy(eos=None, n_requests=2):
    """The JAX engine's greedy outputs (with logprobs) for the first
    ``n_requests`` of ``_requests``, its tiny config's EOS id replaced by
    ``eos`` if given."""
    import jax.numpy as jnp

    from open_o3_video_tpu.engine import InferenceEngine as JaxEngine
    from open_o3_video_tpu.engine import Request as JaxRequest
    from open_o3_video_tpu.engine import SamplingParams as JaxSampling

    jcfg, jparams, _, _ = model_pair(0)
    reqs = _requests(jcfg)[:n_requests]  # tokenized with the config's own special ids
    if eos is not None:
        jcfg = dataclasses.replace(jcfg, eos_token_id=eos)
    return JaxEngine(jparams, jcfg, prompt_buckets=(128,), cache_dtype=jnp.float32).generate(
        [JaxRequest(i, p, g, jcfg.image_token_id if p is not None else None) for i, p, g in reqs],
        JaxSampling(**GREEDY), return_logprobs=True,
    )


def _assert_same_as_jax(ours, theirs):
    for o, t in zip(ours, theirs):
        assert o["num_prompt_tokens"] == t["num_prompt_tokens"]
        assert o["token_ids"] == [int(x) for x in t["token_ids"]]
        np.testing.assert_allclose(o["logprobs"], t["logprobs"], atol=ATOL_MODEL)


@pytest.mark.parametrize("max_tokens", [1, 2, 16])
def test_greedy_tokens_match_jax_engine(max_tokens):
    """Two requests of different lengths, a budget of 1 (no decode step),
    2 (one) and 16 new tokens: the tokens and their log-probabilities equal
    the first ``max_tokens`` of the JAX engine's 16, and no step is
    wasted."""
    _, _, tcfg, tparams = model_pair(0)
    engine = InferenceEngine(tparams, tcfg, cache_dtype=torch.float32)
    ours = engine.generate(_port_requests(tcfg), SamplingParams(**{**GREEDY,
                                                                   "max_tokens": max_tokens}),
                           return_logprobs=True)
    theirs = [{**t, "token_ids": t["token_ids"][:max_tokens], "logprobs": t["logprobs"][:max_tokens]}
              for t in _jax_greedy()]
    assert len(_requests(tcfg)[0][0]) != len(_requests(tcfg)[1][0])
    _assert_same_as_jax(ours, theirs)
    for o in ours:
        assert 1 <= len(o["token_ids"]) <= max_tokens
    steps = max(len(o["token_ids"]) for o in ours) - 1
    assert engine.decode_steps == steps and engine.decode_steps_wasted == 0


@pytest.mark.parametrize("n_requests", [1, 2])
@pytest.mark.parametrize("eos_step", [0, 4])
def test_eos_inside_a_segment_matches_jax_engine(eos_step, n_requests):
    """The tiny config's EOS set to the token that greedy decoding emits at
    step ``eos_step`` for the first request (step 0: the prefill's token):
    the rows stop where the JAX engine's stop, the tokens and
    log-probabilities (cut after the EOS) equal its, and at most DONE_LAG -
    1 steps run after every row finished. Alone, the first request wastes
    exactly that many when it stops inside a segment (the host reads its
    done flag DONE_LAG - 1 steps late), and none when the prefill's token
    is the EOS: the row is finished at its admission, and no segment
    runs."""
    _, _, tcfg, tparams = model_pair(0)
    eos = int(_jax_greedy()[0]["token_ids"][eos_step])
    engine = InferenceEngine(tparams, dataclasses.replace(tcfg, eos_token_id=eos),
                             cache_dtype=torch.float32)
    ours = engine.generate(_port_requests(tcfg)[:n_requests], SamplingParams(**GREEDY),
                           return_logprobs=True)
    theirs = _jax_greedy(eos, n_requests)
    _assert_same_as_jax(ours, theirs)
    assert ours[0]["token_ids"][-1] == eos and len(ours[0]["token_ids"]) <= eos_step + 1
    assert all(len(o["logprobs"]) == len(o["token_ids"]) for o in ours)
    assert engine.decode_steps == max(len(o["token_ids"]) for o in ours) - 1
    assert engine.decode_steps_wasted <= DONE_LAG - 1
    if n_requests == 1:
        assert engine.decode_steps_wasted == (DONE_LAG - 1 if eos_step else 0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float8_e4m3fn"])
def test_cache_write_at_a_device_column_matches_the_slice_write(dtype):
    """A decode step's write at a column held in a tensor (index_copy_, on
    uint8 views for fp8) stores the same bytes as the slice write at that
    column, values beyond +-448 included, and leaves the rest untouched."""
    B, T, Hkv, D, col = 2, 12, 2, 16, 7
    r = rng(4)
    x = torch.from_numpy(normal(r, B, 1, Hkv, D, scale=200.0)).to(torch.bfloat16)
    x[0, 0, 0, :4] = torch.tensor([1000.0, -1000.0, 448.0, 465.0])
    before = torch.from_numpy(normal(r, B, T, Hkv, D)).to(getattr(torch, dtype))
    by_slice, by_index = before.clone(), before.clone()
    write_cache(by_slice[:, col:col + 1], x)
    write_cache_at(by_index, x, torch.tensor(col))
    assert torch.equal(by_slice.view(torch.uint8), by_index.view(torch.uint8))
    assert not torch.equal(by_slice.view(torch.uint8), before.view(torch.uint8))


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
    """``second_per_grid_ts``, ``frames``, ``resize_hw`` and ``vision_embeds``
    are served (held against JAX in test_torch_engine_scheduler.py,
    test_torch_frames.py and test_torch_aria.py); ``vision_embeds`` that are
    not (n, hidden) rows, and frames that are not (T, C, H, W) with a grid,
    are refused."""
    _, _, tcfg, tparams = model_pair(0)
    engine = InferenceEngine(tparams, tcfg)
    with pytest.raises(ValueError, match="vision_embeds"):
        engine.generate([Request([5, 6], vision_embeds=np.zeros(2))])
    with pytest.raises(ValueError, match="frames"):
        engine.generate([Request([5, 6], frames=np.zeros(2))])


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


def _card_config():
    """The tiny config with its decoder widened to the head_dim the kernels
    are built for (128: 2 query heads over 1 kv head), bf16."""
    cfg = Qwen25VLConfig.tiny(torch.bfloat16)
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, hidden_size=256, intermediate_size=512, num_attention_heads=2,
        num_key_value_heads=1, mrope_section=(16, 24, 24)))


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["bfloat16", "float8_e4m3fn"])
def test_every_decode_step_runs_k4_below_the_long_context_threshold(monkeypatch, cache):
    """On the card, with LONG_DECODE_T as shipped and buffers of ~100
    slots: a decoder of 7 query heads over 1 kv head (the 7B's GQA group)
    launches K4 once a layer and decode step (graph replays counted), and
    the plain grouped decode never runs; graphed and eager give the same
    tokens."""
    from open_o3_video_tpu_torch.ops import attention as tattn
    from open_o3_video_tpu_torch.ops import kernels

    dev = cuda_device()
    cfg = _card_config()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, hidden_size=7 * 128, num_attention_heads=7, num_key_value_heads=1))
    params = TP.init(cfg, 0, dev)
    grouped = []
    monkeypatch.setattr(tattn, "_grouped_decode", lambda *a: grouped.append(a) or None)
    r = rng(8)
    reqs = [Request(r.integers(5, 400, size=n).tolist()) for n in (40, 27, 55)]
    sampling = SamplingParams(temperature=0.0, repetition_penalty=1.05, max_tokens=24)
    outs = {}
    for graph in (True, False):
        engine = InferenceEngine(params, cfg, cache_dtype=getattr(torch, cache),
                                 decode_graph=graph)
        kernels.reset_launches()
        outs[graph] = engine.generate(reqs, sampling, return_logprobs=True)
        steps = engine.decode_steps + engine.decode_steps_wasted
        assert steps > 0
        assert kernels.LAUNCHES["decode_attention_gqa"] == cfg.text.num_hidden_layers * steps
    assert not grouped
    assert outs[True] == outs[False]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16", "int4", "fp8-k4"])
def test_decode_graph_matches_eager_on_the_card(monkeypatch, case):
    """A small model on the card, two text-only requests: the graphed
    decode (one step captured, then replayed) gives the eager decode's
    tokens and log-probabilities, greedy and sampled at one seed, and the
    same kernel launch counts; with the EOS moved to the first
    row's greedy token at step 3, both stop there alone, at most DONE_LAG -
    1 steps late. "int4": the decoder in int4 (K7 on both routes); "fp8-k4":
    an fp8 cache with LONG_DECODE_T lowered, its K4 launches counted (every
    case's decode steps run K4 on the card)."""
    from open_o3_video_tpu_torch.ops import attention as tattn
    from open_o3_video_tpu_torch.ops import kernels

    dev = cuda_device()
    cfg = _card_config()
    params = TP.init(cfg, 0, dev, quantize_text="int4" if case == "int4" else False)
    cache_dtype = torch.float8_e4m3fn if case == "fp8-k4" else torch.bfloat16
    if case == "fp8-k4":
        monkeypatch.setattr(tattn, "LONG_DECODE_T", 64)
    r = rng(7)
    reqs = [Request(r.integers(5, 400, size=n).tolist()) for n in (40, 27)]
    for sampling in (SamplingParams(temperature=0.0, repetition_penalty=1.05, max_tokens=24),
                     SamplingParams(temperature=0.7, top_p=0.9, repetition_penalty=1.05,
                                    max_tokens=24, seed=3)):
        outs, launches, steps = {}, {}, {}
        for graph in (True, False):
            engine = InferenceEngine(params, cfg, cache_dtype=cache_dtype, decode_graph=graph)
            kernels.reset_launches()
            outs[graph] = engine.generate(reqs, sampling, return_logprobs=True)
            launches[graph] = dict(kernels.LAUNCHES)
            steps[graph] = (engine.decode_steps, engine.decode_steps_wasted)
        assert outs[True] == outs[False]
        assert launches[True] == launches[False] and steps[True] == steps[False]
        assert steps[True][0] > 0 and all(launches[True].values())
        if case == "int4":
            assert launches[True]["int4_matmul"] > 0 and launches[True]["int4_matmul_wgmma"] > 0
        if case == "fp8-k4":
            assert launches[True]["decode_attention_gqa"] == 2 * sum(steps[True])
        if sampling.temperature == 0.0:
            eos = outs[False][0]["token_ids"][3]
    stop_cfg = dataclasses.replace(cfg, eos_token_id=eos)
    stopped = {}
    for graph in (True, False):
        engine = InferenceEngine(params, stop_cfg, cache_dtype=cache_dtype, decode_graph=graph)
        stopped[graph] = engine.generate(reqs[:1], SamplingParams(
            temperature=0.0, repetition_penalty=1.05, max_tokens=24))[0]["token_ids"]
        assert engine.decode_steps_wasted <= DONE_LAG - 1
    assert stopped[True] == stopped[False] and stopped[True][-1] == eos
