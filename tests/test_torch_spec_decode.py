"""The port's greedy prompt-lookup speculative decoding (``spec_decode``,
JAX's ``_segment_spec_impl``) on the CPU, f32 caches, the tiny model of
``_torch_parity.model_pair``: each case runs the port's spec engine, its
plain engine and the JAX package's spec engine with the same knobs. The
spec tokens must equal the plain path's and JAX's; the log-probabilities
agree within 1e-5 of the plain path's (the verify block sums in other
shapes than a one-token step) and within ATOL_MODEL of JAX's; ``spec_stats``
(verify steps, tokens emitted) equal JAX's. The cases mirror the JAX
package's ``tests/test_spec_decode.py``: repetition penalty, an EOS moved
into the stream, budgets of 1-5, a cycling stream that accepts drafts,
sequential admissions through one slot, a prefix-cached group, and groups
the path leaves to the plain one. Also the three ``decode_attn_impl``
values, a verify block against sequential steps, the K1-column cache write
and, on the card, the verify step's graph against eager decoding."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_MODEL, cuda_device, model_pair, normal, rng

from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.models.qwen25vl.text import (
    init_kv_cache,
    logits_from_hidden,
    text_forward,
    write_cache_at,
)
from open_o3_video_tpu_torch.ops import attention as tattn

# Spec against plain, both the port's, f32: the block's matmuls have K1
# rows where a step's have 1, so sums differ in order (~1e-7 relative).
ATOL_PLAIN = 1e-5
BASE = (("prompt_buckets", (64,)),)


def _knobs(**kw) -> tuple:
    return tuple(sorted({**dict(BASE), **kw}.items()))


SPEC = _knobs(spec_decode=True, spec_draft=4)


@functools.cache
def _jax_engine(knobs: tuple, eos=None):
    import jax.numpy as jnp

    from open_o3_video_tpu.engine import InferenceEngine as JaxEngine

    jcfg, jparams, _, _ = model_pair(0)
    if eos is not None:
        jcfg = dataclasses.replace(jcfg, eos_token_id=eos)
    return JaxEngine(jparams, jcfg, cache_dtype=jnp.float32, **dict(knobs))


def _jax_generate(knobs: tuple, reqs, sampling, eos=None):
    """The JAX engine's outputs and the spec_stats of this call."""
    from open_o3_video_tpu.engine import Request as JaxRequest
    from open_o3_video_tpu.engine import SamplingParams as JaxSampling

    engine = _jax_engine(knobs, eos)
    before = dict(engine.spec_stats)
    outs = engine.generate([JaxRequest(input_ids=list(r.input_ids)) for r in reqs],
                           JaxSampling(**dataclasses.asdict(sampling)), return_logprobs=True)
    return outs, {k: engine.spec_stats[k] - before[k] for k in before}


def _port(knobs: tuple, eos=None) -> InferenceEngine:
    _, _, tcfg, tparams = model_pair(0)
    if eos is not None:
        tcfg = dataclasses.replace(tcfg, eos_token_id=eos)
    return InferenceEngine(tparams, tcfg, cache_dtype=torch.float32, **dict(knobs))


def _check(knobs, reqs, sampling, eos=None):
    """The port's spec outputs and engine, after holding them to its plain
    engine's and to the JAX spec engine's."""
    spec = _port(knobs, eos)
    ours = spec.generate(reqs, sampling, return_logprobs=True)
    plain_knobs = tuple((k, v) for k, v in knobs if not k.startswith("spec_"))
    plain = _port(plain_knobs, eos).generate(reqs, sampling, return_logprobs=True)
    theirs, stats = _jax_generate(knobs, reqs, sampling, eos)
    for o, p, t in zip(ours, plain, theirs):
        assert o["token_ids"] == p["token_ids"] == [int(x) for x in t["token_ids"]]
        np.testing.assert_allclose(o["logprobs"], p["logprobs"], atol=ATOL_PLAIN, rtol=0)
        np.testing.assert_allclose(o["logprobs"], t["logprobs"], atol=ATOL_MODEL, rtol=0)
    assert spec.spec_stats == {**stats, "probe_disabled": 0}
    return ours, spec


def greedy(n, penalty=1.0):
    return SamplingParams(temperature=0.0, repetition_penalty=penalty, max_tokens=n)


@pytest.mark.parametrize("prompt", [[5, 6, 7, 8, 9, 10, 11], [10, 11, 12, 13] * 3, [9, 8, 7, 6, 5]])
def test_greedy_matches_plain_and_jax(prompt):
    _check(SPEC, [Request(prompt)], greedy(24))


@pytest.mark.parametrize("prompt", [[3, 4, 5, 6], [40, 41, 42, 43, 44, 45, 46, 47]])
def test_repetition_penalty_matches_plain_and_jax(prompt):
    """The penalty makes the argmax depend on the seen set, which the scan
    updates in the sequential order."""
    _check(SPEC, [Request(prompt)], greedy(24, penalty=1.3))


@functools.cache
def _eos_at(step: int) -> int:
    """The token greedy decoding of [7, 7, 7, 7] emits at ``step``, through
    the JAX engine with the config's own EOS."""
    outs, _ = _jax_generate(_knobs(), [Request([7, 7, 7, 7])], greedy(16))
    return int(outs[0]["token_ids"][step])


@pytest.mark.parametrize("step", [0, 3, 9])
def test_eos_inside_a_verify_block(step):
    """The config's EOS moved to the token greedy emits at ``step``: the
    stream stops there, inside a block of accepted drafts or at its
    first position."""
    eos = _eos_at(step)
    ours, _ = _check(SPEC, [Request([7, 7, 7, 7])], greedy(16), eos=eos)
    assert ours[0]["token_ids"][-1] == eos and len(ours[0]["token_ids"]) <= step + 1


@pytest.mark.parametrize("budget", [1, 2, 3, 5])
def test_budgets_shorter_than_a_block(budget):
    """The budget truncates emission inside the scan, also while drafts are
    accepted; a budget of 1 leaves the group to the plain path."""
    ours, spec = _check(SPEC, [Request([7, 7, 7, 7])], greedy(budget))
    assert len(ours[0]["token_ids"]) == budget
    assert (spec.spec_stats["verify_steps"] > 0) == (budget > 1)


def test_cycling_stream_accepts_drafts():
    """Greedy decoding of a fixed random net falls into a cycle, after
    which every continuation is a bigram match: more than 1.2 tokens per
    verify, and graph captures of the verify step only on the card."""
    ours, spec = _check(SPEC, [Request([7, 7, 7, 7])], greedy(64))
    tail = ours[0]["token_ids"][-24:]
    assert any(tail[i:i + 4] == tail[i + p:i + p + 4] for p in range(1, 12)
               for i in range(len(tail) - p - 4))
    st = spec.spec_stats
    assert st["emitted"] / st["verify_steps"] > 1.2, st
    assert spec.groups[0]["spec"] == "greedy" and spec.counters["verify_captures"] == 0


def test_sequential_admissions_through_one_slot():
    """Three requests through one slot: the history and the fed-token
    count restart at each admission."""
    reqs = [Request([5, 6, 7]), Request([20, 21, 22, 23]), Request([50, 51])]
    _, spec = _check(_knobs(spec_decode=True, spec_draft=4, max_slots=1, decode_segment=4),
                     reqs, greedy(12, penalty=1.05))
    assert spec.counters["admissions"] == 3


def test_prefix_cached_group():
    """Two requests sharing a 16-token prefix through one slot: the
    prefix + suffix layout feeds the drafting history."""
    shared = list(range(30, 46))
    reqs = [Request(shared + [60, 61]), Request(shared + [70, 71, 72])]
    _, spec = _check(_knobs(spec_decode=True, spec_draft=4, prefix_cache_min=8,
                            suffix_buckets=(16,), max_slots=1), reqs, greedy(12, penalty=1.05))
    assert spec.counters["prefix_blocks"] == 1 and spec.counters["prefix_hits"] == 1


def test_spec_leaves_batches_and_sampling_to_the_plain_path():
    """Groups of more than one row, or sampled, take the plain path (no
    verify step) with spec_decode on, and give its outputs."""
    reqs = [Request([5, 6, 7]), Request([8, 9, 10, 11])]
    spec, plain = _port(_knobs(spec_decode=True)), _port(_knobs())
    assert spec.generate(reqs, greedy(8)) == plain.generate(reqs, greedy(8))
    sampled = SamplingParams(temperature=0.7, repetition_penalty=1.0, max_tokens=8, seed=3)
    assert spec.generate(reqs[:1], sampled) == plain.generate(reqs[:1], sampled)
    assert spec.spec_stats["verify_steps"] == 0 and spec.groups[0].get("spec") is None


@pytest.mark.parametrize("route", ["short", "k4"])
def test_decode_attn_impl_values_give_equal_tokens(monkeypatch, route):
    """"auto", "pallas" and "xla" through the plain step and the verify
    blocks: equal greedy tokens, spec and plain. Below LONG_DECODE_T
    "pallas" takes K3's plain version (the others the grouped decode);
    with LONG_DECODE_T lowered to 16 every decode and verify block takes
    K4's route ("xla" its plain version through the "torch" route)."""
    if route == "k4":
        monkeypatch.setattr(tattn, "LONG_DECODE_T", 16)
    reqs = [Request([7, 7, 7, 7])]
    outs = {}
    for impl in ("auto", "pallas", "xla"):
        for spec in (True, False):
            engine = _port(_knobs(spec_decode=spec, spec_draft=4, decode_attn_impl=impl))
            outs[impl, spec] = engine.generate(reqs, greedy(20), return_logprobs=True)[0]
    first = outs["auto", False]
    for o in outs.values():
        assert o["token_ids"] == first["token_ids"]
        np.testing.assert_allclose(o["logprobs"], first["logprobs"], atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="decode_attn_impl"):
        _port(_knobs(decode_attn_impl="splash"))


def test_decode_attn_impl_leaves_the_int4_matmuls_alone(monkeypatch):
    """"xla" picks the attention's plain version only: the matmuls keep
    their own impl ("auto"), as JAX's knob never reaches them."""
    from open_o3_video_tpu_torch.models.qwen25vl import text as ttext

    seen = []
    real = ttext.dense
    monkeypatch.setattr(ttext, "dense", lambda x, w, impl="auto": seen.append(impl) or real(x, w, impl))
    _port(_knobs(decode_attn_impl="xla", spec_decode=True)).generate([Request([5, 6, 7])], greedy(4))
    assert seen and set(seen) == {"auto"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float8_e4m3fn])
def test_verify_block_equals_sequential_steps(dtype):
    """One forward of a K1 = 5 block at a device column (the verify's
    masking, column <= position and validity, and its K1-column cache
    write, through uint8 views for fp8) gives the logits of 5 single-token
    steps at those columns, and writes the same cache bytes."""
    _, _, tcfg, tparams = model_pair(0)
    t = tcfg.text
    B, T, s, K1 = 2, 24, 9, 5
    r = rng(11)
    cache = init_kv_cache(t, B, T, dtype=torch.float32)
    for name in ("k", "v"):
        cache[name].copy_(torch.from_numpy(normal(r, *cache[name].shape)))
    cache = {k: v.to(dtype) for k, v in cache.items()}
    valid = torch.zeros((B, T), dtype=torch.bool)
    valid[0, 2:s] = True
    valid[1, [0, 3, 4, 7]] = True  # holes, as rejected drafts leave them
    valid[:, s:s + K1] = True
    fed = torch.from_numpy(r.integers(5, 90, size=(B, K1)))
    mrope = torch.from_numpy(r.integers(10, 20, size=B))
    blk = torch.arange(K1)
    p = torch.tensor(s)
    block_cache = {k: v.clone() for k, v in cache.items()}
    h, _ = text_forward(tparams["text"], t, _embed(tparams, fed),
                        (mrope[:, None] + blk)[None].expand(3, B, K1),
                        seq_positions=(p + blk)[None].expand(B, K1), attn_valid=valid,
                        cache=block_cache, cache_offset=p)
    block = logits_from_hidden(tparams["text"], h)
    steps = []
    step_cache = {k: v.clone() for k, v in cache.items()}
    for i in range(K1):
        hi, _ = text_forward(tparams["text"], t, _embed(tparams, fed[:, i:i + 1]),
                             (mrope[:, None] + i)[None].expand(3, B, 1),
                             seq_positions=torch.full((B, 1), s + i), attn_valid=valid,
                             cache=step_cache, cache_offset=torch.tensor(s + i))
        steps.append(logits_from_hidden(tparams["text"], hi)[:, 0])
    torch.testing.assert_close(block, torch.stack(steps, 1), atol=ATOL_PLAIN, rtol=0)
    for name in ("k", "v"):
        a, b = block_cache[name].float(), step_cache[name].float()
        assert torch.allclose(a, b, atol=ATOL_PLAIN, rtol=0)
        assert torch.equal(a[:, :, :s], cache[name].float()[:, :, :s])


def _embed(params, ids):
    from open_o3_video_tpu_torch.models.qwen25vl.model import embed_tokens

    return embed_tokens(params, ids)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
def test_block_cache_write_at_a_device_column(dtype):
    """write_cache_at of a (B, K1) block at a column held on the device
    stores the bytes of the slice write, fp8 through uint8 views."""
    from open_o3_video_tpu_torch.models.qwen25vl.text import write_cache

    r = rng(5)
    x = torch.from_numpy(normal(r, 2, 8, 2, 16, scale=200.0))
    by_slice = torch.zeros((2, 30, 2, 16), dtype=dtype)
    by_index = by_slice.clone()
    write_cache(by_slice[:, 13:21], x)
    write_cache_at(by_index, x, torch.tensor(13))
    assert torch.equal(by_slice.view(torch.uint8) if dtype == torch.float8_e4m3fn else by_slice,
                       by_index.view(torch.uint8) if dtype == torch.float8_e4m3fn else by_index)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["greedy", "greedy-k4", "sampled", "sampled-pallas"])
def test_verify_graph_matches_eager_on_the_card(monkeypatch, case):
    """A small model on the card in bf16: the verify step captured once per
    group and replayed gives the eager verify loop's tokens, log-
    probabilities, spec_stats and launch counts. "greedy-k4": LONG_DECODE_T
    lowered so the blocks run K4 at S = K1; "sampled": 4 rows at
    temperature 1 with a surplus small enough to compact;
    "sampled-pallas": K3 at S = K1."""
    from test_torch_engine import _card_config

    from open_o3_video_tpu_torch.ops import kernels

    dev = cuda_device()
    cfg = _card_config()
    params = TP.init(cfg, 0, dev)
    if case == "greedy-k4":
        monkeypatch.setattr(tattn, "LONG_DECODE_T", 64)
    r = rng(3)
    sampled = case.startswith("sampled")
    knobs = (dict(spec_sample=True, spec_draft=7, spec_surplus=24) if sampled
             else dict(spec_decode=True, spec_draft=7))
    if case == "sampled-pallas":
        knobs["decode_attn_impl"] = "pallas"
    reqs = [Request(r.integers(5, 400, size=n).tolist()) for n in ((40, 27, 55, 33) if sampled
                                                                  else (70,))]
    sampling = (SamplingParams(temperature=1.0, top_p=0.9, repetition_penalty=1.0,
                               max_tokens=40, seed=3) if sampled
                else SamplingParams(temperature=0.0, repetition_penalty=1.0, max_tokens=40))
    got = {}
    for graph in (True, False):
        engine = InferenceEngine(params, cfg, decode_graph=graph, **knobs)
        engine.spec_warmup, engine.spec_min_rate = 0, 0.0
        kernels.reset_launches()
        outs = engine.generate(reqs, sampling, return_logprobs=True)
        got[graph] = (outs, dict(engine.spec_stats), dict(kernels.LAUNCHES),
                      engine.counters["verify_captures"], engine.counters["compactions"])
    assert got[True][:3] == got[False][:3]
    assert got[True][3] >= 1 and got[False][3] == 0 and got[True][1]["verify_steps"] > 0
    if sampled:
        assert got[True][4] >= 1
    if case == "greedy-k4":
        assert got[True][2]["decode_attention_gqa"] > 0
    if case == "sampled-pallas":
        assert got[True][2]["flash_attention_gqa"] > 0
