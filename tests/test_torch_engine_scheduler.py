"""The port's engine scheduler against the JAX engine's, same tiny weights
(``_torch_parity.model_pair``), on the CPU, f32 caches: each case runs both
engines with the same knobs, and the greedy token ids must be equal and the
log-probabilities agree within ATOL_MODEL. The cases mirror the JAX
package's ``tests/test_engine_continuous.py`` and ``tests/test_prefix_cache.py``:
slots with refills, a ring that wraps ~3 times with an EOS planted inside
a segment (through the grouped decode and through K4's route), mixed
buckets, interleaved chunked prefill, ``max_kv_gb``, the automatic prefix
cache (a text family, identical prompts, 5 vision queries over one 4-frame
request, an outlier member, two families, vision in the suffix, the LRU,
reuse across calls, equal-content frames, the digest memo), a params swap
and an in-place weight update (port only), a sampled call, and a video
request with ``second_per_grid_ts``. Also the ring step's validity-only
mask with valid columns past the write head. On the card: the graphed
decode against the eager one over a call with refills and a wrap."""

import dataclasses
import functools
import gc

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_MODEL, cuda_device, model_pair, normal, rng

from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.models.qwen25vl.text import init_kv_cache, text_forward
from open_o3_video_tpu_torch.ops import attention as tattn
from open_o3_video_tpu_torch.ops.preprocess import patchify


def _knobs(**kw) -> tuple:
    return tuple(sorted(kw.items()))


@functools.cache
def _jax_engine(knobs: tuple, eos=None):
    import jax.numpy as jnp

    from open_o3_video_tpu.engine import InferenceEngine as JaxEngine

    jcfg, jparams, _, _ = model_pair(0)
    if eos is not None:
        jcfg = dataclasses.replace(jcfg, eos_token_id=eos)
    return JaxEngine(jparams, jcfg, cache_dtype=jnp.float32, **dict(knobs))


def _jax_generate(knobs: tuple, reqs, sampling: SamplingParams, eos=None, fresh=False):
    """The JAX engine's outputs; ``fresh``: through a new engine (whose
    programs trace anew, after a module constant was patched)."""
    from open_o3_video_tpu.engine import Request as JaxRequest
    from open_o3_video_tpu.engine import SamplingParams as JaxSampling

    engine = (_jax_engine.__wrapped__ if fresh else _jax_engine)(knobs, eos)
    fields = [f.name for f in dataclasses.fields(Request)]
    return engine.generate([JaxRequest(**{f: getattr(r, f) for f in fields}) for r in reqs],
                           JaxSampling(**dataclasses.asdict(sampling)), return_logprobs=True)


def _port(knobs: tuple, eos=None, params=None) -> InferenceEngine:
    _, _, tcfg, tparams = model_pair(0)
    if eos is not None:
        tcfg = dataclasses.replace(tcfg, eos_token_id=eos)
    return InferenceEngine(params or tparams, tcfg, cache_dtype=torch.float32, **dict(knobs))


def _assert_same(ours, theirs):
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        assert o["num_prompt_tokens"] == t["num_prompt_tokens"]
        assert o["token_ids"] == [int(x) for x in t["token_ids"]]
        np.testing.assert_allclose(o["logprobs"], t["logprobs"], atol=ATOL_MODEL)


def _both(knobs, reqs, sampling, eos=None, fresh=False):
    """(port outputs, port engine) after holding them to the JAX engine's."""
    engine = _port(knobs, eos)
    ours = engine.generate(reqs, sampling, return_logprobs=True)
    _assert_same(ours, _jax_generate(knobs, reqs, sampling, eos, fresh))
    return ours, engine


def _text(r, k, lo, hi):
    return [Request(r.integers(5, 90, size=int(r.integers(lo, hi))).tolist()) for _ in range(k)]


SLOTS = _knobs(prompt_buckets=(16, 32), max_slots=2, decode_segment=4)


def greedy(n, penalty=1.05):
    return SamplingParams(temperature=0.0, repetition_penalty=penalty, max_tokens=n)


def test_queue_past_slots_matches_solo_and_jax():
    """5 requests through 2 slots in segments of 4 steps: refills, each
    request's tokens equal to its run alone and to the JAX engine's."""
    reqs = _text(rng(0), 5, 4, 14)
    ours, engine = _both(SLOTS, reqs, greedy(6))
    assert engine.counters["admissions"] >= 3 and engine.groups[0]["slots"] == 2
    solo = _port(SLOTS)
    for r, o in zip(reqs, ours):
        assert solo.generate([r], greedy(6))[0]["token_ids"] == o["token_ids"]


def _ring_requests():
    return _text(rng(7), 6, 8, 15)


@functools.cache
def _ring_eos() -> int:
    """The token that greedy decoding emits at step 10 of the first ring
    request, through the JAX engine with the config's own EOS."""
    return int(_jax_generate(SLOTS, _ring_requests(), greedy(40))[0]["token_ids"][10])


@pytest.mark.parametrize("route", ["grouped", "k4"])
def test_ring_wrap_stress_matches_jax(monkeypatch, route):
    """6 requests x up to 40 tokens through 2 slots in segments of 4 steps,
    the EOS moved to the token the first request emits at step 10 (inside
    a segment): the write head goes round the 40-column ring more than
    twice, so rows decode over columns past the head. "k4": LONG_DECODE_T
    lowered on both sides, so that every decode step takes K4's route (its
    plain version here) at query position T."""
    if route == "k4":
        from open_o3_video_tpu.ops import attention as jattn

        monkeypatch.setattr(jattn, "LONG_DECODE_T", 48)
        monkeypatch.setattr(tattn, "LONG_DECODE_T", 48)
        calls = []
        real = tattn.decode_attention_gqa
        monkeypatch.setattr(tattn, "decode_attention_gqa",
                            lambda *a, **kw: calls.append(1) or real(*a, **kw))
    eos = _ring_eos()
    ours, engine = _both(SLOTS, _ring_requests(), greedy(40), eos=eos, fresh=route == "k4")
    assert ours[0]["token_ids"][-1] == eos and len(ours[0]["token_ids"]) <= 11
    assert engine.counters["ring_wraps"] >= 2 and engine.counters["admissions"] >= 4
    if route == "k4":
        assert len(calls) >= 2 * engine.decode_steps


def test_mixed_buckets_one_call():
    """A 24-token and an 8-token prompt in one call: two groups (buckets 32
    and 16), each equal to its run alone and to the JAX engine's."""
    r = rng(2)
    long, short = Request(r.integers(5, 90, size=24).tolist()), Request(
        r.integers(5, 90, size=8).tolist())
    ours, engine = _both(SLOTS, [long, short], greedy(6))
    assert engine.counters["groups"] == 2
    solo = _port(SLOTS)
    assert solo.generate([long], greedy(6))[0]["token_ids"] == ours[0]["token_ids"]
    assert solo.generate([short], greedy(6))[0]["token_ids"] == ours[1]["token_ids"]


CHUNKED = _knobs(prompt_buckets=(64,), max_slots=2, decode_segment=4, prefill_chunk=16)


def test_interleaved_chunked_prefill_matches_jax():
    """prefill_chunk=16, 3 prompts of 40-61 tokens through 2 slots, the EOS
    moved to the token the first request emits at step 2: it finishes
    while the second decodes, so the third is admitted in chunks with
    decode segments between them; tokens equal to the JAX engine's and to
    the port's unchunked run."""
    reqs = _text(rng(11), 3, 40, 62)
    eos = int(_jax_generate(CHUNKED, reqs, greedy(10))[0]["token_ids"][2])
    ours, engine = _both(CHUNKED, reqs, greedy(10), eos=eos)
    assert engine.counters["interleaved_segments"] >= 2
    plain = _port(_knobs(prompt_buckets=(64,), max_slots=2, decode_segment=4), eos=eos)
    assert [o["token_ids"] for o in plain.generate(reqs, greedy(10))] == [
        o["token_ids"] for o in ours]


def test_max_kv_gb_caps_slots():
    """A KV budget of 2.5 slots of the JAX engine's 40-column arena caps 4
    slots to 2 on both sides (the port's arena is 36 columns: 28 + 8); the
    arena's bytes stay within the budget and the tokens equal the JAX
    engine's."""
    _, _, tcfg, _ = model_pair(0)
    t = tcfg.text
    per_col = 2 * t.num_hidden_layers * t.num_key_value_heads * t.head_dim * 4
    budget_gb = 2.5 * per_col * (32 + 8) / 1e9
    r = rng(23)
    reqs = [Request(r.integers(5, 90, size=n).tolist()) for n in (12, 28, 9, 20)]
    knobs = _knobs(prompt_buckets=(32,), max_slots=4, decode_segment=4, max_kv_gb=budget_gb)
    ours, engine = _both(knobs, reqs, greedy(8))
    assert engine.groups == [{"requests": 4, "slots": 2, "columns": 36,
                              "arena_bytes": 2 * 36 * per_col}]
    assert engine.groups[0]["arena_bytes"] <= budget_gb * 1e9
    assert set(_jax_engine(knobs, None)._arenas) == {(2, 40)}


# ---------------------------------------------------------------- prefix cache

PREFIX = _knobs(prompt_buckets=(64, 128), prefix_cache_min=8, suffix_buckets=(16, 32))


def _family(base, k=5, prefix=30, tails=(3, 5, 7, 9, 11)):
    """k requests sharing a ``prefix``-token prefix, with distinct tails."""
    shared = [(base + 7 * i) % 90 for i in range(prefix)]
    return [Request(shared + [(t + j) % 90 for j in range(t)]) for t in tails[:k]]


def _image_patches(frames_tchw):
    """Frames as images: each frame patchified alone (T = 1), grids (n, 3)."""
    parts = [patchify(frames_tchw[i:i + 1]) for i in range(frames_tchw.shape[0])]
    return (np.concatenate([p for p, _ in parts]),
            np.asarray([g for _, g in parts], dtype=np.int64))


def _vision_family(cfg, frames_tchw, k=5, patches=None):
    """k queries over one request's frames: the vision block, then question
    tails that differ."""
    if patches is None:
        patches, grid = _image_patches(frames_tchw)
    else:
        grid = _image_patches(frames_tchw)[1]
    n_tok = patches.shape[0] // cfg.vision.merge_unit
    shared = [7, 8, cfg.vision_start_token_id] + [cfg.image_token_id] * n_tok + [
        cfg.vision_end_token_id]
    return [Request(shared + [20 + q, 30 + q, 40 + q], pixel_patches=patches, grid_thw=grid,
                    vision_token_id=cfg.image_token_id) for q in range(k)]


def test_prefix_text_family():
    reqs = _family(13)
    ours, engine = _both(PREFIX, reqs, greedy(8))
    assert engine._detect_prefixes(reqs) == [30] * 5
    assert len(engine._prefix_kv) == 1 and engine.counters["prefix_blocks"] == 1
    assert _port(_knobs(prefix_cache_min=0)).generate(reqs, greedy(8)) == [
        {k: v for k, v in o.items() if k != "logprobs"} for o in ours]


def test_identical_prompts_share_all_but_the_last_token():
    ids = [(11 + 3 * i) % 90 for i in range(40)]
    reqs = [Request(list(ids)) for _ in range(4)]
    ours, engine = _both(PREFIX, reqs, greedy(6))
    assert engine._detect_prefixes(reqs) == [39] * 4
    assert all(o["token_ids"] == ours[0]["token_ids"] for o in ours)


def test_five_vision_queries_over_one_four_frame_request():
    """V-STAR's shape: 5 queries over one request of 4 frames share one
    prefix block, whose prefill is the call's one tower pass. The prefill
    forwards compute the block once and the five 3-token suffixes."""
    _, _, tcfg, _ = model_pair(0)
    reqs = _vision_family(tcfg, rng(0).integers(0, 256, size=(4, 3, 28, 56), dtype=np.uint8))
    ours, engine = _both(PREFIX, reqs, greedy(6))
    assert len(engine._prefix_kv) == 1
    assert engine.counters["tower_passes"] == 1 and engine.counters["prefix_blocks"] == 1
    # 2 ids and the vision start, 4 frames of 28 x 56 (2 x 4 patches of 14, 1 x 2
    # merged units), the vision end
    prefix = 3 + 4 * 2 + 1
    assert engine._detect_prefixes(reqs) == [prefix] * 5
    assert engine.counters["prompt_tokens"] == 5 * (prefix + 3)
    assert engine.counters["prefill_tokens"] == prefix + 5 * 3


def test_outlier_member_runs_plain():
    """A member whose suffix (40) exceeds the largest suffix bucket (32)
    runs plain without defeating its siblings' prefix."""
    reqs = _family(19, k=3, tails=(3, 5, 40))
    ours, engine = _both(PREFIX, reqs, greedy(4))
    assert engine._detect_prefixes(reqs) == [30, 30, 0]
    assert engine.counters["groups"] == 2


def test_two_families_and_a_lone_request_in_one_call():
    """GSPO's shape, 3 copies each of two prompts, beside an unrelated
    request: each family its own block, the lone request plain, all in one
    group (one prompt bucket) and one ring: the shorter family's block
    leaves a hole before column P, the lone row is left-padded beside the
    suffix rows."""
    a = [(2 + 5 * i) % 90 for i in range(35)]
    b = [(4 + 11 * i) % 90 for i in range(42)]
    reqs = [Request(list(a)) for _ in range(3)] + [Request(list(b)) for _ in range(3)] + [
        Request([88, 3, 44, 17, 9, 60, 21])]
    ours, engine = _both(PREFIX, reqs, greedy(4))
    assert engine._detect_prefixes(reqs) == [34] * 3 + [41] * 3 + [0]
    assert engine.counters["prefix_blocks"] == 2 and engine.counters["groups"] == 1


def test_vision_in_the_suffix_falls_back():
    _, _, tcfg, _ = model_pair(0)
    patches, grid = _image_patches(rng(1).integers(0, 256, size=(2, 3, 28, 28), dtype=np.uint8))
    n_tok = patches.shape[0] // tcfg.vision.merge_unit
    reqs = [Request([(5 + i) % 90 for i in range(12)] + [60 + q, tcfg.vision_start_token_id]
                    + [tcfg.image_token_id] * n_tok + [tcfg.vision_end_token_id],
                    pixel_patches=patches, grid_thw=grid, vision_token_id=tcfg.image_token_id)
            for q in range(2)]
    ours, engine = _both(PREFIX, reqs, greedy(4))
    assert engine._detect_prefixes(reqs) == [0, 0] and not engine._prefix_kv


def test_prefix_cache_lru_bound():
    knobs = _knobs(prompt_buckets=(64,), prefix_cache_min=8, suffix_buckets=(16,),
                   prefix_cache_entries=2)
    engine = _port(knobs)
    for base in (3, 17, 41):
        reqs = _family(base, k=2, prefix=20, tails=(3, 5))
        _assert_same(engine.generate(reqs, greedy(2), return_logprobs=True),
                     _jax_generate(knobs, reqs, greedy(2)))
    assert len(engine._prefix_kv) == 2 and engine.counters["prefix_blocks"] == 3


def test_prefix_block_reused_across_calls():
    engine = _port(PREFIX)
    engine.generate(_family(29), greedy(4))
    key = next(iter(engine._prefix_kv))
    reqs = _family(29, tails=(4, 6))
    ours = engine.generate(reqs, greedy(4), return_logprobs=True)
    assert list(engine._prefix_kv) == [key] and engine.counters["prefix_hits"] >= 1
    assert engine.counters["prefix_blocks"] == 1
    _assert_same(ours, _jax_generate(PREFIX, reqs, greedy(4)))


def test_equal_content_recomputed_frames_share_one_block():
    """Two arrays of equal bytes (the same video decoded twice) cluster and
    share one block; the call encodes each array once."""
    _, _, tcfg, _ = model_pair(0)
    frames = rng(5).integers(0, 256, size=(2, 3, 28, 56), dtype=np.uint8)
    a = _vision_family(tcfg, frames, k=1, patches=_image_patches(frames.copy())[0])
    b = _vision_family(tcfg, frames, k=2, patches=_image_patches(frames.copy())[0])[1:]
    assert a[0].pixel_patches is not b[0].pixel_patches
    ours, engine = _both(PREFIX, a + b, greedy(4))
    pls = engine._detect_prefixes(a + b)
    assert pls[0] == pls[1] > 0 and len(engine._prefix_kv) == 1


def test_vis_digest_memo_does_not_pin_arrays():
    engine = _port(PREFIX)
    a = np.random.default_rng(0).random((4, 64), np.float32)
    d1 = engine._vis_digest(a)
    assert engine._vis_digest(a) == d1
    key = id(a)
    assert engine._vis_digests[key][1]() is a
    del a
    gc.collect()
    assert engine._vis_digests[key][1]() is None
    assert engine._vis_digest(np.random.default_rng(0).random((4, 64), np.float32)) == d1
    t = torch.zeros(3)
    assert engine._vis_digest(t) == engine._vis_digest(t) != engine._vis_digest(torch.zeros(3))


def _scaled(tree, s):
    """A copy of a param tree with every float tensor times ``s``."""
    if isinstance(tree, dict):
        return {k: _scaled(v, s) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_scaled(v, s) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree * s
    return tree


def test_params_swap_clears_the_prefix_cache():
    """A new param dict clears the blocks: the next call equals a plain
    engine on the new weights, and the JAX engine's after its own swap to
    the same weights."""
    import jax
    import jax.numpy as jnp

    _, jparams, tcfg, _ = model_pair(0)
    jnew = jax.tree.map(lambda x: x * 1.01 if jnp.issubdtype(x.dtype, jnp.floating) else x,
                        jparams)
    engine = _port(PREFIX)
    engine.generate(_family(31), greedy(4))
    assert len(engine._prefix_kv) == 1
    engine.params = TP.from_jax_params(jax.tree.map(np.asarray, jnew), tcfg, torch.device("cpu"))
    assert not engine._prefix_kv
    ours = engine.generate(_family(31), greedy(4), return_logprobs=True)
    assert len(engine._prefix_kv) == 1
    fresh = _port(_knobs(prefix_cache_min=0), params=engine.params)
    assert [o["token_ids"] for o in fresh.generate(_family(31), greedy(4))] == [
        o["token_ids"] for o in ours]
    jengine = _jax_engine(PREFIX, None)
    jengine.params = jnew
    try:
        _assert_same(ours, _jax_generate(PREFIX, _family(31), greedy(4)))
    finally:
        jengine.params = jparams


def test_in_place_weight_update_with_the_same_dict_clears_the_prefix_cache():
    """The port's optimizers update weights in place, and GSPO's full
    fine-tune assigns the same dict again: that assignment clears the block
    prefilled under the old weights, so the next call equals a fresh engine
    on the updated weights (and differs from the stale block's answer)."""
    _, _, tcfg, tparams = model_pair(0)
    params = _scaled(tparams, 1.0)  # a private copy to update in place
    engine = _port(PREFIX, params=params)
    reqs = _family(37)
    before = engine.generate(reqs, greedy(6), return_logprobs=True)
    with torch.no_grad():
        for layer in params["text"]["layers"]:
            layer["q_w"].mul_(3.0)
            layer["gate_w"].mul_(-1.5)
    stale = engine.generate(reqs, greedy(6), return_logprobs=True)  # the old block serves
    engine.params = params
    assert not engine._prefix_kv
    after = engine.generate(reqs, greedy(6), return_logprobs=True)
    fresh = _port(PREFIX, params=params).generate(reqs, greedy(6), return_logprobs=True)
    assert after == fresh and after != stale and after != before


def test_sampled_call_is_reproducible_and_identical_prompts_differ():
    """temperature 1, 4 copies of one prompt through the prefix path: the
    same seed gives the same rows, the rows differ from each other, and
    another seed gives other rows."""
    engine = _port(PREFIX)
    ids = [(3 + 7 * i) % 90 for i in range(40)]
    reqs = [Request(list(ids)) for _ in range(4)]
    sp = SamplingParams(temperature=1.0, top_p=1.0, repetition_penalty=1.0, max_tokens=8, seed=0)
    a, b = engine.generate(reqs, sp), engine.generate(reqs, sp)
    assert a == b and len({tuple(o["token_ids"]) for o in a}) > 1
    assert engine.counters["prefix_hits"] >= 1
    assert engine.generate(reqs, dataclasses.replace(sp, seed=1)) != a


def test_video_request_with_second_per_grid_ts():
    """A video request (4 frames, temporal patches of 2: grid (2, 2, 4))
    with second_per_grid_ts = 0.5, whose M-RoPE time positions it scales:
    equal to the JAX engine's, and not to the same request without it."""
    from open_o3_video_tpu_torch.engine.engine import left_padded_rows

    _, _, tcfg, _ = model_pair(0)
    patches, grid = patchify(rng(3).integers(0, 256, size=(4, 3, 28, 56), dtype=np.uint8))
    n_tok = patches.shape[0] // tcfg.vision.merge_unit
    ids = [7, 8, tcfg.vision_start_token_id] + [tcfg.video_token_id] * n_tok + [
        tcfg.vision_end_token_id, 20, 30, 40]
    req = Request(ids, pixel_patches=patches, grid_thw=np.asarray([grid]),
                  vision_token_id=tcfg.video_token_id, second_per_grid_ts=[0.5])
    _both(SLOTS, [req, Request([5, 6, 7, 8, 9])], greedy(6))
    plain = dataclasses.replace(req, second_per_grid_ts=None)
    pos = left_padded_rows(tcfg, [req, plain], len(ids))[2]
    assert not np.array_equal(pos[:, 0], pos[:, 1])


@pytest.mark.parametrize("route", ["grouped", "k4"])
def test_ring_step_masks_by_validity_alone(monkeypatch, route):
    """One decode step at query position T with validity_only: valid
    columns past the write head count as the row's own. The same step on a
    cache whose columns are permuted (valid ones moved before the head)
    gives the same hidden states, on the grouped decode and on K4's route
    (its plain version)."""
    if route == "k4":
        monkeypatch.setattr(tattn, "LONG_DECODE_T", 16)
    _, _, tcfg, tparams = model_pair(0)
    t = tcfg.text
    B, T, col = 2, 16, 5
    r = rng(9)
    x = torch.from_numpy(normal(r, B, 1, t.hidden_size))
    pos = torch.from_numpy(r.integers(0, 20, size=(3, B, 1)))
    cache = init_kv_cache(t, B, T, dtype=torch.float32)
    for name in ("k", "v"):
        cache[name].copy_(torch.from_numpy(normal(r, *cache[name].shape)))
    valid = torch.zeros((B, T), dtype=torch.bool)
    valid[0, [0, 1, 2, 9, 12, 15]] = True  # row 0: columns past the head (5) too
    valid[1, [3, 4, 11]] = True
    valid[:, col] = True
    perm = torch.cat([torch.nonzero(valid[0])[:, 0], torch.nonzero(~valid[0])[:, 0]])
    outs = []
    for order in (torch.arange(T), perm):
        c = {k: v[:, :, order].clone() for k, v in cache.items()}
        at = torch.tensor(int(torch.nonzero(order == col)[0, 0]))
        h, _ = text_forward(tparams["text"], t, x, pos, seq_positions=torch.full((B, 1), T),
                            attn_valid=valid[:, order], cache=c, cache_offset=at,
                            validity_only=True)
        outs.append(h)
    torch.testing.assert_close(outs[0][0], outs[1][0], atol=ATOL_MODEL, rtol=0)
    h_written, _ = text_forward(tparams["text"], t, x, pos, seq_positions=torch.full((B, 1), T),
                                attn_valid=valid, cache={k: v.clone() for k, v in cache.items()},
                                cache_offset=torch.tensor(col))
    assert not torch.allclose(h_written[0], outs[0][0], atol=ATOL_MODEL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16", "fp8-k4", "prefix"])
def test_scheduler_graph_matches_eager_on_the_card(monkeypatch, case):
    """A small model on the card, 5 text-only requests through 2 slots in
    segments of 8 steps, 24 new tokens: refills and a ring that wraps. The
    graphed decode (captured once for the group, replayed across refills)
    gives the eager decode's tokens and log-probabilities, greedy and
    sampled at one seed, with the same launch counts. "fp8-k4": an fp8
    cache with LONG_DECODE_T lowered, so that every decode step runs K4 at
    query position T over the wrapped ring. "prefix": the requests are 3 +
    2 copies of two 300-token prompts (the prefix path, K3 at an
    offset)."""
    from test_torch_engine import _card_config

    from open_o3_video_tpu_torch.ops import kernels

    dev = cuda_device()
    cfg = _card_config()
    params = TP.init(cfg, 0, dev)
    cache_dtype = torch.float8_e4m3fn if case == "fp8-k4" else torch.bfloat16
    if case == "fp8-k4":
        monkeypatch.setattr(tattn, "LONG_DECODE_T", 64)
    r = rng(7)
    if case == "prefix":
        a, b = (r.integers(5, 400, size=300).tolist() for _ in range(2))
        reqs = [Request(list(a)) for _ in range(3)] + [Request(list(b)) for _ in range(2)]
    else:
        reqs = [Request(r.integers(5, 400, size=n).tolist()) for n in (40, 27, 55, 33, 61)]
    for sampling in (SamplingParams(temperature=0.0, repetition_penalty=1.05, max_tokens=24),
                     SamplingParams(temperature=0.7, top_p=0.9, repetition_penalty=1.05,
                                    max_tokens=24, seed=3)):
        outs, launches, counters = {}, {}, {}
        for graph in (True, False):
            engine = InferenceEngine(params, cfg, cache_dtype=cache_dtype, max_slots=2,
                                     decode_segment=8, decode_graph=graph)
            kernels.reset_launches()
            outs[graph] = engine.generate(reqs, sampling, return_logprobs=True)
            launches[graph] = dict(kernels.LAUNCHES)
            counters[graph] = (engine.decode_steps, engine.decode_steps_wasted,
                               engine.counters["admissions"], engine.counters["ring_wraps"])
        assert outs[True] == outs[False]
        assert launches[True] == launches[False] and counters[True] == counters[False]
        assert counters[True][2] > 1 and counters[True][3] >= 1
        if case == "fp8-k4":
            assert launches[True]["decode_attention_gqa"] >= 2 * counters[True][0]
        if case == "prefix":
            assert engine.counters["prefix_blocks"] == 2


def test_prefix_key_carries_the_grid_and_the_frame_spacing():
    """One 4-frame video (grid (2, 2, 4)) in two requests sharing a
    20-token prefix, with second_per_grid_ts 0.5 and 4.0: M-RoPE positions
    differ, so no block is shared, and the second request's outputs equal
    its run with the prefix cache off (f32, within 1e-5). JAX keys the
    block on the patches alone and serves the second request the first's
    block (-5.79308 against -5.79281 alone), so this is held to the plain
    path, not to JAX."""
    _, _, tcfg, _ = model_pair(0)
    patches, grid = patchify(rng(3).integers(0, 256, size=(4, 3, 28, 56), dtype=np.uint8))
    n_tok = patches.shape[0] // tcfg.vision.merge_unit
    shared = [7, 8, tcfg.vision_start_token_id] + [tcfg.video_token_id] * n_tok + [
        tcfg.vision_end_token_id] + list(range(20, 32))
    assert len(shared) == 20
    reqs = [Request(shared + tail, pixel_patches=patches, grid_thw=np.asarray([grid]),
                    vision_token_id=tcfg.video_token_id, second_per_grid_ts=[spacing])
            for tail, spacing in (([50, 51], 0.5), ([60, 61, 62], 4.0))]
    knobs = _knobs(prompt_buckets=(64,), prefix_cache_min=8, suffix_buckets=(16,))
    engine = _port(knobs)
    on = engine.generate(reqs, greedy(6), return_logprobs=True)
    off = _port(_knobs(prompt_buckets=(64,), prefix_cache_min=0)).generate(
        reqs[1:], greedy(6), return_logprobs=True)
    assert engine._detect_prefixes(reqs) == [0, 0] and engine.counters["prefix_blocks"] == 0
    assert on[1]["token_ids"] == off[0]["token_ids"]
    np.testing.assert_allclose(on[1]["logprobs"], off[0]["logprobs"], atol=1e-5, rtol=0)
    same = [dataclasses.replace(r, second_per_grid_ts=[0.5]) for r in reqs]
    assert engine._detect_prefixes(same) == [20, 20]


def test_a_prompt_over_the_largest_bucket_raises_beside_a_sibling_too():
    """prompt_buckets (64,): a 70-token prompt raises the same ValueError
    alone and beside a sibling that shares its first 60 tokens (JAX serves
    the pair: it buckets a prefix row by its prefix)."""
    r = rng(4)
    shared = r.integers(5, 90, size=60).tolist()
    pair = [Request(shared + r.integers(5, 90, size=10).tolist()) for _ in range(2)]
    engine = _port(_knobs(prompt_buckets=(64,), prefix_cache_min=8, suffix_buckets=(16,)))
    for reqs in (pair[:1], pair):
        with pytest.raises(ValueError, match="prompt length 70 exceeds largest bucket 64"):
            engine.generate(reqs, greedy(4))
