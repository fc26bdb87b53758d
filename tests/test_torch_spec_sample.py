"""The port's multi-row sampled speculative decoding (``spec_sample``, JAX's
``_segment_spec_sample_impl`` with hole compaction, the warmup and the
probe) on the CPU, f32 caches, the tiny model of
``_torch_parity.model_pair``. At temperature 0 each case runs the port's
spec engine, its plain engine and the JAX package's spec engine with the
same knobs: tokens equal to both, log-probabilities within 1e-5 of the
plain path's and ATOL_MODEL of JAX's, and ``spec_stats`` (verify steps,
tokens emitted, groups the probe reverted) equal to JAX's. Replay runs at
temperature 0 too, so that the first token (sampled at admission) is the
same in both packages: the emitted streams and ``spec_stats`` must equal
JAX's. At temperature 1 the streams cannot equal JAX's (another random
stream); a distribution test holds the spec path's completion lengths and
log-probabilities to the plain path's over seeds. The cases mirror the JAX
package's ``tests/test_spec_sample.py``, and one GSPO step with
``spec_rollout`` replays its rollouts."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_MODEL, model_pair

from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams

ATOL_PLAIN = 1e-5  # spec vs plain, both the port's, f32 (test_torch_spec_decode.py)
BASE = (("prompt_buckets", (64,)),)
ATTRS = ("spec_warmup", "spec_probe", "spec_min_rate")


def _knobs(**kw) -> tuple:
    return tuple(sorted({**dict(BASE), **kw}.items()))


def _split(knobs: tuple):
    """(engine knobs, attributes set after construction): the spec warmup
    is 0 unless a case sets it (JAX's tests do the same)."""
    kw = dict(knobs)
    attrs = {"spec_warmup": 0, **{k: kw.pop(k) for k in ATTRS if k in kw}}
    return kw, attrs


SS = _knobs(spec_sample=True, spec_draft=4, spec_surplus=96)


@functools.cache
def _jax_engine(knobs: tuple):
    import jax.numpy as jnp

    from open_o3_video_tpu.engine import InferenceEngine as JaxEngine

    jcfg, jparams, _, _ = model_pair(0)
    kw, attrs = _split(knobs)
    engine = JaxEngine(jparams, jcfg, cache_dtype=jnp.float32, **kw)
    for k, v in attrs.items():
        setattr(engine, k, v)
    return engine


def _jax_generate(knobs: tuple, reqs, sampling, replay=None):
    from open_o3_video_tpu.engine import Request as JaxRequest
    from open_o3_video_tpu.engine import SamplingParams as JaxSampling

    engine = _jax_engine(knobs)
    before = dict(engine.spec_stats)
    outs = engine.generate([JaxRequest(input_ids=list(r.input_ids)) for r in reqs],
                           JaxSampling(**dataclasses.asdict(sampling)), return_logprobs=True,
                           replay_tokens=replay)
    return outs, {k: engine.spec_stats[k] - before[k] for k in before}


def _port(knobs: tuple) -> InferenceEngine:
    _, _, tcfg, tparams = model_pair(0)
    kw, attrs = _split(knobs)
    engine = InferenceEngine(tparams, tcfg, cache_dtype=torch.float32, **kw)
    for k, v in attrs.items():
        setattr(engine, k, v)
    return engine


def _check(knobs, reqs, sampling, replay=None, plain=True):
    """The port's spec outputs and engine, held to the JAX spec engine's
    (tokens, log-probabilities, spec_stats) and, without replay, to the
    port's plain engine's."""
    spec = _port(knobs)
    ours = spec.generate(reqs, sampling, return_logprobs=True, replay_tokens=replay)
    theirs, stats = _jax_generate(knobs, reqs, sampling, replay)
    for o, t in zip(ours, theirs):
        assert o["token_ids"] == [int(x) for x in t["token_ids"]]
        np.testing.assert_allclose(o["logprobs"], t["logprobs"], atol=ATOL_MODEL, rtol=0)
    assert spec.spec_stats == stats
    if plain and replay is None:
        base = tuple((k, v) for k, v in knobs if k not in ("spec_sample", "spec_draft",
                                                           "spec_surplus") + ATTRS)
        for o, p in zip(ours, _port(base).generate(reqs, sampling, return_logprobs=True)):
            assert o["token_ids"] == p["token_ids"]
            np.testing.assert_allclose(o["logprobs"], p["logprobs"], atol=ATOL_PLAIN, rtol=0)
    return ours, spec


def greedy(n):
    return SamplingParams(temperature=0.0, repetition_penalty=1.0, max_tokens=n)


def _reqs(*prompts):
    return [Request(list(p)) for p in prompts]


@pytest.mark.parametrize("prompt", [[5, 6, 7, 8, 9], [40, 41, 42, 43, 44, 45, 46]])
def test_single_row_temperature_0(prompt):
    _, spec = _check(SS, _reqs(prompt), greedy(24))
    assert spec.groups[0]["spec"] == "sampled" and spec.spec_stats["verify_steps"] > 0


def test_multi_row_temperature_0():
    """GSPO's shape: 4 rows decode together; one row's rejected columns
    (holes) must not leak into another's."""
    _check(SS, _reqs([5, 6, 7], [20, 21, 22, 23], [7, 7, 7, 7], [50, 51]), greedy(20))


@pytest.mark.parametrize("budget", [2, 3, 5])
def test_budget_truncation(budget):
    ours, _ = _check(SS, _reqs([7, 7, 7, 7], [5, 6, 7]), greedy(budget))
    assert all(len(o["token_ids"]) == budget for o in ours)


def test_cycling_stream_accepts_drafts():
    ours, spec = _check(SS, _reqs([7, 7, 7, 7], [7, 7, 7, 7]), greedy(40))
    assert ours[0]["token_ids"] == ours[1]["token_ids"]
    st = spec.spec_stats
    assert st["emitted"] / st["verify_steps"] > 1.2, st


def test_surplus_exhaustion_falls_back_to_plain():
    """A surplus of 10 columns: the loop runs out of room, compacts, and
    finishes on the plain ring; the tokens are the plain path's."""
    _, spec = _check(_knobs(spec_sample=True, spec_draft=4, spec_surplus=10),
                     _reqs([5, 6, 7, 8], [20, 21, 22]), greedy(32))
    assert spec.counters["compactions"] >= 1


def test_multi_wave_temperature_0():
    """10 requests through 4 slots: speculation engages once the last is
    admitted, over rows admitted at different times (histories rebuilt
    after every admission, the shared cursor bounded by compaction)."""
    prompts = ([7, 7, 7, 7], [5, 6, 7], [9, 9, 9], [4, 5, 6], [20, 21, 22], [7, 7, 7],
               [30, 31, 32], [8, 9], [11, 12, 13], [5, 5, 5])
    _, spec = _check(_knobs(spec_sample=True, spec_draft=4, spec_surplus=64, max_slots=4),
                     _reqs(*prompts), greedy(24))
    assert spec.spec_stats["verify_steps"] > 0 and spec.counters["admissions"] > 1


def _cycles(rows, reps):
    return np.stack([np.tile([10 + r, 20 + r, 30 + r], reps) for r in range(rows)])


def _random_streams(seed, rows):
    r = np.random.default_rng(seed)
    return np.stack([r.permutation(np.arange(10, 490))[:64] for _ in range(rows)])


def test_replay_emits_the_forced_streams():
    """Period-3 streams, one a row: each row emits its stream from its
    second token on, with drafts accepted (more than 1.5 tokens a verify)."""
    tr = _cycles(3, 8)
    ours, spec = _check(SS, _reqs(*[[5, 6, 7, 8]] * 3), greedy(24), replay=tr)
    for r, o in enumerate(ours):
        assert o["token_ids"][1:] == tr[r, 1:24].tolist()
    st = spec.spec_stats
    assert st["emitted"] / st["verify_steps"] > 1.5, st


def test_compaction_covers_a_whole_generation():
    """Repetition-free streams burn K1 columns a token; with a surplus of
    48 >= 47 tokens hole compaction keeps the spec loop on for every token
    (none left to the plain ring)."""
    tr = _random_streams(3, 2)
    knobs = _knobs(spec_sample=True, spec_draft=4, spec_surplus=48, spec_min_rate=0.0)
    ours, spec = _check(knobs, _reqs([5, 6, 7], [8, 9]), greedy(48), replay=tr)
    assert spec.spec_stats["emitted"] == 2 * 47 and spec.counters["compactions"] >= 1
    for r, o in enumerate(ours):
        assert o["token_ids"][1:] == tr[r, 1:48].tolist()


def test_probe_reverts_low_acceptance():
    """Repetition-free streams accept nothing: the 8-token probe measures
    ~1 token a verify a row, below spec_min_rate, and the plain ring
    finishes the group (greedy, the plain path's own tokens after the
    probe)."""
    tr = _random_streams(7, 2)
    knobs = _knobs(spec_sample=True, spec_draft=4, spec_surplus=96, spec_probe=8)
    ours, spec = _check(knobs, _reqs([5, 6, 7], [8, 9]), greedy(24), replay=tr)
    assert spec.spec_stats["probe_disabled"] == 1
    for r, o in enumerate(ours):
        assert len(o["token_ids"]) == 24 and o["token_ids"][1:8] == tr[r, 1:8].tolist()


def test_probe_keeps_high_acceptance():
    tr = _cycles(2, 12)
    knobs = _knobs(spec_sample=True, spec_draft=4, spec_surplus=96, spec_probe=8)
    ours, spec = _check(knobs, _reqs([5, 6, 7], [8, 9]), greedy(24), replay=tr)
    st = spec.spec_stats
    assert st["probe_disabled"] == 0 and st["emitted"] == sum(len(o["token_ids"]) - 1
                                                              for o in ours)


def test_warmup_defers_speculation():
    """spec_warmup = 8: the first 8 tokens of each row run the plain ring
    (real greedy tokens), then the forced streams take over at each row's
    own index."""
    tr = _cycles(2, 12)
    knobs = _knobs(spec_sample=True, spec_draft=4, spec_surplus=96, spec_warmup=8,
                   spec_min_rate=0.0)
    ours, spec = _check(knobs, _reqs([5, 6, 7], [8, 9]), greedy(24), replay=tr)
    assert 0 < spec.spec_stats["emitted"] <= 2 * (24 - 8 + 5)
    for r, o in enumerate(ours):
        assert o["token_ids"][8:] == tr[r, 8:24].tolist()


def test_temperature_1_follows_the_sequential_law():
    """Temperature 1, top-p 0.95: over 8 seeds x 4 rows, the spec path's
    mean completion length and mean per-token log-probability are those
    of the plain path within 5 standard errors (both are smooth
    functionals of the sampling law; the draws differ)."""
    samp = dict(temperature=1.0, top_p=0.95, repetition_penalty=1.0, max_tokens=12)

    def collect(engine):
        lens, lps = [], []
        for s in range(8):
            outs = engine.generate(_reqs(*[[5, 6, 7, 8]] * 4),
                                   SamplingParams(seed=1000 + s, **samp), return_logprobs=True)
            lens += [len(o["token_ids"]) for o in outs]
            lps += [x for o in outs for x in o["logprobs"]]
        return np.asarray(lens, np.float64), np.asarray(lps, np.float64)

    spec = _port(SS)
    (len_a, lp_a), (len_b, lp_b) = collect(_port(_knobs())), collect(spec)
    assert spec.spec_stats["verify_steps"] > 0
    for a, b in ((len_a, len_b), (lp_a, lp_b)):
        se = np.sqrt(a.var() / len(a) + b.var() / len(b)) + 1e-9
        assert abs(a.mean() - b.mean()) / se < 5.0, (a.mean(), b.mean())


def test_sampled_calls_are_reproducible():
    """The same seed gives the same rows, another seed other rows."""
    engine = _port(SS)
    sp = SamplingParams(temperature=1.0, top_p=1.0, repetition_penalty=1.0, max_tokens=16, seed=0)
    reqs = _reqs(*[[5, 6, 7, 8]] * 4)
    a = engine.generate(reqs, sp)
    assert engine.generate(reqs, sp) == a
    assert engine.generate(reqs, dataclasses.replace(sp, seed=1)) != a


def test_max_kv_gb_counts_the_spec_columns():
    """The budget that fits 2 slots of a plain arena but not of the spec
    arena (L + max_tokens + surplus + 2 K1 columns, JAX's
    _slots_for(extra_cols) and the scratch columns): the group runs plain
    with 2 slots, not spec with fewer slots, and within the budget. (JAX's
    gate runs the spec path there anyway, over the budget: a departure
    kept on purpose.) With room for both slots' spec arenas it runs spec."""
    _, _, tcfg, _ = model_pair(0)
    t = tcfg.text
    per_col = 2 * t.num_hidden_layers * t.num_key_value_heads * t.head_dim * 4  # f32
    L, n = 4, 16
    budget = 2.5 * per_col * (L + n) / 1e9
    engine = _port(_knobs(spec_sample=True, spec_draft=4, spec_surplus=96, max_kv_gb=budget))
    engine.generate(_reqs([5, 6, 7, 8], [1, 2, 3, 4]), greedy(n))
    assert engine.groups[0]["slots"] == 2 and engine.groups[0].get("spec") is None
    assert engine.groups[0]["arena_bytes"] <= budget * 1e9
    roomy = _port(_knobs(spec_sample=True, spec_draft=4, spec_surplus=96,
                         max_kv_gb=2.5 * per_col * (L + n + 96 + 10) / 1e9))
    roomy.generate(_reqs([5, 6, 7, 8], [1, 2, 3, 4]), greedy(n))
    assert roomy.groups[0]["slots"] == 2 and roomy.groups[0]["spec"] == "sampled"


def test_gspo_step_with_spec_rollout():
    """One PEFT GSPO step of a trainer with spec_rollout: its engine runs
    the sampled spec path, the rollouts replay the trainer's
    ``replay_tokens`` (period-3 streams, so drafts are accepted) from each
    row's second token, and the step's loss and kl are finite."""
    from open_o3_video_tpu_torch.train import gspo as TG
    from open_o3_video_tpu_torch.train.lora import LoraConfig

    _, _, tcfg, tparams = model_pair(0)
    cfg = TG.GSPOConfig(num_generations=4, max_completion_length=16, max_prompt_length=64,
                        spec_rollout=True, release_engine_memory=False)
    trainer = TG.GSPOTrainer(tparams, None, tcfg, cfg, lora=LoraConfig(),
                             detokenize=lambda ids: " ".join(map(str, ids)),
                             reward_funcs=[lambda completions, **kw: [float(len(c[0]["content"]))
                                                                      for c in completions]])
    trainer.engine.spec_warmup = 0
    trainer.replay_tokens = _cycles(4, 6)
    m = trainer.step({"input_ids": [5, 6, 7, 8, 9, 10]}, global_step=0, max_steps=1)
    assert np.isfinite(m["loss"]) and np.isfinite(m["kl"])
    for r, ids in enumerate(trainer.last_step["completion_ids"]):
        assert list(ids)[1:] == trainer.replay_tokens[r, 1:16].tolist()
    st = trainer.engine.spec_stats
    assert st["verify_steps"] > 0 and st["emitted"] / st["verify_steps"] > 1.5
