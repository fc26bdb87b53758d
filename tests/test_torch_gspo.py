"""The port's GSPO (``train/gspo.py``) against the JAX package's at tiny dims
in float32 on the CPU.

- The objective: ``gspo_objective``'s value and gradient (sequence- and
  token-level weights), ``group_advantages`` and ``completion_mask_after_eos``
  on the same numpy inputs, to 1e-6 (float32 sums in another order).
- One ``GSPOTrainer.step`` in both packages on the same weights, adapters
  (JAX's, converted, in float32 on both sides), sample (two frames through
  the processor, vision on) and canned completions: each trainer's
  ``engine.generate`` is replaced by the same token ids (an instance
  attribute; the two samplers draw from different generators) and its
  ``detokenize`` gives row r of the group the r-th canned trace. The reward
  matrix and the advantages must be equal, the metrics equal (rewards,
  lengths) or within ATOL_MODEL (loss, kl), and every updated adapter (PEFT)
  or param (full fine-tune) leaf within ATOL_MODEL, the SFT step's scheme
  (an lr at which one AdamW update is visible: 1e-2 for the adapters; 1e-3
  for the full fine-tune, where AdamW divides each gradient by its own
  magnitude, so an element whose gradient is near optax's eps of 1e-8 turns
  a float32 reordering difference of ~1e-6 of its leaf's scale into a few
  percent of lr: at 1e-3 that stays under ATOL_MODEL, and the update, ~lr,
  is 10x above it).
- The degrade contract: a truncation that chops vision placeholders runs
  text-only, as in JAX; an error in the reference-logps forward that is not
  a ``VisionInputError`` propagates instead of being retried without vision.

The tiny config's special ids are moved above the byte range (300-304),
where the ByteTokenizer's text bytes cannot collide with them.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_MODEL, frames, rng, tiny_configs

from open_o3_video_tpu_torch.data.processor import ByteTokenizer, O3VideoProcessor
from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.models.qwen25vl.model import VisionInputError
from open_o3_video_tpu_torch.train import gspo as TG
from open_o3_video_tpu_torch.train.lora import LoraConfig, adapter_leaves

CPU = torch.device("cpu")
SPECIAL_IDS = dict(vision_start_token_id=300, vision_end_token_id=301, image_token_id=303,
                   video_token_id=304)
LR = {"peft": 1e-2, "full": 1e-3}
COMPLETION_LEN = 8
# canned rollouts: EOS (1) inside row 0 and 2, row 1 at the length limit
CANNED_IDS = [[5, 6, 7, 1, 9], [8, 9, 10, 11, 12, 13, 14, 15], [20, 1], [30, 31, 32]]
TRACES = (
    "<think>The <obj>ball</obj><box>[10,12,40,44]</box>at<t>1.0</t>s rolls.</think>\n"
    "<answer>the red ball rolls away</answer>",
    "<think>A <obj>ball</obj><box>[50,50,80,80]</box>at<t>0.0</t>s.</think>\n"
    "<answer>a ball</answer>",
    "<think>hm</think><answer>nothing moves</answer>",
    "no tags at all",
)
REWARD_KWARGS = {
    "task": "temporal-spatial free-form QA",
    "answer": "the red ball rolls away",
    "key_frames": [{"time": 1.0, "idx": 0}],
    "key_items": {"0": {"ball": [[0.1, 0.2, 0.5, 0.8]]}},
    "image_size": (84, 56),
    "image_size_refine": (84, 56),
}


@functools.cache
def _configs():
    jcfg, tcfg = tiny_configs()
    return dataclasses.replace(jcfg, **SPECIAL_IDS), dataclasses.replace(tcfg, **SPECIAL_IDS)


@functools.cache
def _weights():
    from _torch_parity import jax_params_numpy

    return jax_params_numpy(_configs()[0], 0)


def _sample():
    _, tcfg = _configs()
    proc = O3VideoProcessor(tokenizer=ByteTokenizer.for_config(tcfg))
    x = proc("<|vision_start|><|image_pad|><|vision_end|>" * 2 + "What rolls?",
             images=list(frames(rng(4), 2, 56, 84)))
    return {"input_ids": x.input_ids, "pixel_patches": x.pixel_patches, "grid_thw": x.grid_thw,
            "vision_token_id": tcfg.image_token_id, "reward_kwargs": dict(REWARD_KWARGS)}


class Canned:
    """detokenize: the r-th call of each group of 4 reads TRACES[r]."""

    def __init__(self):
        self.calls = 0

    def __call__(self, ids):
        self.calls += 1
        return TRACES[(self.calls - 1) % len(TRACES)]


def _generate(*_args, **_kw):
    return [{"token_ids": list(ids), "num_prompt_tokens": 0} for ids in CANNED_IDS]


def _recording(fns, record):
    """The reward functions, each recording what it returns (same names)."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(**kw):
            out = fn(**kw)
            record.setdefault(fn.__name__, []).append(list(out))
            return out
        return inner

    return [wrap(fn) for fn in fns]


def _gspo_cfg(cls, peft=True, **kw):
    return cls(num_generations=4, max_completion_length=COMPLETION_LEN, max_prompt_length=512,
               learning_rate=LR["peft" if peft else "full"], **kw)


def _jax_step(peft: bool, **cfg_kw):
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.grounding.rewards import REWARD_REGISTRY
    from open_o3_video_tpu.train import gspo as JG
    from open_o3_video_tpu.train import lora as JL

    jcfg, _ = _configs()
    params = jax.tree.map(jnp.asarray, _weights())
    record = {}
    trainer = JG.GSPOTrainer(
        params, None if peft else jax.tree.map(jnp.asarray, _weights()), jcfg,
        _gspo_cfg(JG.GSPOConfig, peft, **cfg_kw), detokenize=Canned(),
        reward_funcs=_recording(REWARD_REGISTRY.values(), record),
        lora=JL.LoraConfig(rank=4, alpha=8.0) if peft else None)
    if peft:  # float32 adapters on both sides (JAX draws them in bf16)
        trainer.adapters = jax.tree.map(lambda x: x.astype(jnp.float32), trainer.adapters)
        trainer.opt_state = trainer.optimizer.init(trainer.adapters)
    start = jax.tree.map(np.asarray, trainer.adapters if peft else params)
    trainer.engine.generate = _generate
    m = trainer.step(_sample(), global_step=0, max_steps=4)
    out = jax.tree.map(np.asarray, trainer.adapters if peft else trainer.params)
    return m, record, start, out


def _port_step(peft: bool, start, **cfg_kw):
    from open_o3_video_tpu_torch.grounding.rewards import REWARD_REGISTRY

    _, tcfg = _configs()
    params = TP.from_jax_params(_weights(), tcfg, CPU)
    ref = None if peft else TP.from_jax_params(_weights(), tcfg, CPU)
    record = {}
    trainer = TG.GSPOTrainer(params, ref, tcfg, _gspo_cfg(TG.GSPOConfig, peft, **cfg_kw),
                             detokenize=Canned(),
                             reward_funcs=_recording(REWARD_REGISTRY.values(), record),
                             lora=LoraConfig(rank=4, alpha=8.0) if peft else None)
    if peft:
        trainer.adapters = TP.adapters_from_jax(start, CPU)
        trainer.opt_state = trainer.optimizer.init(adapter_leaves(trainer.adapters))
    trainer.engine.generate = _generate
    m = trainer.step(_sample(), global_step=0, max_steps=4)
    return m, record, trainer


@pytest.mark.parametrize("mode", ["peft", "full"])
def test_step_matches_jax(mode):
    import jax

    from open_o3_video_tpu.train import gspo as JG

    peft = mode == "peft"
    jm, jrec, start, jout = _jax_step(peft)
    tm, trec, trainer = _port_step(peft, start)
    assert trainer.last_step["use_vision"] and trainer.last_step["n_degraded"] == 0
    assert trec == jrec  # every reward of every row, float for float
    rewards = np.asarray([jrec[k][0] for k in jrec], np.float32).T.sum(1)
    np.testing.assert_array_equal(trainer.last_step["advantages"], JG.group_advantages(rewards, 4))
    assert np.ptp(trainer.last_step["advantages"]) > 1  # the canned traces differ in reward
    assert tm.keys() == jm.keys()
    for key in tm:
        if key in ("loss", "kl"):
            np.testing.assert_allclose(tm[key], float(jm[key]), atol=ATOL_MODEL, err_msg=key)
        else:
            assert tm[key] == float(jm[key]), key
    assert tm["completion_length"] == (4 + 8 + 2 + 3) / 4  # through the first EOS
    ours = TP.to_jax_layout(trainer.adapters if peft else trainer.params)
    flat_o, flat_t = jax.tree.leaves_with_path(ours), jax.tree.leaves_with_path(jout)
    assert [p for p, _ in flat_o] == [p for p, _ in flat_t]
    moved = 0
    for (path, a), (_, b), (_, s) in zip(flat_o, flat_t, jax.tree.leaves_with_path(start)):
        np.testing.assert_allclose(a, b, atol=ATOL_MODEL, err_msg=jax.tree_util.keystr(path))
        moved += int((np.abs(a - s) > LR[mode] / 2).sum())
    assert moved > 0  # the update is visible
    if peft:  # the base stayed as it was, frozen
        base = TP.to_jax_layout(trainer.params)
        for a, b in zip(jax.tree.leaves(base), jax.tree.leaves(_weights())):
            np.testing.assert_array_equal(a, b)
        assert not any(x.requires_grad for x in TP.leaves(trainer.params))


def test_token_level_grpo_step_matches_jax():
    """gspo=False: token-level importance weights, one PEFT step."""
    jm, _, start, jout = _jax_step(True, gspo=False)
    tm, _, trainer = _port_step(True, start, gspo=False)
    import jax

    np.testing.assert_allclose(tm["loss"], float(jm["loss"]), atol=ATOL_MODEL)
    for a, b in zip(jax.tree.leaves(TP.to_jax_layout(trainer.adapters)), jax.tree.leaves(jout)):
        np.testing.assert_allclose(a, b, atol=ATOL_MODEL)


@pytest.mark.parametrize("gspo", [True, False])
def test_objective_value_and_gradient_match_jax(gspo):
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.train import gspo as JG

    r = rng(11)
    G, L = 4, 12
    logps = r.normal(-2.0, 1.0, (G, L)).astype(np.float32)
    refs = (logps + r.normal(0, 0.5, (G, L))).astype(np.float32)
    refs[0, 0] = logps[0, 0] + 30  # the KL clamp at +10
    mask = (r.random((G, L)) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    mask[3] = 0  # an empty row: denominator clamped to 1
    adv = r.normal(0, 1.5, (G,)).astype(np.float32)
    jcfg, tcfg = JG.GSPOConfig(gspo=gspo), TG.GSPOConfig(gspo=gspo)

    def jloss(lp):
        return JG.gspo_objective(lp, jnp.asarray(refs), jnp.asarray(mask), jnp.asarray(adv), jcfg)

    (jl, jkl), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logps))
    lp = torch.from_numpy(logps).requires_grad_()
    tl, tkl = TG.gspo_objective(lp, torch.from_numpy(refs), torch.from_numpy(mask),
                                torch.from_numpy(adv), tcfg)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tkl.detach()), float(jkl), rtol=1e-6)
    np.testing.assert_allclose(lp.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-7)


def test_advantages_and_completion_mask_match_jax():
    from open_o3_video_tpu.train import gspo as JG

    r = rng(2)
    rewards = r.random(12).astype(np.float32) * 3
    rewards[4:8] = 1.5  # a group of equal rewards: advantages 0
    np.testing.assert_array_equal(TG.group_advantages(rewards, 4), JG.group_advantages(rewards, 4))
    assert not TG.group_advantages(rewards, 4)[4:8].any()
    ids = r.integers(0, 6, (5, 9))
    ids[4] = 3  # no EOS
    for eos in (0, 1, 3):
        np.testing.assert_array_equal(TG.completion_mask_after_eos(ids, eos),
                                      JG.completion_mask_after_eos(ids, eos))
    assert dataclasses.asdict(TG.GSPOConfig()) == {
        k: v for k, v in dataclasses.asdict(JG.GSPOConfig()).items()}


def test_truncation_that_chops_vision_degrades_to_text_only(capsys):
    """A prompt whose left-truncation chops vision placeholders runs
    text-only (JAX's TestReviewRegressions case)."""
    _, tcfg = _configs()
    sample = _sample()
    sample["input_ids"] = sample["input_ids"] + list(range(5, 45))
    trainer = TG.GSPOTrainer(TP.from_jax_params(_weights(), tcfg, CPU), None, tcfg,
                             TG.GSPOConfig(max_completion_length=4, max_prompt_length=40),
                             detokenize=lambda ids: "<answer>x</answer>", lora=LoraConfig(rank=2))
    trainer.engine.generate = _generate
    m = trainer.step(sample, global_step=0, max_steps=2)
    assert np.isfinite(m["loss"])
    assert "degrading sample to text-only" in capsys.readouterr().out
    assert trainer.last_step["n_degraded"] == 1 and not trainer.last_step["use_vision"]


def test_only_vision_errors_are_retried_without_vision(monkeypatch, capsys):
    """The reference-logps forward retries text-only on a VisionInputError
    (the reference's degraded recompute) and on nothing else: a failed
    kernel must not be hidden by a run without vision."""
    _, tcfg = _configs()
    real = TG.completion_logps

    def trainer():
        t = TG.GSPOTrainer(TP.from_jax_params(_weights(), tcfg, CPU), None, tcfg,
                           TG.GSPOConfig(max_completion_length=4), detokenize=Canned(),
                           lora=LoraConfig(rank=2))
        t.engine.generate = _generate
        return t

    def vision_fails(*args, **kw):
        if kw.get("pixel_patches") is not None:
            raise VisionInputError("4 patches for grids of 8")
        return real(*args, **kw)

    monkeypatch.setattr(TG, "completion_logps", vision_fails)
    t = trainer()
    m = t.step(_sample(), global_step=0, max_steps=2)  # the update runs text-only too
    assert np.isfinite(m["loss"]) and not t.last_step["use_vision"]
    assert "retrying without vision" in capsys.readouterr().out

    def kernel_fails(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(TG, "completion_logps", kernel_fails)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        trainer().step(_sample(), global_step=0, max_steps=2)
    assert "retrying without vision" not in capsys.readouterr().out
    with pytest.raises(VisionInputError):
        from open_o3_video_tpu_torch.models.qwen25vl.model import forward

        s = _sample()
        forward(TP.from_jax_params(_weights(), tcfg, CPU), tcfg, torch.zeros((1, 4), dtype=torch.long),
                torch.zeros((3, 1, 4), dtype=torch.long),
                pixel_patches=torch.from_numpy(s["pixel_patches"][:-4]), grid_thw=s["grid_thw"])


def test_constructor_refuses_what_is_not_ported():
    """A mesh that is not a ``parallel.Mesh`` raises (GSPO on a mesh is
    ``test_torch_train_mesh.py``'s); ``spec_rollout`` is served (the
    engine's sampled speculative path, as the JAX trainer maps it), with no
    replay."""
    _, tcfg = _configs()
    params = TP.from_jax_params(_weights(), tcfg, CPU)
    with pytest.raises(TypeError, match="mesh"):
        TG.GSPOTrainer(params, None, tcfg, TG.GSPOConfig(), detokenize=str, mesh=object(),
                       lora=LoraConfig())
    trainer = TG.GSPOTrainer(params, None, tcfg, TG.GSPOConfig(spec_rollout=True),
                             detokenize=str, lora=LoraConfig())
    assert trainer.engine.spec_sample and not trainer.engine.spec_decode
    assert trainer.replay_tokens is None


def test_rollout_after_a_full_fine_tune_step_rebuilds_its_prefix_block():
    """Full fine-tune: the optimizer updates the params in place and the
    trainer hands the engine the same dict before each rollout. The G = 4
    copies of the prompt share a prefix block (the engine's
    prefix_cache_min lowered to the tiny prompt); the second step's rollout
    builds a new block instead of serving the one prefilled under the
    first step's weights, and its tokens equal those of a fresh engine on
    the updated weights."""
    from open_o3_video_tpu_torch.engine import InferenceEngine
    from open_o3_video_tpu_torch.grounding.rewards import REWARD_REGISTRY

    _, tcfg = _configs()
    params = TP.from_jax_params(_weights(), tcfg, CPU)
    ref = TP.from_jax_params(_weights(), tcfg, CPU)
    trainer = TG.GSPOTrainer(params, ref, tcfg, _gspo_cfg(TG.GSPOConfig, peft=False),
                             detokenize=Canned(), reward_funcs=list(REWARD_REGISTRY.values()))
    trainer.engine.prefix_cache_min = 8
    rollouts, counters = [], []
    generate = trainer.engine.generate

    def recorded(reqs, sampling, **kw):
        before = dict(trainer.engine.counters)
        outs = generate(reqs, sampling, **kw)
        counters.append({k: trainer.engine.counters[k] - before.get(k, 0)
                         for k in ("prefix_blocks", "prefix_hits")})
        # a fresh engine on the weights as they are now, before this step's update
        fresh = InferenceEngine(trainer.params, tcfg, prefix_cache_min=8)
        rollouts.append((reqs, [o["token_ids"] for o in outs],
                         [o["token_ids"] for o in fresh.generate(reqs, sampling)]))
        return outs

    trainer.engine.generate = recorded
    first = [x.detach().clone() for x in trainer.trained_leaves()]
    for step in range(2):
        trainer.step(_sample(), global_step=step, max_steps=4)
    assert any(not torch.equal(a, b) for a, b in zip(first, trainer.trained_leaves()))
    assert counters == [{"prefix_blocks": 1, "prefix_hits": 0}] * 2
    reqs, tokens, fresh_tokens = rollouts[1]
    assert len(reqs) == 4 and len({id(r) for r in reqs}) == 1
    assert tokens == fresh_tokens and tokens != rollouts[0][1]
