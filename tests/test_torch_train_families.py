"""Training Qwen3-VL (dense) and Qwen2-VL in the port against the JAX package
at tiny dims in float32 on the CPU (``tiny_qwen3``: LayerNorm/GELU tower,
interpolated position embeddings, deepstack mergers, qk-norm and explicit
head_dim, interleaved M-RoPE; ``tiny_qwen2``: whole-frame QuickGELU tower).
Every test is parametrised over both families.

- SFT (``train/sft.py``): the loss and every gradient leaf (tower, deepstack
  mergers, decoder, embeddings, lm_head) against JAX's ``sft_loss`` under
  ``jax.value_and_grad``; remat equal to no remat; one ``make_train_step``
  and one ``make_lora_train_step`` step against JAX's, on the two-example
  batch of ``test_torch_sft.py``'s shape, collated through a processor at
  the config's patch size with the family's label mask.
- GSPO (``train/gspo.py``): one PEFT step and one full fine-tune step
  against JAX's ``GSPOTrainer`` on canned rollouts, as ``test_torch_gspo.py``
  holds Qwen2.5-VL.
- Checkpoints: a full fine-tune restored from step 1 takes step 2 bit for
  bit (deterministic algorithms); the export of a trained Qwen3-VL reads in
  JAX's ``load_pretrained`` under the family's HF names.
- ``require_trainable`` passes every family (the MoE families and Aria
  too) and refuses only an unknown ``model_type``; ``sft_main`` and ``grpo_main`` train Qwen2-VL on the CPU when
  asked and refuse a Qwen3-VL checkpoint (patch 16), whose frames their
  patch-14 processor cannot cut.

Tolerances: ATOL_MODEL (1e-4) for losses, updated weights and each gradient
leaf at its own scale (float32 sums in another order through two whole
models; measured ~1.5e-6 of the leaf's scale); the gradient norm to 1e-5
relative. The special ids are moved to 300-304, above the ByteTokenizer's
byte range (as in ``test_torch_gspo.py``).
"""

import dataclasses
import functools
import json
import types

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_MODEL, frames, jax_params_numpy, port_reader, rng  # noqa: F401

from open_o3_video_tpu_torch.data import sft_dataset as tdata
from open_o3_video_tpu_torch.data.processor import ByteTokenizer, O3VideoProcessor
from open_o3_video_tpu_torch.models.qwen25vl import config as TC
from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.train import checkpoint as CK
from open_o3_video_tpu_torch.train import gspo as TG
from open_o3_video_tpu_torch.train import sft as tsft
from open_o3_video_tpu_torch.train.lora import LoraConfig, adapter_leaves

CPU = torch.device("cpu")
FAMILIES = ["tiny_qwen3", "tiny_qwen2"]
SPECIAL_IDS = dict(vision_start_token_id=300, vision_end_token_id=301, image_token_id=303,
                   video_token_id=304)
# lr 1e-2 so one AdamW update shows in the weights (1e-3 for GSPO's full
# fine-tune, as test_torch_gspo.py explains); a logp chunk below the
# sequence length, so both packages take their chunked lm_head.
LR, LOGP_CHUNK, LORA_SCALE = 1e-2, 64, 2.0
GSPO_LR = {"peft": 1e-2, "full": 1e-3}
EXAMPLES = [
    ("What moves?", "<think>A <obj>ball</obj><box>[1,2,30,40]</box>at<t>0.5</t>s rolls."
                    "</think>\n<answer>the ball</answer>"),
    ("Who?", "<think>none</think>\n<answer>no one</answer>"),
]


@functools.cache
def _family(name):
    """(JAX config, port config, JAX's random init as numpy) of a family."""
    from open_o3_video_tpu.models.qwen25vl import config as JC

    jcfg = dataclasses.replace(getattr(JC, name)(), **SPECIAL_IDS)
    tcfg = dataclasses.replace(getattr(TC, name)(), **SPECIAL_IDS)
    return jcfg, tcfg, jax_params_numpy(jcfg, 0)


def _jax_params(name):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, _family(name)[2])


def _port_params(name, trainable=True):
    """A fresh copy of the port's params (training updates in place)."""
    _, tcfg, tree = _family(name)
    params = TP.from_jax_params(tree, tcfg, CPU)
    return TP.trainable(params) if trainable else params


def _processor(tcfg):
    return O3VideoProcessor(tokenizer=ByteTokenizer.for_config(tcfg),
                            patch_size=tcfg.vision.patch_size)


def _messages(question, answer):
    return [
        {"role": "system", "content": [{"type": "text", "text": "Answer from the video."}]},
        {"role": "user", "content": [{"type": "video", "video": "clip.mp4"},
                                     {"type": "text", "text": question}]},
        {"role": "assistant", "content": [{"type": "text", "text": answer}]},
    ]


@functools.cache
def _batch(name):
    _, tcfg, _ = _family(name)
    proc, r = _processor(tcfg), rng(3)
    singles = [tdata.collate_sft_frames(_messages(q, a), list(frames(r, 2, 56, 84)), 2.0, proc,
                                        tcfg)
               for q, a in EXAMPLES]
    return tdata.pack_sft_batch(singles, tcfg, pad_multiple=16)


def _jax_batch(batch):
    import jax.numpy as jnp

    return {k: (v if k in ("grid_thw", "vision_token_id") else jnp.asarray(v))
            for k, v in batch.items()}


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grads(v) for v in tree]
    return tree.grad


def _assert_trees_close(ours, theirs, atol=None):
    """Leaf by leaf, same paths; each leaf to ``atol`` or, where None, to
    ATOL_MODEL at its own scale."""
    import jax

    flat_o, flat_t = jax.tree.leaves_with_path(ours), jax.tree.leaves_with_path(theirs)
    assert [p for p, _ in flat_o] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_o, flat_t):
        b = np.asarray(b)
        tol = ATOL_MODEL * np.abs(b).max() if atol is None else atol
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=jax.tree_util.keystr(path))


def test_batch_masks_the_family_visual_tokens_as_jax_does():
    """Qwen2-VL masks vision_start/vision_end/video_pad, Qwen3-VL the image
    token; both batches as JAX's pack_sft_batch makes them."""
    from open_o3_video_tpu.data import sft_dataset as jdata

    for name in FAMILIES:
        jcfg, tcfg, _ = _family(name)
        assert tdata.visual_mask_ids(tcfg) == jdata.visual_mask_ids(jcfg)
        batch = _batch(name)
        labels, ids = batch["labels"], batch["input_ids"]
        masked = np.isin(ids, tdata.visual_mask_ids(tcfg))
        assert masked.any() and (labels[masked] == tdata.IGNORE_INDEX).all()
        singles = [tdata.collate_sft_frames(_messages(q, a), list(frames(r, 2, 56, 84)), 2.0,
                                            _processor(tcfg), tcfg)
                   for r in [rng(3)] for q, a in EXAMPLES]
        want = jdata.pack_sft_batch(singles, jcfg, pad_multiple=16)
        for key in batch:
            np.testing.assert_array_equal(batch[key], want[key], err_msg=key)


@functools.cache
def _jax_train_step(name):
    """JAX's ``make_train_step`` on the family's batch, its optimizer
    chained after a transformation that keeps the raw gradients as its
    state (so one compile gives the gradients and the step): (metrics, the
    gradients, the updated params), numpy."""
    import jax
    import jax.numpy as jnp
    import optax

    from open_o3_video_tpu.train import sft as jsft

    def keep_grads():
        return optax.GradientTransformation(
            lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, _, p=None: (g, g))

    jcfg = _family(name)[0]
    jtrain = jsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
    opt = optax.chain(keep_grads(), jsft.make_optimizer(jtrain))
    params = _jax_params(name)
    new, state, m = jsft.make_train_step(jcfg, jtrain, opt)(params, opt.init(params),
                                                          _jax_batch(_batch(name)))
    return ({k: np.asarray(v) for k, v in m.items()}, jax.tree.map(np.asarray, state[0]),
            jax.tree.map(np.asarray, new))


@pytest.mark.parametrize("name", FAMILIES)
def test_sft_loss_and_every_gradient_match_jax(name):
    import jax

    _, tcfg, _ = _family(name)
    jm, jgrads, _ = _jax_train_step(name)
    params = _port_params(name)
    m = tsft.loss_and_grads(params, tcfg, tsft.SFTConfig(logp_chunk=LOGP_CHUNK), _batch(name))
    assert int(m["num_target_tokens"]) == int(jm["num_target_tokens"]) > 0
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=ATOL_MODEL)
    ours = TP.to_jax_layout(_grads(params))
    _assert_trees_close(ours, jgrads)
    # every vision leaf gets a gradient, the deepstack mergers' among them
    vis = jax.tree.leaves(ours["visual"])
    assert all(np.abs(g).max() > 0 for g in vis)
    assert len(ours["visual"].get("deepstack", [])) == len(tcfg.vision.deepstack_visual_indexes)
    jnorm = float(np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in jax.tree.leaves(jgrads))))
    np.testing.assert_allclose(float(m["grad_norm"]), jnorm, rtol=1e-5)


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_gives_the_same_gradients(name):
    _, tcfg, _ = _family(name)
    out = []
    for remat in (True, False):
        params = _port_params(name)
        m = tsft.loss_and_grads(params, tcfg, tsft.SFTConfig(gradient_checkpointing=remat,
                                                             logp_chunk=LOGP_CHUNK), _batch(name))
        out.append((float(m["loss"]), TP.leaves(_grads(params))))
    (l1, g1), (l2, g2) = out
    assert l1 == l2
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)


@pytest.mark.parametrize("name", FAMILIES)
def test_one_step_matches_jax_make_train_step(name):
    import jax

    _, tcfg, tree = _family(name)
    jm, _, jnew = _jax_train_step(name)
    train_cfg = tsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
    opt = tsft.make_optimizer(train_cfg)
    params = _port_params(name)
    params, state, m = tsft.make_train_step(tcfg, train_cfg, opt)(params, opt.init(params),
                                                                  _batch(name))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    assert state["count"] == 1
    ours = TP.to_jax_layout(params)
    _assert_trees_close(ours, jnew, atol=ATOL_MODEL)
    moved = sum(int((np.abs(a - b) > LR / 2).sum())
                for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(tree)))
    assert moved > 0


def _adapter_tree(params, rank=4):
    """JAX's adapter layout over q_w and v_w of every decoder layer, float32
    numpy, A and B random (so both get gradients); the widths from the
    port's leaves (Qwen3-VL's q_w is heads * head_dim wide, not hidden)."""
    r = rng(17)
    out = []
    for layer in params["text"]["layers"]:
        entry = {}
        for name in ("q_w", "v_w"):
            d_in, d_out = layer[name].shape
            entry[name] = {"a": r.standard_normal((d_in, rank)).astype(np.float32) * 0.1,
                           "b": r.standard_normal((rank, d_out)).astype(np.float32) * 0.1}
        out.append(entry)
    return {"layers": out}


@pytest.mark.parametrize("name", FAMILIES)
def test_one_peft_step_matches_jax_make_lora_train_step(name):
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.train import sft as jsft

    jcfg, tcfg, _ = _family(name)
    base = _port_params(name, trainable=False)
    before = [x.clone() for x in TP.leaves(base)]
    tree = _adapter_tree(base)
    jtrain = jsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
    jopt = jsft.make_optimizer(jtrain)
    jad = jax.tree.map(jnp.asarray, tree)
    jnew, _, jm = jsft.make_lora_train_step(jcfg, jtrain, jopt, LORA_SCALE)(
        jad, jopt.init(jad), _jax_batch(_batch(name)), _jax_params(name))

    adapters = TP.adapters_from_jax(tree, CPU)
    train_cfg = tsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
    opt = tsft.make_optimizer(train_cfg)
    step = tsft.make_lora_train_step(tcfg, train_cfg, opt, LORA_SCALE)
    adapters, state, m = step(adapters, opt.init(adapter_leaves(adapters)), _batch(name), base)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=ATOL_MODEL, rtol=0)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    ours = {"layers": [{n: {k: x.detach().numpy() for k, x in ab.items()} for n, ab in l.items()}
                       for l in adapters["layers"]]}
    _assert_trees_close(ours, jax.tree.map(np.asarray, jnew), atol=ATOL_MODEL)
    moved = sum(int((np.abs(a - b) > LR / 2).sum())
                for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(tree)))
    assert moved > 0
    for x, y in zip(TP.leaves(base), before):  # the base frozen, bit for bit
        assert x.grad is None and not x.requires_grad and torch.equal(x, y)


# ---- GSPO ----------------------------------------------------------------


def _gspo_sample(tcfg):
    from test_torch_gspo import REWARD_KWARGS

    proc = _processor(tcfg)
    x = proc("<|vision_start|><|image_pad|><|vision_end|>" * 2 + "What rolls?",
             images=list(frames(rng(4), 2, 56, 84)))
    return {"input_ids": x.input_ids, "pixel_patches": x.pixel_patches, "grid_thw": x.grid_thw,
            "vision_token_id": tcfg.image_token_id, "reward_kwargs": dict(REWARD_KWARGS)}


def _gspo_cfg(cls, mode):
    from test_torch_gspo import COMPLETION_LEN

    return cls(num_generations=4, max_completion_length=COMPLETION_LEN, max_prompt_length=512,
               learning_rate=GSPO_LR[mode])


def _jax_gspo_step(name, mode):
    import jax
    import jax.numpy as jnp
    from test_torch_gspo import Canned, _generate, _recording

    from open_o3_video_tpu.grounding.rewards import REWARD_REGISTRY
    from open_o3_video_tpu.train import gspo as JG
    from open_o3_video_tpu.train import lora as JL

    jcfg, tcfg, _ = _family(name)
    peft, record = mode == "peft", {}
    trainer = JG.GSPOTrainer(
        _jax_params(name), None if peft else _jax_params(name), jcfg, _gspo_cfg(JG.GSPOConfig, mode),
        detokenize=Canned(), reward_funcs=_recording(REWARD_REGISTRY.values(), record),
        lora=JL.LoraConfig(rank=4, alpha=8.0) if peft else None)
    if peft:  # float32 adapters on both sides (JAX draws them in bf16)
        trainer.adapters = jax.tree.map(lambda x: x.astype(jnp.float32), trainer.adapters)
        trainer.opt_state = trainer.optimizer.init(trainer.adapters)
    start = jax.tree.map(np.asarray, trainer.adapters if peft else trainer.params)
    trainer.engine.generate = _generate
    m = trainer.step(_gspo_sample(tcfg), global_step=0, max_steps=4)
    return m, record, start, jax.tree.map(np.asarray, trainer.adapters if peft else trainer.params)


@pytest.mark.parametrize("mode", ["peft", "full"])
@pytest.mark.parametrize("name", FAMILIES)
def test_gspo_step_matches_jax(name, mode):
    import jax
    from test_torch_gspo import Canned, _generate, _recording

    from open_o3_video_tpu_torch.grounding.rewards import REWARD_REGISTRY

    peft = mode == "peft"
    jm, jrec, start, jout = _jax_gspo_step(name, mode)
    _, tcfg, _ = _family(name)
    record = {}
    trainer = TG.GSPOTrainer(_port_params(name, trainable=False),
                             None if peft else _port_params(name, trainable=False), tcfg,
                             _gspo_cfg(TG.GSPOConfig, mode), detokenize=Canned(),
                             reward_funcs=_recording(REWARD_REGISTRY.values(), record),
                             lora=LoraConfig(rank=4, alpha=8.0) if peft else None)
    if peft:
        trainer.adapters = TP.adapters_from_jax(start, CPU)
        trainer.opt_state = trainer.optimizer.init(adapter_leaves(trainer.adapters))
    trainer.engine.generate = _generate
    tm = trainer.step(_gspo_sample(tcfg), global_step=0, max_steps=4)
    assert trainer.last_step["use_vision"] and trainer.last_step["n_degraded"] == 0
    assert record == jrec  # every reward of every row, float for float
    assert tm.keys() == jm.keys()
    for key in tm:
        if key in ("loss", "kl"):
            np.testing.assert_allclose(tm[key], float(jm[key]), atol=ATOL_MODEL, err_msg=key)
        else:
            assert tm[key] == float(jm[key]), key
    ours = TP.to_jax_layout(trainer.adapters if peft else trainer.params)
    _assert_trees_close(ours, jout, atol=ATOL_MODEL)
    moved = sum(int((np.abs(a - s) > GSPO_LR[mode] / 2).sum())
                for a, s in zip(jax.tree.leaves(ours), jax.tree.leaves(start)))
    assert moved > 0
    if peft:  # the base frozen, bit for bit
        for a, b in zip(jax.tree.leaves(TP.to_jax_layout(trainer.params)),
                        jax.tree.leaves(_family(name)[2])):
            np.testing.assert_array_equal(a, b)


# ---- checkpoints, the refusals and the apps --------------------------------


@pytest.fixture
def deterministic():
    """Deterministic kernels (on the CPU the embedding's backward otherwise
    sums repeated tokens' rows in thread order)."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("name", FAMILIES)
def test_restored_checkpoint_repeats_the_step(name, tmp_path, deterministic):
    """Full fine-tune: step 1, a checkpoint, step 2; a fresh copy restored
    from step 1 takes step 2 bit for bit (loss, gradient norm, weights)."""
    _, tcfg, _ = _family(name)
    train_cfg = tsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
    opt = tsft.make_optimizer(train_cfg)
    step = tsft.make_train_step(tcfg, train_cfg, opt)
    a = _port_params(name)
    state = opt.init(a)
    a, state, _ = step(a, state, _batch(name))
    CK.save_checkpoint(str(tmp_path), 1, {"params": a, "opt_state": state, "meta": {"step": 1}})
    a, state, want = step(a, state, _batch(name))

    b = _port_params(name)
    target = {"params": b, "opt_state": opt.init(b), "meta": {"step": 0}}
    restored, at = CK.restore_checkpoint(str(tmp_path), 1, target=target)
    assert at == 1 and restored["opt_state"]["count"] == 1
    b, _, got = step(b, restored["opt_state"], _batch(name))
    assert float(got["loss"]) == float(want["loss"])
    assert float(got["grad_norm"]) == float(want["grad_norm"])
    for x, y in zip(TP.leaves(a), TP.leaves(b)):
        assert torch.equal(x, y)


def test_trained_qwen3vl_exports_under_its_hf_names(tmp_path):
    """One step of the tiny Qwen3-VL, exported: JAX's load_pretrained reads
    the same weights (the deepstack mergers' HF names included)."""
    import jax

    from open_o3_video_tpu.models.qwen25vl import params as JP

    jcfg, tcfg, _ = _family("tiny_qwen3")
    train_cfg = tsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
    opt = tsft.make_optimizer(train_cfg)
    params = _port_params("tiny_qwen3")
    params, _, _ = tsft.make_train_step(tcfg, train_cfg, opt)(params, opt.init(params),
                                                              _batch("tiny_qwen3"))
    CK.export_safetensors(params, tcfg, str(tmp_path))
    loaded, _ = JP.load_pretrained(str(tmp_path), cfg=jcfg)
    _assert_trees_close(jax.tree.map(np.asarray, loaded), TP.to_jax_layout(params), atol=0)


def test_require_trainable_passes_every_family_and_refuses_an_unknown_type():
    """Every family a model module reads trains (the MoE families since
    their training was ported, tests/test_torch_train_moe.py); only a
    model_type no family reads is refused."""
    from open_o3_video_tpu_torch.models import aria as TA

    for cfg in (TC.tiny_qwen3(), TC.tiny_qwen2(), TC.Qwen25VLConfig.tiny(), TC.tiny_qwen3_moe(),
                TC.Qwen25VLConfig.from_hf_dict(TC.QWEN3_VL_30B_A3B_INSTRUCT_CONFIG),
                TA.tiny_aria(), TA.AriaConfig.from_hf_dict(TA.ARIA_CONFIG),
                types.SimpleNamespace(model_type="qwen3_vl",
                                      text=types.SimpleNamespace(moe_num_experts=8))):
        tsft.require_trainable(cfg)
    for cfg in (types.SimpleNamespace(model_type="llava"), types.SimpleNamespace()):
        with pytest.raises(NotImplementedError, match="no model family"):
            tsft.require_trainable(cfg)


@pytest.fixture(scope="module")
def qwen2vl_apps(tmp_path_factory):
    """A float32 tiny Qwen2-VL checkpoint with the Qwen vocabulary (the
    ByteTokenizer's special ids live there), the SFT data of
    ``_torch_sft_data.py`` and a 4-example RL dataset over its AVI."""
    from _torch_sft_data import EXAMPLES as SFT_EXAMPLES
    from _torch_sft_data import write_sft_data

    root = tmp_path_factory.mktemp("qwen2vl_apps")
    base = TC.tiny_qwen2()
    cfg = dataclasses.replace(
        base, eos_token_id=151645, pad_token_id=151643, bos_token_id=151643,
        **{k: getattr(TC.Qwen25VLConfig(), k) for k in SPECIAL_IDS},
        text=dataclasses.replace(base.text, vocab_size=152064))
    CK.export_safetensors(TP.init(cfg, 0, CPU), cfg, str(root / "model"))
    write_sft_data(root)
    (root / "sft.json").write_text(json.dumps([SFT_EXAMPLES[2], SFT_EXAMPLES[3]]))
    rl = [{"task": "temporal QA", "source": "TVG_r1", "video_path": SFT_EXAMPLES[2]["video_path"],
           "question": f"When does it move ({i})?", "answer": "[0.0, 1.0]"} for i in range(4)]
    (root / "rl.json").write_text(json.dumps(rl))
    return root


def test_apps_train_qwen2vl_on_the_cpu_and_refuse_qwen3vl(qwen2vl_apps, tmp_path, capsys,
                                                          port_reader):
    """sft_main (full fine-tune) and grpo_main (PEFT) take a step of the tiny
    Qwen2-VL on the CPU and export it; a Qwen3-VL checkpoint (patch 16)
    is refused by both, naming the apps' patch-14 processor."""
    from open_o3_video_tpu_torch.train import grpo_main, sft_main

    port_reader("cv2")
    root = qwen2vl_apps
    common = ["--model_name_or_path", str(root / "model"), "--data_root", str(root / "data"),
              "--nframes", "2", "--max_steps", "1", "--device", "cpu"]
    sft_main.main([*common, "--dataset_name", str(root / "sft.json"), "--output_dir",
                   str(tmp_path / "sft"), "--bf16", "false"])
    grpo_main.main([*common, "--dataset_name", str(root / "rl.json"), "--output_dir",
                    str(tmp_path / "grpo"), "--use_peft", "--lora_r", "2",
                    "--max_completion_length", "4"])
    printed = capsys.readouterr().out
    assert "SFT complete: 1 steps" in printed and "GSPO complete: 1 steps" in printed
    for run in ("sft", "grpo"):
        loaded, cfg = TP.load_pretrained(str(tmp_path / run), CPU)
        assert cfg.model_type == "qwen2_vl"
        assert all(torch.isfinite(x).all() for x in TP.leaves(loaded))
    q3 = TC.Qwen25VLConfig.from_hf_dict(TC.QWEN3_VL_8B_INSTRUCT_CONFIG)
    (tmp_path / "q3").mkdir()
    (tmp_path / "q3/config.json").write_text(json.dumps(q3.to_hf_dict()))
    for main in (sft_main.main, grpo_main.main):
        with pytest.raises(NotImplementedError, match="patch 14"):
            main(["--model_name_or_path", str(tmp_path / "q3"), "--device", "cpu",
                  "--dataset_name", str(root / "sft.json"), "--data_root", str(root / "data"),
                  "--output_dir", str(tmp_path / "out")])
