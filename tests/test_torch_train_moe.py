"""Training the mixture-of-experts families in the port against the JAX
package at tiny dims in float32 on the CPU: ``tiny_qwen3_moe`` (the tiny
Qwen3-VL tower and decoder with 4 routed experts, top 2, softmax -> top-k
-> renormalised) and ``tiny_aria`` (a 2-block SigLIP tower, the
cross-attention projector, 4 routed experts, top 2, and 2 shared experts).
Every test but the last few is parametrised over both families, through one
module-scoped fixture that builds each family's JAX references once.

- SFT (``train/sft.py`` through ``models.family_forward``; Aria's batch
  carries ``pixel_values``): the loss and every gradient leaf (router,
  expert stacks, Aria's tower, projector and shared experts, the Qwen
  tower's deepstack mergers) against JAX's ``sft_loss`` under
  ``jax.value_and_grad``; remat against no remat, the recomputed routing
  equal to the forward's; one ``make_train_step`` and one
  ``make_lora_train_step`` step against JAX's.
- GSPO (``train/gspo.py``): one PEFT and one full fine-tune step against
  JAX's ``GSPOTrainer`` on canned rollouts (Aria's sample over two images by
  ``pixel_values``, as ``tests/test_aria.py`` builds it); Aria's
  degrade-to-text-only against JAX's ``_degrade_invalid_vision``.
- LoRA: a target a layer lacks raises KeyError in both packages (the routed
  layers have no ``gate_w``; Aria's shared experts do); ``merge_adapters``
  leaf by leaf against JAX's.
- Checkpoints: a full fine-tune restored from step 1 takes step 2 bit for
  bit.
- ``moe_mlp``'s backward against ``moe_mlp_dense``'s (JAX's form), under a
  ``route`` that leaves an expert empty (its ``moe_fc1``/``moe_fc2``
  gradients exactly 0) and under a ``y.sum()`` upstream gradient (stride 0).
- On the card (``cuda``): ``moe_mlp``'s backward in bf16 against the dense
  form, empty experts exactly 0; K3's exact mode and K5 at the training
  heads of the 30B (32/4, a GQA group of 8) and of Aria (20/20, a group of
  1) against their plain versions.

Tolerances: ATOL_MODEL (1e-4) for losses, updated weights and each gradient
leaf at its own scale (float32 sums in another order through two whole
models), the gradient norm to 1e-5 relative; the MLP's gradients to ATOL
(1e-5) at their scale. The Qwen family's special ids are moved to 300-304,
above the ByteTokenizer's byte range (as in ``test_torch_gspo.py``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_MODEL, cuda_device, frames, jax_params_numpy, rng
from test_torch_gspo import REWARD_KWARGS, Canned, _generate, _recording
from test_torch_train_families import (EXAMPLES, LR, LOGP_CHUNK, LORA_SCALE, SPECIAL_IDS,
                                       _adapter_tree, _assert_trees_close, _gspo_cfg,
                                       _jax_batch, _messages, _processor)
from test_torch_train_families import _grads as _grad_tree
from test_torch_train_families import _gspo_sample as _qwen_gspo_sample

from open_o3_video_tpu_torch.data import sft_dataset as tdata
from open_o3_video_tpu_torch.models import aria as TA
from open_o3_video_tpu_torch.models.qwen25vl import config as TC
from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.models.qwen25vl import text as TT
from open_o3_video_tpu_torch.train import checkpoint as CK
from open_o3_video_tpu_torch.train import gspo as TG
from open_o3_video_tpu_torch.train import lora as TL
from open_o3_video_tpu_torch.train import sft as tsft

CPU = torch.device("cpu")
FAMILIES = ["tiny_qwen3_moe", "tiny_aria"]
ATOL = 1e-5
GSPO_LR = {"peft": 1e-2, "full": 1e-3}
# Gradient leaves are compared at their own scale, floored at GRAD_FLOOR: a
# key bias (Aria's tower blocks' k_b, its projector's mha_k_b) shifts every
# score of a query alike, which the softmax ignores, so its gradient is 0 in
# exact arithmetic and float noise (~1e-12) in both packages.
GRAD_FLOOR = 1e-6
KEY_BIASES = ("k_b", "mha_k_b")


def _aria_sft_batch(tcfg):
    """Two rows of one image each (3 text tokens, the image's query rows,
    6 text tokens), the prompt region unsupervised, as tests/test_aria.py
    builds its batch."""
    r = rng(7)
    q = tcfg.query_num(tcfg.vision.num_patches_per_side ** 2)
    ids = np.array([r.integers(5, 400, size=3).tolist() + [tcfg.image_token_id] * q
                    + r.integers(5, 400, size=6).tolist() for _ in range(2)])
    labels = tsft.mask_labels(ids, tcfg.pad_token_id, (tcfg.image_token_id,))
    labels[:, :4] = tsft.IGNORE_INDEX
    s = tcfg.vision.image_size
    return {"input_ids": ids, "position_ids": TA.get_rope_index(tcfg, ids), "labels": labels,
            "pixel_values": r.standard_normal((2, 3, s, s)).astype(np.float32)}


def _aria_gspo_sample(tcfg, n_images=2, placeholders=None):
    """An Aria GSPO prompt over ``n_images`` images (tests/test_aria.py's
    sample); ``placeholders`` overrides the image-token count."""
    r = rng(9)
    q = tcfg.query_num(tcfg.vision.num_patches_per_side ** 2)
    n = n_images * q if placeholders is None else placeholders
    s = tcfg.vision.image_size
    return {"input_ids": (r.integers(5, 400, size=4).tolist() + [tcfg.image_token_id] * n
                          + r.integers(5, 400, size=3).tolist()),
            "pixel_values": r.standard_normal((n_images, 3, s, s)).astype(np.float32),
            "reward_kwargs": dict(REWARD_KWARGS)}


def _keep_grads():
    """An optax transformation that passes the gradients on and keeps them
    as its state."""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, _, p=None: (g, g))


class Family:
    """One family's configs, JAX's random init (numpy), its SFT batch and
    GSPO sample, and JAX's results on them, each computed once."""

    def __init__(self, name):
        import jax

        self.name = name
        if name == "tiny_aria":
            from open_o3_video_tpu.models.aria import params as JAP
            from open_o3_video_tpu.models.aria import tiny_aria as jax_tiny_aria

            self.jcfg, self.tcfg = jax_tiny_aria(), TA.tiny_aria()
            self.tree = jax.tree.map(np.asarray, jax.jit(functools.partial(JAP.init, self.jcfg,
                                                                           0))())
            self.batch = _aria_sft_batch(self.tcfg)
            self.sample = _aria_gspo_sample(self.tcfg)
        else:
            from open_o3_video_tpu.models.qwen25vl import config as JC

            self.jcfg = dataclasses.replace(JC.tiny_qwen3_moe(), **SPECIAL_IDS)
            self.tcfg = dataclasses.replace(TC.tiny_qwen3_moe(), **SPECIAL_IDS)
            self.tree = jax_params_numpy(self.jcfg, 0)
            proc, r = _processor(self.tcfg), rng(3)
            singles = [tdata.collate_sft_frames(_messages(q, a), list(frames(r, 2, 56, 84)), 2.0,
                                                proc, self.tcfg) for q, a in EXAMPLES]
            self.batch = tdata.pack_sft_batch(singles, self.tcfg, pad_multiple=16)
            self.sample = _qwen_gspo_sample(self.tcfg)
        self.aria = name == "tiny_aria"
        self._gspo = {}

    def port_params(self, trainable=True):
        """A fresh copy of the port's params (training updates in place)."""
        params = TP.from_jax_params(self.tree, self.tcfg, CPU)
        return TP.trainable(params) if trainable else params

    def jax_params(self):
        import jax
        import jax.numpy as jnp

        return jax.tree.map(jnp.asarray, self.tree)

    @functools.cached_property
    def jax_train_step(self):
        """JAX's ``make_train_step`` on the batch, its optimizer chained after
        a transformation that keeps the raw gradients as its state (one
        compile gives the gradients and the step): (metrics, gradients,
        updated params), numpy."""
        import jax
        import optax

        from open_o3_video_tpu.train import sft as jsft

        jtrain = jsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
        opt = optax.chain(_keep_grads(), jsft.make_optimizer(jtrain))
        params = self.jax_params()
        new, state, m = jsft.make_train_step(self.jcfg, jtrain, opt)(
            params, opt.init(params), _jax_batch(self.batch))
        return ({k: np.asarray(v) for k, v in m.items()}, jax.tree.map(np.asarray, state[0]),
                jax.tree.map(np.asarray, new))

    @functools.cached_property
    def adapter_tree(self):
        return _adapter_tree(self.port_params(trainable=False))

    @functools.cached_property
    def jax_lora_step(self):
        """JAX's ``make_lora_train_step`` from ``adapter_tree``: (metrics,
        updated adapters), numpy."""
        import jax
        import jax.numpy as jnp

        from open_o3_video_tpu.train import sft as jsft

        jtrain = jsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
        jopt = jsft.make_optimizer(jtrain)
        jad = jax.tree.map(jnp.asarray, self.adapter_tree)
        new, _, m = jsft.make_lora_train_step(self.jcfg, jtrain, jopt, LORA_SCALE)(
            jad, jopt.init(jad), _jax_batch(self.batch), self.jax_params())
        return {k: np.asarray(v) for k, v in m.items()}, jax.tree.map(np.asarray, new)

    def jax_gspo_step(self, mode):
        """One step of JAX's GSPOTrainer on canned rollouts, its optimizer
        chained after ``_keep_grads``: (metrics, the rewards recorded, the
        trained tree before and after, its gradients, the trainer)."""
        if mode not in self._gspo:
            self._gspo[mode] = self._jax_gspo_step(mode)
        return self._gspo[mode]

    def _jax_gspo_step(self, mode):
        import jax
        import jax.numpy as jnp
        import optax

        from open_o3_video_tpu.grounding.rewards import REWARD_REGISTRY
        from open_o3_video_tpu.train import gspo as JG
        from open_o3_video_tpu.train import lora as JL

        peft, record = mode == "peft", {}
        trainer = JG.GSPOTrainer(
            self.jax_params(), None if peft else self.jax_params(), self.jcfg,
            _gspo_cfg(JG.GSPOConfig, mode), detokenize=Canned(),
            reward_funcs=_recording(REWARD_REGISTRY.values(), record),
            lora=JL.LoraConfig(rank=4, alpha=8.0) if peft else None)
        if peft:  # float32 adapters on both sides (JAX draws them in bf16)
            trainer.adapters = jax.tree.map(lambda x: x.astype(jnp.float32), trainer.adapters)
        trainer.optimizer = optax.chain(_keep_grads(), trainer.optimizer)
        trainer.opt_state = trainer.optimizer.init(trainer.adapters if peft else trainer.params)
        start = jax.tree.map(np.asarray, trainer.adapters if peft else trainer.params)
        trainer.engine.generate = _generate
        m = trainer.step(self.sample, global_step=0, max_steps=4)
        return (m, record, start,
                jax.tree.map(np.asarray, trainer.adapters if peft else trainer.params),
                jax.tree.map(np.asarray, trainer.opt_state[0]), trainer)


@pytest.fixture(scope="module")
def families():
    """Each family built on first use, once for the module."""
    built = {}

    def get(name):
        if name not in built:
            built[name] = Family(name)
        return built[name]

    return get


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request, families):
    return families(request.param)


def _assert_grads_close(ours, theirs):
    import jax

    flat_o, flat_t = jax.tree.leaves_with_path(ours), jax.tree.leaves_with_path(theirs)
    assert [p for p, _ in flat_o] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_o, flat_t):
        tol = ATOL_MODEL * max(float(np.abs(b).max()), GRAD_FLOOR)
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=jax.tree_util.keystr(path))


def _leaf_max(tree, *path):
    for key in path:
        tree = tree[key]
    return max(float(np.abs(x).max()) for x in __import__("jax").tree.leaves(tree))


def test_sft_loss_and_every_gradient_match_jax(fam):
    import jax

    jm, jgrads, _ = fam.jax_train_step
    params = fam.port_params()
    m = tsft.loss_and_grads(params, fam.tcfg, tsft.SFTConfig(logp_chunk=LOGP_CHUNK), fam.batch)
    assert int(m["num_target_tokens"]) == int(jm["num_target_tokens"]) > 0
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=ATOL_MODEL)
    ours = TP.to_jax_layout(_grad_tree(params))
    _assert_grads_close(ours, jgrads)
    jnorm = float(np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in jax.tree.leaves(jgrads))))
    np.testing.assert_allclose(float(m["grad_norm"]), jnorm, rtol=1e-5)
    # the router and both expert stacks of every layer, the tower (and
    # Aria's projector and shared experts) all receive a gradient
    for i in range(fam.tcfg.text.num_hidden_layers):
        for leaf in ("router", "moe_fc1", "moe_fc2") + (("gate_w", "down_w") if fam.aria else ()):
            assert _leaf_max(ours, "text", "layers", i, leaf) > 0, (i, leaf)
    moving = [(jax.tree_util.keystr(p), g) for part in ("visual", "projector")
              for p, g in jax.tree.leaves_with_path(ours.get(part, {}))]
    assert len(moving) > 20 and all(np.abs(g).max() > 1e-9 for p, g in moving
                                    if not p.endswith(tuple(f"['{k}']" for k in KEY_BIASES)))


def test_remat_gives_the_same_gradients_and_routing(fam, monkeypatch):
    """The non-reentrant checkpoint recomputes each layer's routing in the
    backward: the same experts as the forward picked (the stable sort on an
    unchanged input), hence the same gradients as no remat."""
    routes = []
    real = TT.moe_route

    def record(p, cfg, flat):
        out = real(p, cfg, flat)
        routes.append(out[0].clone())
        return out

    monkeypatch.setattr(TT, "moe_route", record)
    out = []
    for remat in (True, False):
        routes.clear()
        params = fam.port_params()
        m = tsft.loss_and_grads(params, fam.tcfg, tsft.SFTConfig(gradient_checkpointing=remat,
                                                                 logp_chunk=LOGP_CHUNK), fam.batch)
        out.append((float(m["loss"]), TP.leaves(_grad_tree(params)), list(routes)))
    (l1, g1, r1), (l2, g2, r2) = out
    n = fam.tcfg.text.num_hidden_layers
    assert len(r1) == 2 * n and len(r2) == n  # remat: each layer routed again in the backward
    for fwd, again in zip(r1[:n], reversed(r1[n:])):
        assert torch.equal(fwd, again)
    assert all(torch.equal(a, b) for a, b in zip(r1[:n], r2))
    assert l1 == l2
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)


def test_one_step_matches_jax_make_train_step(fam):
    import jax

    jm, _, jnew = fam.jax_train_step
    train_cfg = tsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
    opt = tsft.make_optimizer(train_cfg)
    params = fam.port_params()
    params, state, m = tsft.make_train_step(fam.tcfg, train_cfg, opt)(params, opt.init(params),
                                                                      fam.batch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    assert state["count"] == 1
    ours = TP.to_jax_layout(params)
    _assert_trees_close(ours, jnew, atol=ATOL_MODEL)
    moved = sum(int((np.abs(a - b) > LR / 2).sum())
                for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(fam.tree)))
    assert moved > 0


def test_one_peft_step_matches_jax_make_lora_train_step(fam):
    """LoRA on q_w and v_w of every mixture layer over the frozen base; the
    tower keeps no graph (nothing of it requires a gradient)."""
    import jax

    jm, jnew = fam.jax_lora_step
    base = fam.port_params(trainable=False)
    before = [x.clone() for x in TP.leaves(base)]
    adapters = TP.adapters_from_jax(fam.adapter_tree, CPU)
    train_cfg = tsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
    opt = tsft.make_optimizer(train_cfg)
    step = tsft.make_lora_train_step(fam.tcfg, train_cfg, opt, LORA_SCALE)
    adapters, _, m = step(adapters, opt.init(TL.adapter_leaves(adapters)), fam.batch, base)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=ATOL_MODEL, rtol=0)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    ours = {"layers": [{n: {k: x.detach().numpy() for k, x in ab.items()} for n, ab in l.items()}
                       for l in adapters["layers"]]}
    _assert_trees_close(ours, jnew, atol=ATOL_MODEL)
    moved = sum(int((np.abs(a - b) > LR / 2).sum())
                for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(fam.adapter_tree)))
    assert moved > 0
    for x, y in zip(TP.leaves(base), before):  # the base frozen, bit for bit
        assert x.grad is None and not x.requires_grad and torch.equal(x, y)


@pytest.mark.parametrize("mode", ["peft", "full"])
def test_gspo_step_matches_jax(fam, mode):
    """The metrics, every reward, and the gradient of every trained leaf at
    its scale; under PEFT the updated adapters too. A full fine-tune's
    updated weights are not compared element by element: AdamW's first
    step moves a weight by lr * g / (|g| + 1e-8), which turns the float
    noise of a gradient near 0 into up to lr / 1e-8 times as much (measured
    at one merger weight: 1.4e-4 apart at lr 1e-3), so the full fine-tune
    holds the gradients themselves."""
    import jax

    from open_o3_video_tpu_torch.grounding.rewards import REWARD_REGISTRY

    peft = mode == "peft"
    jm, jrec, start, jout, jgrads, _ = fam.jax_gspo_step(mode)
    record = {}
    trainer = TG.GSPOTrainer(fam.port_params(trainable=False),
                             None if peft else fam.port_params(trainable=False), fam.tcfg,
                             _gspo_cfg(TG.GSPOConfig, mode), detokenize=Canned(),
                             reward_funcs=_recording(REWARD_REGISTRY.values(), record),
                             lora=TL.LoraConfig(rank=4, alpha=8.0) if peft else None)
    if peft:
        trainer.adapters = TP.adapters_from_jax(start, CPU)
        trainer.opt_state = trainer.optimizer.init(TL.adapter_leaves(trainer.adapters))
    requests = []

    def generate(reqs, *args, **kw):
        requests.extend(reqs)
        return _generate()

    trainer.engine.generate = generate
    grads, update = [], trainer.optimizer.update

    def keep(state, norm):
        grads.extend(x.grad.clone() for x in trainer.trained_leaves())
        update(state, norm)

    trainer.optimizer.update = keep
    tm = trainer.step(fam.sample, global_step=0, max_steps=4)
    for x, g in zip(trainer.trained_leaves(), grads):
        x.grad = g
    _assert_grads_close(TP.to_jax_layout(_grad_tree(trainer.adapters if peft else trainer.params)),
                        jgrads)
    last = trainer.last_step
    assert last["use_vision"] and last["n_degraded"] == 0
    if fam.aria:  # the G rows of the prompt share one encoding, as vision_embeds
        assert len(requests) == 4 and len({id(r.vision_embeds) for r in requests}) == 1
        q = fam.tcfg.query_num(fam.tcfg.vision.num_patches_per_side ** 2)
        assert requests[0].vision_embeds.shape == (2 * q, fam.tcfg.text.hidden_size)
        assert set(last["batch"]) >= {"pixel_values", "vision_row_index"}
    assert record == jrec  # every reward of every row, float for float
    assert tm.keys() == jm.keys()
    for key in tm:
        if key in ("loss", "kl"):
            np.testing.assert_allclose(tm[key], float(jm[key]), atol=ATOL_MODEL, err_msg=key)
        else:
            assert tm[key] == float(jm[key]), key
    ours = TP.to_jax_layout(trainer.adapters if peft else trainer.params)
    if peft:
        _assert_trees_close(ours, jout, atol=ATOL_MODEL)
    moved = sum(int((np.abs(a - s) > GSPO_LR[mode] / 2).sum())
                for a, s in zip(jax.tree.leaves(ours), jax.tree.leaves(start)))
    assert moved > 0
    if peft:  # the base frozen, bit for bit
        for a, b in zip(jax.tree.leaves(TP.to_jax_layout(trainer.params)),
                        jax.tree.leaves(fam.tree)):
            np.testing.assert_array_equal(a, b)


@pytest.fixture
def deterministic():
    """Deterministic kernels (on the CPU the embedding's backward otherwise
    sums repeated tokens' rows in thread order)."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_restored_checkpoint_repeats_the_step(fam, tmp_path, deterministic):
    """Full fine-tune: step 1, a checkpoint (the params and AdamW state of
    the expert stacks and routers among them), step 2; a fresh copy
    restored from step 1 takes step 2 bit for bit."""
    train_cfg = tsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
    opt = tsft.make_optimizer(train_cfg)
    step = tsft.make_train_step(fam.tcfg, train_cfg, opt)
    a = fam.port_params()
    state = opt.init(a)
    a, state, _ = step(a, state, fam.batch)
    CK.save_checkpoint(str(tmp_path), 1, {"params": a, "opt_state": state, "meta": {"step": 1}})
    a, state, want = step(a, state, fam.batch)

    b = fam.port_params()
    target = {"params": b, "opt_state": opt.init(b), "meta": {"step": 0}}
    restored, at = CK.restore_checkpoint(str(tmp_path), 1, target=target)
    assert at == 1 and restored["opt_state"]["count"] == 1
    b, _, got = step(b, restored["opt_state"], fam.batch)
    assert float(got["loss"]) == float(want["loss"])
    assert float(got["grad_norm"]) == float(want["grad_norm"])
    for x, y in zip(TP.leaves(a), TP.leaves(b)):
        assert torch.equal(x, y)


def test_lora_targets_and_merge_match_jax(fam):
    """``gate_w``: a routed Qwen layer lacks it (KeyError in both packages),
    Aria's shared experts have it. Adapters over q_w, v_w and (Aria)
    gate_w merged into the base equal JAX's merge leaf by leaf."""
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.train import lora as JL

    targets = ("q_w", "v_w", "gate_w")
    base = fam.port_params(trainable=False)
    if not fam.aria:
        with pytest.raises(KeyError, match="gate_w"):
            TL.init_adapters(base, TL.LoraConfig(target_modules=targets))
        with pytest.raises(KeyError, match="gate_w"):
            JL.init_adapters(fam.jax_params(), JL.LoraConfig(target_modules=targets))
        targets = targets[:2]
    adapters = TL.init_adapters(base, TL.LoraConfig(rank=4, target_modules=targets),
                                dtype=torch.float32)
    tree = {"layers": [{n: {k: x.detach().numpy() for k, x in ab.items()} for n, ab in l.items()}
                       for l in adapters["layers"]]}
    merged = TP.to_jax_layout(TL.merge_adapters(base, adapters, 2.0))
    want = JL.merge_adapters(fam.jax_params(), jax.tree.map(jnp.asarray, tree), 2.0)
    _assert_trees_close(merged, jax.tree.map(np.asarray, want), atol=ATOL)
    for layer, ad in zip(merged["text"]["layers"], tree["layers"]):
        assert set(ad) == set(targets) and all(np.isfinite(layer[n]).all() for n in targets)


def test_aria_degrades_a_bad_sample_to_text_only_as_jax(families, capsys):
    """An Aria sample with one image token for an image of query_num rows:
    both packages' ``_degrade_invalid_vision`` print the same warning and
    drop ``pixel_values``; the port's step then runs text-only (the G rows
    without vision_embeds, no pixel_values in the update)."""
    fam = families("tiny_aria")
    bad = _aria_gspo_sample(fam.tcfg, n_images=1, placeholders=1)
    good = _aria_gspo_sample(fam.tcfg)
    jtrainer = fam.jax_gspo_step("peft")[-1]
    capsys.readouterr()
    jout = jtrainer._degrade_invalid_vision(bad)
    jprinted = capsys.readouterr().out
    assert jtrainer._degrade_invalid_vision(good) is good
    trainer = TG.GSPOTrainer(fam.port_params(trainable=False), None, fam.tcfg,
                             _gspo_cfg(TG.GSPOConfig, "peft"), detokenize=Canned(),
                             lora=TL.LoraConfig(rank=4, alpha=8.0))
    out = trainer._degrade_invalid_vision(bad)
    assert capsys.readouterr().out == jprinted != ""
    assert out.keys() == jout.keys() and out["pixel_values"] is None is jout["pixel_values"]
    assert trainer._degrade_invalid_vision(good) is good
    requests = []

    def generate(reqs, *args, **kw):
        requests.extend(reqs)
        return _generate()

    trainer.engine.generate = generate
    m = trainer.step(bad, global_step=0, max_steps=2)
    assert "degrading sample to text-only" in capsys.readouterr().out
    assert np.isfinite(m["loss"]) and trainer.last_step["n_degraded"] == 1
    assert not trainer.last_step["use_vision"] and "pixel_values" not in trainer.last_step["batch"]
    assert all(r.vision_embeds is None for r in requests)


# ---- the routed MLP's backward ---------------------------------------------


def _mixture(routing, shared):
    """A mixture layer's weights (f32, trainable) and its config: 4 experts
    of 16, top 2, on a 32-wide residual (Aria's routing with 2 shared
    experts)."""
    from test_torch_moe import _layer

    t = TC.TextConfig(hidden_size=32, moe_num_experts=4, moe_topk=2, moe_intermediate_size=16,
                      moe_routing=routing, moe_num_shared_experts=shared)
    p = {k: torch.from_numpy(x).requires_grad_(True) for k, x in _layer(rng(5), 32, 4, 16,
                                                                         shared).items()}
    return p, t


@pytest.mark.parametrize("upstream", ["random", "sum"])
@pytest.mark.parametrize("routing,shared", [("softmax_topk_norm", 0), ("topk_softmax", 2)])
def test_moe_mlp_backward_matches_the_dense_form(routing, shared, upstream):
    """Gradients of the routed MLP (router or routing weights, both expert
    stacks, the shared experts, the input) equal the dense form's, JAX's
    combine. ``upstream`` "sum" is ``y.sum()``'s stride-0 gradient, which
    ``torch._grouped_mm``'s backward refuses unless ``moe_mlp`` hands it a
    gradient of its own layout. With the router's own routing, and with a
    ``route`` that sends no token to expert 3: its expert gradients are
    exactly 0 in both forms, as JAX's zero combine entries give them."""
    p, t = _mixture(routing, shared)
    r = rng(6)
    x = torch.from_numpy(r.standard_normal((3, 5, 32)).astype(np.float32)).requires_grad_(True)
    dy = torch.from_numpy(r.standard_normal((3, 5, 32)).astype(np.float32))
    idx = torch.from_numpy(np.stack([np.arange(15) % 3, (np.arange(15) + 1) % 3], 1))
    w = torch.softmax(torch.from_numpy(r.standard_normal((15, 2)).astype(np.float32)), -1)

    def grads(fn, route):
        leaves = [*p.values(), x] + ([] if route is None else [route[1]])
        for v in leaves:
            v.grad = None
        y = fn(p, t, x, route=route)
        (y.sum() if upstream == "sum" else (y * dy).sum()).backward()
        return {n: v.grad.clone() for n, v in zip([*p, "x", "w"], leaves) if v.grad is not None}

    for route in (None, (idx, w.clone().requires_grad_(True))):
        got = grads(TT.moe_mlp, route)
        want = grads(TT.moe_mlp_dense, route)
        assert got.keys() == want.keys() and ("router" in got) == (route is None)
        for name in got:
            scale = max(float(want[name].abs().max()), 1.0)
            torch.testing.assert_close(got[name], want[name], atol=ATOL * scale, rtol=0,
                                       msg=name)
        if route is not None:
            for name in ("moe_fc1", "moe_fc2"):
                assert not got[name][3].any() and not want[name][3].any(), name
                assert got[name][:3].abs().amax(dim=(1, 2)).min() > 0, name


# ---- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_moe_mlp_backward_on_the_card():
    """The routed MLP's backward in bf16 at the 30B's expert widths (16
    experts of 768, top 8, on a 2048 residual; 300 tokens) against the
    dense form's: each gradient (router, both stacks, input) at most 1.25x
    as far from the float32 dense gradient (relative L2) as the bf16 dense
    form's, on the bf16 router's experts and on a route that leaves 3
    experts empty; with
    a route that leaves 3 experts empty, their expert gradients exactly 0
    (a grouped product over an empty group writes its weight gradient)."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(0)
    E, D, F, k, n = 16, 2048, 768, 8, 300
    t = TC.TextConfig(hidden_size=D, moe_num_experts=E, moe_topk=k, moe_intermediate_size=F,
                      moe_routing="softmax_topk_norm")
    p32 = {"router": 0.02 * torch.randn((D, E), generator=g, device=dev),
           "moe_fc1": 0.02 * torch.randn((E, D, 2 * F), generator=g, device=dev),
           "moe_fc2": 0.02 * torch.randn((E, F, D), generator=g, device=dev)}
    x32 = torch.randn((n, D), generator=g, device=dev)
    dy = torch.randn((n, D), generator=g, device=dev).to(torch.bfloat16)
    held = (torch.arange(n, device=dev)[:, None] + torch.arange(k, device=dev)) % (E - 3)

    bf16_idx = TT.moe_route({n_: v.to(torch.bfloat16) for n_, v in p32.items()}, t,
                            x32.to(torch.bfloat16))[0]

    def grads(fn, dtype, idx):
        """The gradients of every weight and the input, the experts fixed
        to ``idx`` and their weights the router's softmax renormalised over
        them (the routing's function, differentiable in each dtype)."""
        p = {n_: v.detach().to(dtype).requires_grad_(True) for n_, v in p32.items()}
        x = x32.detach().to(dtype).requires_grad_(True)
        probs = torch.softmax((x @ p["router"]).float(), dim=-1).gather(1, idx)
        route = (idx, probs / probs.sum(-1, keepdim=True))
        (fn(p, t, x, route=route).float() * dy.float()).sum().backward()
        return {**{n_: v.grad.float() for n_, v in p.items()}, "x": x.grad.float()}

    for what, idx in (("router", bf16_idx), ("held", held)):
        routed = grads(TT.moe_mlp, torch.bfloat16, idx)
        plain = grads(TT.moe_mlp_dense, torch.bfloat16, idx)
        ref = grads(TT.moe_mlp_dense, torch.float32, idx)
        for name in ref:
            rel = float((routed[name] - ref[name]).norm() / ref[name].norm())
            rel_plain = float((plain[name] - ref[name]).norm() / ref[name].norm())
            assert torch.isfinite(routed[name]).all() and rel < 0.05, (what, name, rel)
            assert rel <= 1.25 * rel_plain, (what, name, rel, rel_plain)
        if what == "held":
            for name in ("moe_fc1", "moe_fc2"):
                assert not routed[name][E - 3:].any() and not plain[name][E - 3:].any(), name


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv,S", [(32, 4, 2762), (20, 20, 600)])
def test_k3_exact_and_k5_at_the_moe_training_heads_on_the_card(Hq, Hkv, S):
    """K3's exact mode (out, lse) and K5 (dq; dk, dv) at the 30B's training
    heads (32 q over 4 KV heads: a GQA group of 8) and Aria's (20 over 20: a
    group of 1) against their plain versions, one right-padded row."""
    from test_torch_flash_attention_bwd import _assert_exact_close, _cuda_inputs

    from _torch_parity import assert_kernel_close
    from open_o3_video_tpu_torch.ops import flash_attention as tfa

    dev = cuda_device()
    q, k, v, pos, valid, do = _cuda_inputs(dev, 1, S, S, Hq, Hkv, 0)
    _assert_exact_close(q, k, v, pos, valid)
    out, lse = tfa.flash_attention_gqa_exact_torch(q, k, v, pos, valid)
    got = tfa.flash_attention_gqa_bwd(q, k, v, pos, valid, out, lse, do)
    ref = tfa.flash_attention_gqa_bwd_torch(q, k, v, pos, valid, out, lse, do)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.isfinite(a.float()).all()
        assert_kernel_close(a, b)
