"""The port's SFT step against the JAX package's ``make_train_step`` at tiny
dims in float32 on the CPU: the same weights (JAX init -> numpy -> port
params), the same two-example batch of 2-frame videos from the port's
``collate_sft_frames`` and ``pack_sft_batch`` (right padding, masked
labels). Loss, target count, global gradient norm and the updated params
after one step agree to ATOL_MODEL (f32 sums in another order, through two
whole models); every gradient leaf to ATOL_MODEL at its own scale (max abs
error <= ATOL_MODEL * max|grad|: the tiny model's gradients are 1e-6 to
1e-3, and they agree to ~1e-6 of their scale)."""

import functools

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_MODEL, ATOL_OP, frames, model_pair, rng

from open_o3_video_tpu_torch.data import sft_dataset as tdata
from open_o3_video_tpu_torch.data.processor import ByteTokenizer, O3VideoProcessor
from open_o3_video_tpu_torch.grounding.prompts import VISION_PLACEHOLDER
from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.models.qwen25vl.text import per_token_logps_from_hidden
from open_o3_video_tpu_torch.train import sft as tsft

FPS = 2.0
# lr 1e-2 so one AdamW update is visible in the params; a logp chunk below
# the sequence length, so both packages take their chunked lm_head.
LR, LOGP_CHUNK = 1e-2, 64


def _messages(question, answer):
    return [
        {"role": "system", "content": [{"type": "text", "text": "Answer from the video."}]},
        {"role": "user", "content": [{"type": "video", "video": "clip.mp4"},
                                     {"type": "text", "text": question}]},
        {"role": "assistant", "content": [{"type": "text", "text": answer}]},
    ]


EXAMPLES = [
    ("What moves?", "<think>A <obj>ball</obj><box>[1,2,30,40]</box>at<t>0.5</t>s rolls."
                    "</think>\n<answer>the ball</answer>"),
    ("Who?", "<think>none</think>\n<answer>no one</answer>"),
]


@functools.cache
def _batch():
    _, _, tcfg, _ = model_pair(0)
    proc = O3VideoProcessor(tokenizer=ByteTokenizer.for_config(tcfg))
    r = rng(3)
    singles = [tdata.collate_sft_frames(_messages(q, a), list(frames(r, 2, 56, 84)), FPS, proc,
                                        tcfg)
               for q, a in EXAMPLES]
    return singles, tdata.pack_sft_batch(singles, tcfg, pad_multiple=16)


def _fresh_port_params():
    """A trainable copy of the port's tiny params (training updates in place)."""
    _, _, tcfg, tparams = model_pair(0)
    return TP.trainable(TP.from_jax_params(TP.to_jax_layout(tparams), tcfg, torch.device("cpu")))


def _grads(tree):
    """The ``.grad`` of every leaf of a param dict, in its shape."""
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grads(v) for v in tree]
    return tree.grad


def _jax_batch(batch):
    import jax.numpy as jnp

    return {k: (v if k in ("grid_thw", "vision_token_id") else jnp.asarray(v))
            for k, v in batch.items()}


def _jax_loss_and_grads(jcfg, jparams, batch, train_cfg):
    import jax

    from open_o3_video_tpu.train import sft as jsft

    full = _jax_batch(batch)

    @jax.jit
    def fn(p, b):
        b = {**b, "grid_thw": full["grid_thw"], "vision_token_id": full["vision_token_id"]}
        return jax.value_and_grad(lambda q: jsft.sft_loss(
            q, jcfg, b, remat=train_cfg.gradient_checkpointing,
            logp_chunk=train_cfg.logp_chunk), has_aux=True)(p)

    (loss, aux), grads = fn(jparams, {k: v for k, v in full.items()
                                      if k not in ("grid_thw", "vision_token_id")})
    return float(loss), int(aux["num_target_tokens"]), grads


def test_batch_is_packed_as_the_jax_package_packs_it():
    from open_o3_video_tpu.data import sft_dataset as jdata
    from open_o3_video_tpu.grounding.prompts import frame_prompt_sft_temporal
    from open_o3_video_tpu.models.qwen25vl import get_rope_index
    from open_o3_video_tpu.train import sft as jsft

    jcfg, _, tcfg, _ = model_pair(0)
    singles, batch = _batch()
    want = jdata.pack_sft_batch(singles, jcfg, pad_multiple=16)
    assert batch.keys() == want.keys()
    for key in batch:
        np.testing.assert_array_equal(batch[key], want[key], err_msg=key)
    assert batch["attn_valid"][1].sum() < batch["attn_valid"].shape[1]  # row 1 is padded
    # collate: the JAX frame prompt, labels and M-RoPE positions
    proc = O3VideoProcessor(tokenizer=ByteTokenizer.for_config(tcfg))
    text = proc.apply_chat_template(_messages(*EXAMPLES[0]), add_generation_prompt=False)
    x = proc(text.replace(VISION_PLACEHOLDER, frame_prompt_sft_temporal(2, FPS)),
             images=list(frames(rng(3), 2, 56, 84)))
    ids = np.asarray([x.input_ids])
    np.testing.assert_array_equal(singles[0]["input_ids"], ids)
    np.testing.assert_array_equal(
        singles[0]["labels"],
        jsft.mask_labels(ids, proc.tokenizer.pad_token_id, jdata.visual_mask_ids(jcfg)))
    np.testing.assert_array_equal(singles[0]["position_ids"],
                                  get_rope_index(jcfg, ids, image_grid_thw=x.grid_thw)[0])
    assert tdata.visual_mask_ids(tcfg) == jdata.visual_mask_ids(jcfg)
    assert (singles[0]["labels"] == tdata.IGNORE_INDEX).sum() > 0


def test_mask_labels_matches_jax():
    from open_o3_video_tpu.train import sft as jsft

    ids = np.array([[1, 151652, 151656, 151653, 7, 0, 151655]])
    for vis in ((151655,), (151652, 151653, 151656)):
        np.testing.assert_array_equal(tsft.mask_labels(ids, 0, vis), jsft.mask_labels(ids, 0, vis))


def test_chunked_logps_match_jax():
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.models.qwen25vl.text import per_token_logps_from_hidden as jlogps

    r = rng(4)
    B, S, Dm, V = 2, 13, 16, 40
    hidden, lm_head = r.standard_normal((B, S, Dm), np.float32), r.standard_normal((Dm, V), np.float32)
    targets = r.integers(0, V, (B, S))
    _, jgrad = jax.value_and_grad(
        lambda h, w: jlogps({"lm_head": w}, h, jnp.asarray(targets), 5).sum(), argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(lm_head))
    h, w = (torch.from_numpy(x).requires_grad_() for x in (hidden, lm_head))
    ours = per_token_logps_from_hidden({"lm_head": w}, h, torch.from_numpy(targets), 5)
    dense = per_token_logps_from_hidden({"lm_head": w}, h, torch.from_numpy(targets))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(
        jlogps({"lm_head": jnp.asarray(lm_head)}, jnp.asarray(hidden), jnp.asarray(targets), 5)),
        atol=ATOL_OP)
    torch.testing.assert_close(ours, dense, atol=ATOL_OP, rtol=0)
    gh, gw = torch.autograd.grad(ours.sum(), (h, w))
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgrad[0]), atol=ATOL_OP)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgrad[1]), atol=ATOL_OP)


def test_loss_and_every_gradient_match_jax():
    import jax

    jcfg, jparams, tcfg, _ = model_pair(0)
    _, batch = _batch()
    train_cfg = tsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
    jloss, jcount, jgrads = _jax_loss_and_grads(jcfg, jparams, batch, train_cfg)
    params = _fresh_port_params()
    m = tsft.loss_and_grads(params, tcfg, train_cfg, batch)
    assert int(m["num_target_tokens"]) == jcount > 0
    np.testing.assert_allclose(float(m["loss"]), jloss, atol=ATOL_MODEL)
    ours = TP.to_jax_layout(_grads(params))
    theirs = jax.tree.map(np.asarray, jgrads)
    flat_o, flat_t = jax.tree.leaves_with_path(ours), jax.tree.leaves_with_path(theirs)
    assert [p for p, _ in flat_o] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_o, flat_t):
        np.testing.assert_allclose(a, b, atol=ATOL_MODEL * np.abs(b).max(), rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
    jnorm = float(np.sqrt(sum((x.astype(np.float64) ** 2).sum() for _, x in flat_t)))
    np.testing.assert_allclose(float(m["grad_norm"]), jnorm, rtol=1e-5)


def test_remat_gives_the_same_gradients():
    _, _, tcfg, _ = model_pair(0)
    _, batch = _batch()
    out = []
    for remat in (True, False):
        params = _fresh_port_params()
        cfg = tsft.SFTConfig(gradient_checkpointing=remat, logp_chunk=LOGP_CHUNK)
        m = tsft.loss_and_grads(params, tcfg, cfg, batch)
        out.append((m, TP.leaves(_grads(params))))
    (m1, g1), (m2, g2) = out
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)


def test_one_step_matches_jax_make_train_step():
    import jax

    from open_o3_video_tpu.train import sft as jsft

    jcfg, jparams, tcfg, _ = model_pair(0)
    _, batch = _batch()
    train_cfg = tsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
    jtrain = jsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
    jopt = jsft.make_optimizer(jtrain)
    jnew, _, jm = jsft.make_train_step(jcfg, jtrain, jopt)(jparams, jopt.init(jparams),
                                                           _jax_batch(batch))
    params = _fresh_port_params()
    opt = tsft.make_optimizer(train_cfg)
    params, state, m = tsft.make_train_step(tcfg, train_cfg, opt)(params, opt.init(params), batch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    assert int(m["num_target_tokens"]) == int(jm["num_target_tokens"])
    assert state["count"] == 1
    ours = jax.tree.leaves(TP.to_jax_layout(params))
    theirs = jax.tree.leaves(jax.tree.map(np.asarray, jnew))
    before = jax.tree.leaves(TP.to_jax_layout(model_pair(0)[3]))
    moved = 0
    for a, b, p0 in zip(ours, theirs, before):
        np.testing.assert_allclose(a, b, atol=ATOL_MODEL)
        moved += int((np.abs(a - p0) > LR / 2).sum())
    assert moved > 0  # the update is visible


def test_train_step_lowers_the_loss():
    """Three steps at lr 1e-2 on one batch lower its loss."""
    _, _, tcfg, _ = model_pair(0)
    _, batch = _batch()
    cfg = tsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
    params = _fresh_port_params()
    opt = tsft.make_optimizer(cfg)
    state = opt.init(params)
    step = tsft.make_train_step(tcfg, cfg, opt)
    losses = []
    for _ in range(3):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("schedule,warmup", [("constant", 0), ("constant", 3), ("cosine", 2)])
def test_learning_rate_schedule_matches_optax(schedule, warmup):
    """The port's schedule equals the one the JAX package's make_optimizer
    builds from the same SFTConfig fields."""
    import optax

    cfg = tsft.SFTConfig(learning_rate=1e-3, lr_schedule=schedule, warmup_steps=warmup,
                         total_steps=10)
    if schedule == "cosine":
        ref = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup, 10)
    elif warmup:
        ref = optax.join_schedules([optax.linear_schedule(0.0, 1e-3, warmup),
                                    optax.constant_schedule(1e-3)], [warmup])
    else:
        ref = optax.linear_schedule(1e-3, 1e-3, 1)
    for count in range(12):  # optax evaluates in float32: ~1e-6 relative
        np.testing.assert_allclose(tsft.learning_rate(cfg, count), float(ref(count)), rtol=1e-5,
                                   atol=1e-12)
