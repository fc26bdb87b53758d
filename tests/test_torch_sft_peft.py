"""The port's PEFT SFT step (``train/sft.py:make_lora_train_step``) against
the JAX package's at tiny dims in float32 on the CPU, and the port's SFT loss
against HF transformers' Qwen2.5-VL.

- One step from the same weights and the same LoRA adapters (JAX's tree,
  A and B drawn from a seed, so both get gradients; ``adapters_from_jax``)
  on the two-example batch of ``test_torch_sft.py``'s shape: loss, grad norm
  and every updated adapter equal JAX's to 1e-5; the base gets no gradient
  and stays bit for bit; the step's state holds the adapters only.
- ``sft_loss`` on the tiny Qwen2.5-VL of ``tests/test_model_parity.py``
  (built in-process with HF transformers, its weights loaded into the port)
  equals ``Qwen2_5_VLForConditionalGeneration(..., labels=...)``'s loss on
  one row of text, an image and its masked labels, to 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import frames, hf_tiny, model_pair, rng

from open_o3_video_tpu_torch.data import sft_dataset as tdata
from open_o3_video_tpu_torch.data.processor import ByteTokenizer, O3VideoProcessor
from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.train import sft as tsft
from open_o3_video_tpu_torch.train.lora import adapter_leaves

LR, LOGP_CHUNK, SCALE = 1e-2, 64, 2.0
TOL = 1e-5


def _messages(question, answer):
    return [
        {"role": "system", "content": [{"type": "text", "text": "Answer from the video."}]},
        {"role": "user", "content": [{"type": "video", "video": "clip.mp4"},
                                     {"type": "text", "text": question}]},
        {"role": "assistant", "content": [{"type": "text", "text": answer}]},
    ]


def _batch(tcfg):
    proc = O3VideoProcessor(tokenizer=ByteTokenizer.for_config(tcfg))
    r = rng(13)
    singles = [tdata.collate_sft_frames(_messages(q, a), list(frames(r, 2, 56, 84)), 2.0, proc,
                                        tcfg)
               for q, a in (("What moves?", "<think>a ball</think>\n<answer>the ball</answer>"),
                            ("Who?", "<think>none</think>\n<answer>no one</answer>"))]
    return tdata.pack_sft_batch(singles, tcfg, pad_multiple=16)


def _adapter_tree(tcfg):
    """JAX's adapter layout over q_w and v_w, float32 numpy, A and B random."""
    d = tcfg.text.hidden_size
    d_kv = tcfg.text.num_key_value_heads * tcfg.text.head_dim
    r = rng(17)
    return {"layers": [{"q_w": {"a": r.standard_normal((d, 4)).astype(np.float32) * 0.1,
                                "b": r.standard_normal((4, d)).astype(np.float32) * 0.1},
                        "v_w": {"a": r.standard_normal((d, 4)).astype(np.float32) * 0.1,
                                "b": r.standard_normal((4, d_kv)).astype(np.float32) * 0.1}}
                       for _ in range(tcfg.text.num_hidden_layers)]}


def test_one_peft_step_matches_jax_make_lora_train_step():
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.train import sft as jsft

    jcfg, jparams, tcfg, tparams = model_pair(0)
    batch = _batch(tcfg)
    tree = _adapter_tree(tcfg)
    jtrain = jsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
    jopt = jsft.make_optimizer(jtrain)
    jad = jax.tree.map(jnp.asarray, tree)
    jbatch = {k: (v if k in ("grid_thw", "vision_token_id") else jnp.asarray(v))
              for k, v in batch.items()}
    jnew, _, jm = jsft.make_lora_train_step(jcfg, jtrain, jopt, SCALE)(
        jad, jopt.init(jad), jbatch, jparams)

    base = TP.from_jax_params(TP.to_jax_layout(tparams), tcfg, torch.device("cpu"))
    before = [x.clone() for x in TP.leaves(base)]
    adapters = TP.adapters_from_jax(tree, torch.device("cpu"))
    train_cfg = tsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
    opt = tsft.make_optimizer(train_cfg)
    state = opt.init(adapter_leaves(adapters))
    step = tsft.make_lora_train_step(tcfg, train_cfg, opt, SCALE)
    adapters, state, m = step(adapters, state, batch, base)

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=TOL, rtol=0)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), atol=0, rtol=TOL)
    assert int(m["num_target_tokens"]) == int(jm["num_target_tokens"]) > 0
    assert state["count"] == 1
    assert state["adamw"].param_groups[0]["params"] == adapter_leaves(adapters)
    moved = 0
    for layer, jlayer, tlayer in zip(adapters["layers"], jnew["layers"], tree["layers"]):
        for name, ab in layer.items():
            for k in ("a", "b"):
                got, want = ab[k].detach().numpy(), np.asarray(jlayer[name][k])
                np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=f"{name}.{k}")
                moved += int((np.abs(got - tlayer[name][k]) > LR / 2).sum())
    assert moved > 0
    for x, y in zip(TP.leaves(base), before):
        assert x.grad is None and not x.requires_grad and torch.equal(x, y)


@pytest.fixture(scope="module")
def hf_pair():
    """The tiny HF Qwen2.5-VL of tests/test_model_parity.py and the port's
    config and params loaded from its state dict."""
    return hf_tiny()


@pytest.mark.parametrize("grid", [(1, 4, 8), (2, 6, 10)])
def test_sft_loss_matches_hf(hf_pair, grid):
    from open_o3_video_tpu_torch.models.qwen25vl.model import get_rope_index

    hf, cfg, params = hf_pair
    r = rng(23)
    t, h, w = grid
    n_patches = t * h * w
    pixel = r.standard_normal((n_patches, cfg.vision.patch_dim)).astype(np.float32)
    grid_thw = np.array([[t, h, w]])
    ids = (r.integers(0, 400, 5).tolist() + [cfg.vision_start_token_id]
           + [cfg.image_token_id] * (n_patches // 4) + [cfg.vision_end_token_id]
           + r.integers(0, 400, 9).tolist())
    input_ids = np.array([ids])
    labels = tsft.mask_labels(input_ids, -1, (cfg.image_token_id,))
    labels[0, :3] = tsft.IGNORE_INDEX  # a masked prompt head, as the collate's pad would be
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(input_ids), pixel_values=torch.from_numpy(pixel),
                  image_grid_thw=torch.from_numpy(grid_thw),
                  labels=torch.from_numpy(labels)).loss
        position_ids, _ = get_rope_index(cfg, input_ids, image_grid_thw=grid_thw)
        got, aux = tsft.sft_loss(params, cfg, {
            "input_ids": input_ids, "labels": labels, "position_ids": position_ids,
            "pixel_patches": pixel, "grid_thw": grid_thw,
            "vision_token_id": cfg.image_token_id}, remat=False)
    assert int(aux["num_target_tokens"]) == int((labels[0, 1:] != tsft.IGNORE_INDEX).sum())
    np.testing.assert_allclose(float(got), float(want), atol=TOL, rtol=0)
