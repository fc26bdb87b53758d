"""Pipeline parallelism in the port (``parallel/pipeline.py``) against the
JAX package's sequential decoder, at tiny dims in float32 on the CPU. One
group of two gloo ranks (``_torch_dist.check_pipeline``), 2 stages x 2
microbatches over a 4-layer decoder:

- ``pipeline_text_forward``'s hidden states (after the final norm, the
  same on both stages) against JAX's ``text_forward`` within 2e-5, and the
  gradients of a weighted sum of them w.r.t. each stage's layers and the
  input embeddings against ``jax.vjp`` of the same sum within 3e-5 (JAX's
  bounds for its pipeline, ``tests/test_pipeline.py:54, 81``);
- the stacking round trip, and ``dryrun_pipeline_step`` (forward, backward
  through the stages' sends, AdamW) against the same step without the
  pipeline on each rank.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_dist import run_group
from _torch_parity import jax_params_numpy, tiny_configs

from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.parallel.pipeline import (stack_pipeline_params,
                                                       unstack_pipeline_params)

B, S = 4, 12
LAYERS = 4


def _configs():
    jcfg, tcfg = tiny_configs()
    return (dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text,
                                                               num_hidden_layers=LAYERS)),
            dataclasses.replace(tcfg, text=dataclasses.replace(tcfg.text,
                                                               num_hidden_layers=LAYERS)))


def _jax_reference(jcfg, weights, inp):
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.models.qwen25vl.text import text_forward

    def f(text, embeds):
        hidden, _ = text_forward(text, jcfg.text, embeds, jnp.asarray(inp["pos"]))
        return hidden

    text = jax.tree.map(jnp.asarray, weights["text"])
    hidden, vjp = jax.vjp(f, text, jnp.asarray(inp["embeds"]))
    gtext, gembeds = vjp(jnp.asarray(inp["weights"]))
    return np.asarray(hidden), jax.tree.map(np.asarray, gtext["layers"]), np.asarray(gembeds)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    from open_o3_video_tpu_torch.models.qwen25vl.model import get_rope_index

    jcfg, tcfg = _configs()
    weights = jax_params_numpy(jcfg, 0)
    params = TP.from_jax_params(weights, tcfg, torch.device("cpu"))
    r = np.random.default_rng(9)
    ids = r.integers(5, 99, (B, S))
    inp = {"cfg": tcfg, "params": params, "pos": get_rope_index(tcfg, ids)[0],
           "embeds": r.standard_normal((B, S, tcfg.text.hidden_size)).astype(np.float32),
           "weights": r.standard_normal((B, S, tcfg.text.hidden_size)).astype(np.float32)}
    work = tmp_path_factory.mktemp("pipeline")
    torch.save(inp, work / "inputs.pt")
    outs, ref = run_group("pipeline", 2, work,
                          meanwhile=lambda: _jax_reference(jcfg, weights, inp))
    return outs, ref


def test_forward_matches_jax_sequential(group):
    outs, (hidden, _, _) = group
    for out in outs:
        np.testing.assert_allclose(out["hidden"], hidden, atol=2e-5, rtol=0)


def test_gradients_match_jax_sequential(group):
    outs, (_, layer_grads, embeds_grad) = group
    per = LAYERS // 2
    for out in outs:
        mine = layer_grads[out["stage"] * per:(out["stage"] + 1) * per]
        ours = unstack_pipeline_params({k: torch.as_tensor(v) for k, v in out["grads"].items()})
        for a, b in zip(ours, mine):
            port = TP.to_jax_layout({"text": {"layers": [a]}})["text"]["layers"][0]
            for name in b:
                np.testing.assert_allclose(port[name], b[name], atol=3e-5, rtol=0,
                                           err_msg=name)
        np.testing.assert_allclose(out["embeds_grad"], embeds_grad, atol=3e-5, rtol=0)


def test_dryrun_step_matches_its_sequential_step(group):
    outs, _ = group
    for out in outs:
        res = out["dryrun"]
        assert np.isfinite(res["loss"])
        np.testing.assert_allclose(res["loss"], res["sequential_loss"], atol=2e-5, rtol=0)
        assert res["hidden_err"] <= 2e-5 and res["grad_err"] <= 3e-5, res
    assert outs[0]["dryrun"]["loss"] == outs[1]["dryrun"]["loss"]


def test_stack_round_trip():
    _, tcfg = _configs()
    layers = TP.init(tcfg, 0, torch.device("cpu"))["text"]["layers"]
    back = unstack_pipeline_params(stack_pipeline_params(layers))
    assert len(back) == LAYERS
    for a, b in zip(back, layers):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
