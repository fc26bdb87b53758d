"""Int8 weights and the quantized model (open_o3_video_tpu_torch/ops/quant.py,
params.init/from_jax_params with quantized leaves) against the JAX package
on the same numpy weights: int8 bytes, ``dense`` dispatch, the leaf types
``init(quantize_text=...)`` gives, and int4/int8 models end to end (logits
and greedy engine tokens). JAX's int4 matmuls on eligible shapes run its
Pallas kernel in interpret mode (``O3V_PALLAS_INTERPRET=1``), as on a TPU;
attention stays XLA on the CPU."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_MODEL, normal, rng

from open_o3_video_tpu_torch.ops import int4 as I4
from open_o3_video_tpu_torch.ops import quant as Q


def _int8_pair(w):
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.quant import quantize_weight

    return quantize_weight(jnp.asarray(w)), Q.quantize_weight(torch.from_numpy(w))


@pytest.mark.parametrize("kind", ["random", "ties and a zero column"])
def test_quantize_weight_bytes_equal_jax(kind):
    w = normal(rng(0), 96, 48, scale=0.05)
    if kind != "random":
        w[:, 0] = np.linspace(-127, 127, 96)
        w[:8, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]  # scale 1: ties on .5
        w[:, 1] = 0.0
    jq, tq = _int8_pair(w)
    assert tq.w_q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(tq.w_q.numpy(), np.asarray(jq.w_q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))


@pytest.mark.parametrize("kind", ["tensor", "int8", "int4 kernel route", "int4 fallback"])
def test_dense_dispatch_matches_jax(monkeypatch, kind):
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.int4 import quantize_weight_int4
    from open_o3_video_tpu.ops.quant import dense

    monkeypatch.setenv("O3V_PALLAS_INTERPRET", "1")
    r = rng(3)
    N = 64 if kind == "int4 fallback" else 128
    w, x = normal(r, 256, N, scale=0.05), normal(r, 2, 3, 256)
    if kind == "tensor":
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
    elif kind == "int8":
        jw, tw = _int8_pair(w)
    else:
        jw, tw = quantize_weight_int4(jnp.asarray(w)), I4.quantize_weight_int4(torch.from_numpy(w))
    ours = Q.dense(torch.from_numpy(x), tw).numpy()
    theirs = np.asarray(dense(jnp.asarray(x), jw))
    assert ours.shape == theirs.shape == (2, 3, N)
    if kind == "int4 kernel route":  # bf16 output: one ulp where sums round apart
        assert (np.abs(ours - theirs) <= np.spacing(np.abs(theirs)) * 2.0 ** 16).all()
    else:
        np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)


def test_dense_rejects_unknown_weights():
    with pytest.raises(TypeError, match="unsupported"):
        Q.dense(torch.ones(2, 4), object())


def test_quantize_params_and_bytes_match_jax():
    from _torch_parity import jax_params_numpy, tiny_configs

    from open_o3_video_tpu.ops.quant import QuantizedLinear as JaxInt8
    from open_o3_video_tpu.ops.quant import param_bytes, quantize_params
    from open_o3_video_tpu_torch.models.qwen25vl import params as TP

    jcfg, tcfg = tiny_configs()
    tree = jax_params_numpy(jcfg)
    theirs = quantize_params(tree)
    ours = Q.quantize_params(TP.from_jax_params(tree, tcfg, torch.device("cpu")))
    for name in ("q_w", "o_w", "down_w"):
        t, j = ours["text"]["layers"][0][name], theirs["text"]["layers"][0][name]
        assert isinstance(t, Q.QuantizedLinear) and isinstance(j, JaxInt8)
        np.testing.assert_array_equal(t.w_q.numpy(), np.asarray(j.w_q))
    assert isinstance(ours["text"]["lm_head"], Q.QuantizedLinear)
    assert Q.param_bytes(ours) == param_bytes(theirs)


def _configs(intermediate: int = 384):
    """(JAX, port) configs with a decoder whose shapes K7 covers: hidden 256,
    2 heads of 128 over 1 kv head (the head_dim the CUDA kernels are built
    for), vocab 512; the tiny ViT. ``intermediate`` 320 makes down_w int8
    (in-dim not a multiple of 128) and gate/up int4 on the fallback."""
    from _torch_parity import tiny_configs

    out = []
    for cfg in tiny_configs():
        out.append(dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, hidden_size=256, num_attention_heads=2, num_key_value_heads=1,
            intermediate_size=intermediate, mrope_section=(16, 24, 24))))
    return out


def _kind(leaf) -> str:
    """The quantized class's name, or "tensor" (an array or a JAX shape)."""
    return type(leaf).__name__ if hasattr(leaf, "scale") else "tensor"


@pytest.mark.parametrize("mode", [True, "int8", "int4"])
def test_init_quantize_text_gives_jax_leaf_types(mode):
    import jax

    from open_o3_video_tpu.models.qwen25vl import params as JP
    from open_o3_video_tpu_torch.models.qwen25vl import params as TP

    jcfg, tcfg = _configs(intermediate=320)
    theirs = jax.eval_shape(lambda: JP.init(jcfg, 0, quantize_text=mode))
    ours = TP.init(tcfg, 0, torch.device("cpu"), quantize_text=mode)
    kinds = {}
    for t_layer, j_layer in zip(ours["text"]["layers"], theirs["text"]["layers"]):
        for name, leaf in t_layer.items():
            assert _kind(leaf) == _kind(j_layer[name]), name
            assert tuple(leaf.shape) == tuple(j_layer[name].shape), name
            kinds[name] = _kind(leaf)
    assert _kind(ours["text"]["lm_head"]) == _kind(theirs["text"]["lm_head"])
    if mode == "int4":
        assert kinds["q_w"] == "Int4Linear" and kinds["down_w"] == "QuantizedLinear"
    else:
        assert kinds["q_w"] == kinds["down_w"] == "QuantizedLinear"
    assert kinds["q_b"] == "tensor" and _kind(ours["text"]["embed_tokens"]) == "tensor"
    # the random draws do not depend on quantize_text
    plain = TP.init(tcfg, 0, torch.device("cpu"))
    torch.testing.assert_close(ours["text"]["embed_tokens"], plain["text"]["embed_tokens"])


@functools.cache
def _quantized_pair(kind: str, seed: int = 0):
    """A model in both packages with the same quantized weights: the JAX
    init quantized by JAX, carried to the port by from_jax_params."""
    import jax

    from _torch_parity import jax_params_numpy, tiny_configs

    from open_o3_video_tpu.ops.int4 import quantize_params_int4
    from open_o3_video_tpu.ops.quant import quantize_params
    from open_o3_video_tpu_torch.models.qwen25vl import params as TP

    jcfg, tcfg = tiny_configs() if kind == "int4 fallback" else _configs()
    tree = jax_params_numpy(jcfg, seed)
    if kind == "int8":
        tree = quantize_params(tree)
    else:
        tree = quantize_params_int4(tree, group=32 if kind == "int4 fallback" else 128)
    tree = jax.tree.map(np.asarray, tree)
    return jcfg, jax.tree.map(jax.numpy.asarray, tree), tcfg, TP.from_jax_params(
        tree, tcfg, torch.device("cpu"))


def test_from_jax_params_carries_quantized_leaves():
    """int8 bytes and float32 scales unchanged, not cast to cfg.dtype; count,
    leaves and trainable see quantized leaves."""
    import jax

    from open_o3_video_tpu_torch.models.qwen25vl import params as TP

    jcfg, jparams, tcfg, _ = _quantized_pair("int4")
    tree = jax.tree.map(np.asarray, jparams)
    ours = TP.from_jax_params(tree, dataclasses.replace(tcfg, dtype=torch.bfloat16),
                              torch.device("cpu"))
    t, j = ours["text"]["layers"][0]["gate_w"], tree["text"]["layers"][0]["gate_w"]
    assert isinstance(t, I4.Int4Linear) and t.group == j.group == 128
    assert t.w_p.dtype == torch.int8 and t.scale.dtype == torch.float32
    np.testing.assert_array_equal(t.w_p.numpy(), j.w_p)
    np.testing.assert_array_equal(t.scale.numpy(), j.scale)
    assert ours["text"]["embed_tokens"].dtype == torch.bfloat16
    assert TP.count(ours) == TP.count(TP.init(tcfg, 0, torch.device("cpu")))
    assert any(x is t.w_p for x in TP.leaves(ours))
    TP.trainable(ours)
    assert not t.scale.requires_grad and ours["text"]["embed_tokens"].requires_grad


def _ids(seed: int, n: int):
    return rng(seed).integers(5, 99, size=n).tolist()


@pytest.mark.parametrize("kind", ["int4", "int4 fallback", "int8"])
def test_quantized_model_logits_match_jax(monkeypatch, kind):
    """Text-only forward of the whole model. int4: K7's route on both sides
    (JAX's Pallas kernel in interpret mode, the port's plain version) at
    group 128; "int4 fallback": the tiny config at group 32, whose N of 64
    (q, k, v, o, down) takes x @ dequantize(w, x.dtype) on both."""
    import jax.numpy as jnp

    from open_o3_video_tpu.models.qwen25vl import get_rope_index as jax_rope_index
    from open_o3_video_tpu.models.qwen25vl.model import forward as jax_forward
    from open_o3_video_tpu_torch.models.qwen25vl import forward, get_rope_index

    monkeypatch.setenv("O3V_PALLAS_INTERPRET", "1")
    jcfg, jparams, tcfg, tparams = _quantized_pair(kind)
    ids = np.asarray([_ids(1, 24), _ids(2, 24)])
    jpos, _ = jax_rope_index(jcfg, ids)
    tpos, _ = get_rope_index(tcfg, ids)
    theirs, _ = jax_forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(jpos))
    theirs = np.asarray(theirs)
    ours, _ = forward(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(tpos))
    ours = ours.numpy()
    if kind == "int8":
        np.testing.assert_allclose(ours, theirs, atol=ATOL_MODEL, rtol=0)
        return
    # K7's route rounds each matmul's output to bf16, as JAX's Pallas call
    # does (its out_shape is bf16 for float32 x too). The two packages' f32
    # sums in other orders round some elements one bf16 ulp apart, and those
    # flips carry through the layers: the logits are held to two bf16 ulps
    # at their largest magnitude, and a relative L2 error of bf16's epsilon.
    ulp = np.spacing(np.abs(theirs).max()) * 2.0 ** 16
    assert np.abs(ours - theirs).max() <= 2 * ulp
    assert np.linalg.norm(ours - theirs) <= 2.0 ** -8 * np.linalg.norm(theirs)


@pytest.mark.parametrize("kind", ["int4", "int8"])
def test_quantized_engine_greedy_tokens_match_jax(monkeypatch, kind):
    import jax.numpy as jnp

    from open_o3_video_tpu.engine import InferenceEngine as JaxEngine
    from open_o3_video_tpu.engine import Request as JaxRequest
    from open_o3_video_tpu.engine import SamplingParams as JaxSampling
    from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams

    monkeypatch.setenv("O3V_PALLAS_INTERPRET", "1")
    jcfg, jparams, tcfg, tparams = _quantized_pair(kind)
    prompts = [_ids(3, 20), _ids(4, 13)]
    sampling = dict(temperature=0.0, repetition_penalty=1.05, max_tokens=8)
    ours = InferenceEngine(tparams, tcfg, cache_dtype=torch.float32).generate(
        [Request(p) for p in prompts], SamplingParams(**sampling))
    theirs = JaxEngine(jparams, jcfg, prompt_buckets=(32,), cache_dtype=jnp.float32).generate(
        [JaxRequest(p) for p in prompts], JaxSampling(**sampling))
    for o, t in zip(ours, theirs):
        assert o["token_ids"] == [int(x) for x in t["token_ids"]]
        assert 1 <= len(o["token_ids"]) <= 8


def test_inference_example_int4_tiny_demo_runs():
    """scripts/inference_example_torch.py --load_in_int4 on the CPU: the
    demo model's decoder in int4 (K7's plain version)."""
    import os
    import subprocess
    import sys

    from _torch_parity import REPO_ROOT

    proc = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "scripts", "inference_example_torch.py"),
         "--tiny-demo", "--device", "cpu", "--nframes", "2", "--max_tokens", "3",
         "--questions", "What is shown?", "--load_in_int4"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[tiny-demo on cpu: 3 tokens generated" in proc.stdout
