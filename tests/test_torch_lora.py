"""LoRA in the port (``ops/quant.py:LoraLinear``, ``train/lora.py``) against
the JAX package's at tiny dims on the CPU: ``dense`` on a LoRA weight over a
plain and an int8 base, ``apply_adapters`` (the model's logits) and
``merge_adapters`` (every leaf and its dtype) with JAX's adapters converted
by ``params.adapters_from_jax``, JAX's ``LoraLinear`` leaves converted by
``from_jax_params``, and ``init_adapters``' distribution. Tolerances:
ATOL_OP for one op in float32, ATOL_MODEL for whole-model logits, 1e-6 for
merged weights (one float32 product and sum each), one bf16 ulp (2^-7
relative) for the bf16 ``dense``."""

import functools

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_MODEL, ATOL_OP, normal, rng, tiny_configs

from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.models.qwen25vl.model import forward as tforward
from open_o3_video_tpu_torch.models.qwen25vl.model import get_rope_index
from open_o3_video_tpu_torch.ops.quant import LoraLinear, QuantizedLinear, dense, quantize_weight
from open_o3_video_tpu_torch.train import lora as TL

CPU = torch.device("cpu")
LCFG = dict(rank=4, alpha=8.0, target_modules=("q_w", "v_w"), seed=1)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("base", ["plain", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_lora_matches_jax(base, dtype):
    import jax.numpy as jnp

    from open_o3_video_tpu.ops import quant as JQ

    r = rng(0)
    x, w = normal(r, 5, 16), normal(r, 16, 12, scale=0.3)
    a, b = normal(r, 16, 4, scale=0.5), normal(r, 4, 12, scale=0.5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jw = JQ.quantize_weight(jnp.asarray(w)) if base == "int8" else jnp.asarray(w, jdt)
    tw = quantize_weight(_t(w)) if base == "int8" else _t(w).to(tdt)
    want = np.asarray(JQ.dense(jnp.asarray(x, jdt), JQ.LoraLinear(jw, jnp.asarray(a, jdt),
                                                                  jnp.asarray(b, jdt), 0.75)),
                      np.float32)
    got = dense(_t(x).to(tdt), LoraLinear(tw, _t(a).to(tdt), _t(b).to(tdt), 0.75)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL_OP)
        plain = x @ (tw.w_q.float().numpy() * tw.scale.numpy() if base == "int8" else w)
        np.testing.assert_allclose(got, plain + 0.75 * (x @ a) @ b, atol=ATOL_OP)
    else:
        np.testing.assert_allclose(got, want, atol=2 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_lora_rounds_the_scale_once(monkeypatch, dtype):
    """dense on a LoraLinear gives the bits of the per-call rounding it
    replaced (a host tensor of the scale in x's dtype, read back), and once
    the rounding is cached, a call makes no host tensor."""
    r = rng(1)
    tdt = getattr(torch, dtype)
    x, w = _t(normal(r, 5, 16)).to(tdt), _t(normal(r, 16, 12, scale=0.3)).to(tdt)
    a, b = _t(normal(r, 16, 4, scale=0.5)).to(tdt), _t(normal(r, 4, 12, scale=0.5)).to(tdt)
    scale = 2.0 / 3.0  # rounds differently in bf16 and f32
    want = x @ w + ((x @ a) @ b) * torch.tensor(scale, dtype=tdt).item()
    lw = LoraLinear(w, a, b, scale)
    assert torch.equal(dense(x, lw), want)

    def no_host_tensor(*args, **kw):
        raise AssertionError("dense made a host tensor")

    monkeypatch.setattr(torch, "tensor", no_host_tensor)
    assert torch.equal(dense(x, lw), want)


def test_hf_target_names_normalize():
    assert TL.LoraConfig.normalize_targets(["q_proj", "v_proj"]) == ("q_w", "v_w")
    assert TL.LoraConfig.normalize_targets(["q_w", "down_proj"]) == ("q_w", "down_w")
    assert TL.LoraConfig().scale == 2.0 and TL.LoraConfig().target_modules == ("q_w", "v_w")


def test_init_adapters_draws_jax_distribution():
    """B = 0, A ~ N(0, 1) / sqrt(rank) in bf16, trainable, one per target of
    every decoder layer, the same draw for the same seed."""
    cfg = tiny_configs()[1]
    params = TP.init(cfg, 0, CPU)
    lcfg = TL.LoraConfig(rank=8, target_modules=("q_w", "v_w", "down_w"), seed=3)
    ad = TL.init_adapters(params, lcfg)
    assert len(ad["layers"]) == cfg.text.num_hidden_layers
    for layer, base in zip(ad["layers"], params["text"]["layers"]):
        assert set(layer) == {"q_w", "v_w", "down_w"}
        for name, ab in layer.items():
            assert ab["a"].shape == (base[name].shape[0], 8) and ab["b"].shape == (8, base[name].shape[1])
            assert ab["a"].dtype == ab["b"].dtype == torch.bfloat16
            assert ab["a"].requires_grad and ab["b"].requires_grad
            assert not ab["b"].any()
    a = torch.cat([x.float().flatten() for x in TL.adapter_leaves(ad)[0::2]])
    assert abs(a.mean().item()) < 0.03 and abs(a.std().item() * np.sqrt(8) - 1) < 0.03
    again = TL.init_adapters(params, lcfg)
    assert all(torch.equal(x, y) for x, y in zip(TL.adapter_leaves(ad), TL.adapter_leaves(again)))
    with pytest.raises(KeyError):
        TL.init_adapters(params, TL.LoraConfig(target_modules=("nope",)))


@functools.cache
def _pair(base: str):
    """(jax cfg, jax params, jax adapters with B != 0, port cfg, port params,
    port adapters): the JAX tiny init (int8 text for "int8"), adapters in
    float32 with a deterministic perturbation so the delta is not 0."""
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.models.qwen25vl import params as JP
    from open_o3_video_tpu.train import lora as JL

    jcfg, tcfg = tiny_configs()
    tree = jax.tree.map(np.asarray, jax.jit(functools.partial(
        JP.init, jcfg, 0, quantize_text=base == "int8"))())
    jparams = jax.tree.map(jnp.asarray, tree)
    jad = JL.init_adapters(jparams, JL.LoraConfig(**LCFG), dtype=jnp.float32)
    jad = jax.tree.map(
        lambda x: x + 0.02 * jnp.sin(jnp.arange(x.size, dtype=jnp.float32)).reshape(x.shape), jad)
    tparams = TP.from_jax_params(tree, tcfg, CPU)
    tad = TP.adapters_from_jax(jax.tree.map(np.asarray, jad), CPU)
    return jcfg, jparams, jad, tcfg, tparams, tad


def _ids():
    ids = rng(3).integers(5, 99, size=(2, 11))
    pos, _ = get_rope_index(tiny_configs()[1], ids)
    return ids, pos


@pytest.mark.parametrize("base", ["plain", "int8"])
def test_applied_adapters_give_jax_logits(base):
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.models.qwen25vl import forward as jforward
    from open_o3_video_tpu.train import lora as JL

    jcfg, jparams, jad, tcfg, tparams, tad = _pair(base)
    scale = TL.LoraConfig(**LCFG).scale
    ids, pos = _ids()
    want = jax.jit(lambda p, a, i, q: jforward(JL.apply_adapters(p, a, scale), jcfg, i, q)[0])(
        jparams, jad, jnp.asarray(ids), jnp.asarray(pos))
    combined = TL.apply_adapters(tparams, tad, scale)
    assert isinstance(combined["text"]["layers"][0]["q_w"], LoraLinear)
    assert combined["text"]["layers"][0]["q_w"].base is tparams["text"]["layers"][0]["q_w"]
    assert "q_w" in tparams["text"]["layers"][0] and not isinstance(
        tparams["text"]["layers"][0]["q_w"], LoraLinear)  # the base dict is untouched
    got, _ = tforward(combined, tcfg, _t(ids), _t(pos))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL_MODEL)
    base_logits, _ = tforward(tparams, tcfg, _t(ids), _t(pos))
    assert np.abs(got.detach().numpy() - base_logits.detach().numpy()).max() > 10 * ATOL_MODEL


@pytest.mark.parametrize("base", ["plain", "int8"])
def test_merged_weights_equal_jax(base):
    import jax

    from open_o3_video_tpu.train import lora as JL

    jcfg, jparams, jad, tcfg, tparams, tad = _pair(base)
    scale = TL.LoraConfig(**LCFG).scale
    want = jax.tree.map(np.asarray, JL.merge_adapters(jparams, jad, scale))
    got = TL.merge_adapters(tparams, tad, scale)
    flat_w = jax.tree.leaves_with_path(want)
    flat_g = jax.tree.leaves_with_path(got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert isinstance(g, torch.Tensor), jax.tree_util.keystr(path)
        assert str(g.dtype).split(".")[1] == str(w.dtype), jax.tree_util.keystr(path)
        np.testing.assert_allclose(g.detach().float().numpy(), w.astype(np.float32), atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    if base == "int8":  # every quantized leaf is dequantized
        assert isinstance(tparams["text"]["layers"][0]["up_w"], QuantizedLinear)


def test_jax_lora_leaves_convert():
    """JAX's grafted tree (LoraLinear leaves) -> from_jax_params: LoraLinear
    leaves over the converted base, the same logits as the port's graft."""
    import jax

    from open_o3_video_tpu.train import lora as JL

    jcfg, jparams, jad, tcfg, tparams, tad = _pair("int8")
    scale = TL.LoraConfig(**LCFG).scale
    tree = jax.tree.map(np.asarray, JL.apply_adapters(jparams, jad, scale))
    conv = TP.from_jax_params(tree, tcfg, CPU)
    leaf = conv["text"]["layers"][1]["v_w"]
    assert isinstance(leaf, LoraLinear) and isinstance(leaf.base, QuantizedLinear)
    assert leaf.scale == scale and leaf.a.shape == (64, 4)
    ids, pos = _ids()
    a, _ = tforward(conv, tcfg, _t(ids), _t(pos))
    b, _ = tforward(TL.apply_adapters(tparams, tad, scale), tcfg, _t(ids), _t(pos))
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_engine_serves_adapted_params():
    """A graft with B = 0 serves the base model's tokens; with B != 0 the
    engine serves the adapted model (another greedy continuation or the
    same, but its logits differ: checked above)."""
    from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams

    _, _, _, tcfg, tparams, tad = _pair("plain")
    zero = {"layers": [{n: {"a": ab["a"], "b": torch.zeros_like(ab["b"])} for n, ab in l.items()}
                       for l in tad["layers"]]}
    reqs = [Request(input_ids=list(range(40, 52)))]
    samp = SamplingParams(temperature=0.0, max_tokens=6)
    base = InferenceEngine(tparams, tcfg).generate(reqs, samp)
    adapted = InferenceEngine(TL.apply_adapters(tparams, zero, 2.0), tcfg).generate(reqs, samp)
    assert adapted[0]["token_ids"] == base[0]["token_ids"]
