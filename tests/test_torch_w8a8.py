"""w8a8 serving (``ops/quant.py`` ``a8_acts``, ``init(quantize_vision=...)``
and the engine's ``a8_prefill``) against the JAX package on the CPU, at tiny
dims with inputs made from a numpy seed: activation quantization and the
a8 product bit for bit (widths that are not multiples of 8, admissions of
1-4 rows), leaf types and carried bytes, a quantized model's logits and
greedy engine tokens with ``quantize_text`` + ``quantize_vision`` +
``a8_prefill`` (JAX at ``O3V_PALLAS_INTERPRET=1``), the scope's bounds (no
decode segment, other engine or other thread runs under it), and
``QwenVLEngine``'s knobs. On the card: ``torch._int_mm`` with its padding
against the CPU's exact product."""

import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_MODEL, cuda_device, frames, normal, rng

from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.engine import engine as engine_module
from open_o3_video_tpu_torch.ops import quant as Q
from open_o3_video_tpu_torch.ops.preprocess import frames_as_images_patches

# The vision MLP width of Qwen2.5-VL-7B (3420) is not a multiple of 8, which
# torch._int_mm needs of K and N: the tiny configs here keep that property.
MLP = 100
SAMPLING = dict(temperature=0.0, repetition_penalty=1.05, max_tokens=8)


def _x(r, *shape, dtype=np.float32):
    x = normal(r, *shape)
    x[..., 0, :] = 0.0  # a zero row: scale 1
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_acts_equals_jax(dtype):
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.quant import quantize_acts

    x = _x(rng(0), 3, 5, 40)
    x[0, 1, :4] = [127.0, 0.5, -0.5, 63.5]  # scale 1: ties on .5 round to even
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    q, s = Q.quantize_acts(xt)
    jq, js = quantize_acts(xj)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (3, 5, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("K,N", [(64, MLP), (MLP, 64)])
def test_a8_dense_equals_jax_bit_for_bit(K, N):
    """Admissions of 1-4 rows (an lm_head over the last rows) and a (2, 3)
    batch, f32 and bf16 activations, through JAX's a8_acts and the port's.
    JAX runs op by op: jitted, XLA's fusions round some outputs an ulp
    away from its own ops."""
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.quant import a8_acts, dense, quantize_weight

    r = rng(K + N)
    w = normal(r, K, N, scale=0.05)
    jw, tw = quantize_weight(jnp.asarray(w)), Q.quantize_weight(torch.from_numpy(w))
    for shape in [(1, K), (2, K), (3, K), (4, K), (2, 3, K)]:
        for dt in ("float32", "bfloat16"):
            x = _x(r, *shape)
            xt = torch.from_numpy(x).to(getattr(torch, dt))
            with a8_acts(True):
                theirs = np.asarray(dense(jnp.asarray(x).astype(getattr(jnp, dt)), jw)
                                    .astype(jnp.float32))
            with Q.a8_acts(True):
                ours = Q.dense(xt, tw)
            assert ours.dtype == xt.dtype and ours.shape == (*shape[:-1], N)
            np.testing.assert_array_equal(ours.float().numpy(), theirs)


def test_quantized_linear_pads_once_and_keeps_its_bytes():
    """The int8 bytes are stored once, column-major, zero-padded to
    multiples of 8 (``w_mm``); ``w_q`` is its view at the logical shape,
    byte for byte JAX's; the w8 product reads that view."""
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.quant import quantize_weight

    w = normal(rng(1), MLP, 60, scale=0.05)
    t = Q.quantize_weight(torch.from_numpy(w))
    assert t.w_mm.shape == (104, 64) and t.w_mm.stride() == (1, 104)
    assert t.w_q.shape == (MLP, 60) and t.w_q.data_ptr() == t.w_mm.data_ptr()
    assert not t.w_mm[MLP:].any() and not t.w_mm[:, 60:].any()
    np.testing.assert_array_equal(t.w_q.numpy(), np.asarray(quantize_weight(jnp.asarray(w)).w_q))
    aligned = Q.quantize_weight(torch.from_numpy(normal(rng(2), 64, 48)))
    assert aligned.w_mm.shape == aligned.w_q.shape == (64, 48)
    assert aligned.w_q.stride() == (1, 64)
    x = torch.from_numpy(normal(rng(3), 5, MLP))
    torch.testing.assert_close(Q.dense(x, t), ((x @ t.w_q.float()) * t.scale).to(x.dtype),
                               rtol=0, atol=0)


def test_a8_scope_is_the_calling_threads():
    seen = {}
    with Q.a8_acts(True):
        assert Q.a8_active()
        t = threading.Thread(target=lambda: seen.setdefault("other", Q.a8_active()))
        t.start()
        t.join()
        with Q.a8_acts(False):
            assert not Q.a8_active()
        assert Q.a8_active()
    assert not Q.a8_active() and seen == {"other": False}


@pytest.mark.cuda
def test_int_mm_route_equals_the_exact_product_on_the_card():
    """torch._int_mm with rows padded to 17 and K/N padded to 8 (the 7B
    tower's 3420-wide MLP) against the CPU's exact int32 product, bit for
    bit after the same epilogue."""
    dev = cuda_device()
    r = rng(4)
    for K, N in [(1280, 3420), (3420, 1280), (3584, 512)]:
        w = Q.quantize_weight(torch.from_numpy(normal(r, K, N, scale=0.02)))
        wd = Q.QuantizedLinear(w.w_q.to(dev), w.scale.to(dev))
        for M in (1, 4, 16, 17, 40):
            x = torch.from_numpy(normal(r, M, K)).to(torch.bfloat16)
            with Q.a8_acts(True):
                cpu = Q.dense(x, w)
                card = Q.dense(x.to(dev), wd)
            torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=0)


@pytest.mark.cuda
def test_quantized_bytes_on_the_card_equal_the_cpus():
    """int8 and int4 weights and int8 activations quantized on the card
    equal the CPU's (JAX's semantics) byte for byte: every scale divides by
    a device tensor, never by a Python scalar (a product with its
    reciprocal on CUDA, an ulp off)."""
    from open_o3_video_tpu_torch.ops import int4 as I4

    dev = cuda_device()
    r = rng(5)
    w = torch.from_numpy(normal(r, 512, 384, scale=0.02)).to(torch.bfloat16)
    a, b = Q.quantize_weight(w), Q.quantize_weight(w.to(dev))
    torch.testing.assert_close(b.w_q.cpu(), a.w_q, rtol=0, atol=0)
    torch.testing.assert_close(b.scale.cpu(), a.scale, rtol=0, atol=0)
    a, b = I4.quantize_weight_int4(w), I4.quantize_weight_int4(w.to(dev))
    torch.testing.assert_close(b.w_p.cpu(), a.w_p, rtol=0, atol=0)
    torch.testing.assert_close(b.scale.cpu(), a.scale, rtol=0, atol=0)
    x = torch.from_numpy(normal(r, 64, 512)).to(torch.bfloat16)
    (qa, sa), (qb, sb) = Q.quantize_acts(x), Q.quantize_acts(x.to(dev))
    torch.testing.assert_close(qb.cpu(), qa, rtol=0, atol=0)
    torch.testing.assert_close(sb.cpu(), sa, rtol=0, atol=0)


# ------------------------------------------------------------------ params


def _configs(vision_hidden: int = 64):
    """(JAX, port) tiny configs with MLP widths of MLP in the ViT and the
    decoder; ``vision_hidden`` 128 makes qkv_w/proj_w/gate_w/up_w int4-
    eligible (in-dim a multiple of 128) and leaves down_w int8."""
    from _torch_parity import tiny_configs

    out = []
    for cfg in tiny_configs():
        out.append(dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, hidden_size=vision_hidden,
                                            intermediate_size=MLP),
            text=dataclasses.replace(cfg.text, intermediate_size=MLP)))
    return out


def _kind(leaf) -> str:
    return type(leaf).__name__ if hasattr(leaf, "scale") else "tensor"


@pytest.mark.parametrize("mode", [True, "int4"])
def test_init_quantize_vision_gives_jax_leaf_types(mode):
    import jax

    from open_o3_video_tpu.models.qwen25vl import params as JP
    from open_o3_video_tpu_torch.models.qwen25vl import params as TP

    jcfg, tcfg = _configs(vision_hidden=128)
    theirs = jax.eval_shape(lambda: JP.init(jcfg, 0, quantize_vision=mode))
    ours = TP.init(tcfg, 0, torch.device("cpu"), quantize_vision=mode)
    for t_block, j_block in zip(ours["visual"]["blocks"], theirs["visual"]["blocks"]):
        for name, leaf in t_block.items():
            assert _kind(leaf) == _kind(j_block[name]), name
            assert tuple(leaf.shape) == tuple(j_block[name].shape), name
    block = ours["visual"]["blocks"][0]
    want = "Int4Linear" if mode == "int4" else "QuantizedLinear"
    assert _kind(block["qkv_w"]) == _kind(block["gate_w"]) == want
    assert _kind(block["down_w"]) == "QuantizedLinear"
    assert _kind(ours["visual"]["patch_embed"]) == _kind(ours["visual"]["merger"]["fc1_w"]) \
        == _kind(ours["text"]["layers"][0]["q_w"]) == "tensor"
    plain = TP.init(tcfg, 0, torch.device("cpu"))
    torch.testing.assert_close(ours["text"]["embed_tokens"], plain["text"]["embed_tokens"])


@functools.cache
def _a8_pair():
    """The tiny MLP-100 model in both packages with int8 decoder and ViT
    blocks: JAX's init quantized by JAX, carried by from_jax_params."""
    import jax

    from _torch_parity import jax_params_numpy

    from open_o3_video_tpu.ops.quant import (
        DEFAULT_QUANT_PATTERNS,
        VISION_QUANT_PATTERNS,
        quantize_params,
    )
    from open_o3_video_tpu_torch.models.qwen25vl import params as TP

    jcfg, tcfg = _configs()
    plain = jax_params_numpy(jcfg, 0)
    tree = jax.tree.map(np.asarray, quantize_params(
        plain, DEFAULT_QUANT_PATTERNS + VISION_QUANT_PATTERNS))
    tparams = TP.from_jax_params(tree, tcfg, torch.device("cpu"))
    return jcfg, jax.tree.map(jax.numpy.asarray, tree), tcfg, tparams, plain


def test_from_jax_params_carries_quantized_vision_leaves():
    """JAX's int8 ViT leaves keep their bytes; quantize_vision on a plain
    tree quantizes the same leaves to the same bytes."""
    from open_o3_video_tpu_torch.models.qwen25vl import params as TP

    jcfg, jparams, tcfg, tparams, plain = _a8_pair()
    j = jparams["visual"]["blocks"][1]
    t = tparams["visual"]["blocks"][1]
    quantized = TP.from_jax_params(plain, tcfg, torch.device("cpu"), quantize_vision=True)
    for name in ("qkv_w", "proj_w", "gate_w", "up_w", "down_w"):
        for ours in (t[name], quantized["visual"]["blocks"][1][name]):
            assert isinstance(ours, Q.QuantizedLinear), name
            np.testing.assert_array_equal(ours.w_q.numpy(), np.asarray(j[name].w_q))
            np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(j[name].scale))
    assert isinstance(quantized["visual"]["patch_embed"], torch.Tensor)
    assert isinstance(quantized["text"]["layers"][0]["q_w"], torch.Tensor)


def _vision_request(cfg, seed: int, tail):
    x = frames(rng(seed), 2, 28, 56)
    patches, grid = frames_as_images_patches(x)
    n_tok = patches.shape[0] // cfg.vision.merge_unit
    ids = [7, 8, cfg.vision_start_token_id] + [cfg.image_token_id] * n_tok + [
        cfg.vision_end_token_id] + tail
    return Request(ids, pixel_patches=patches, grid_thw=grid, vision_token_id=cfg.image_token_id)


def test_a8_model_logits_equal_jax(monkeypatch):
    """One forward of the w8a8 model over a vision request (the tower and
    the decoder under a8_acts) against JAX's: the int32 products are exact,
    so only the float32 sums around them differ."""
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.models.qwen25vl import get_rope_index as jax_rope_index
    from open_o3_video_tpu.models.qwen25vl.model import forward as jax_forward
    from open_o3_video_tpu.ops.quant import a8_acts
    from open_o3_video_tpu_torch.models.qwen25vl import forward, get_rope_index

    monkeypatch.setenv("O3V_PALLAS_INTERPRET", "1")
    jcfg, jparams, tcfg, tparams, _ = _a8_pair()
    req = _vision_request(tcfg, 0, [20, 21, 22])
    ids = np.asarray([req.input_ids])
    jpos, _ = jax_rope_index(jcfg, ids, image_grid_thw=req.grid_thw)
    tpos, _ = get_rope_index(tcfg, ids, image_grid_thw=req.grid_thw)
    kw = dict(grid_thw=req.grid_thw, vision_token_id=tcfg.image_token_id)
    with a8_acts(True):
        theirs = np.asarray(jax.jit(lambda p, i, pos, x: jax_forward(
            p, jcfg, i, pos, pixel_patches=x, **kw)[0])(
                jparams, jnp.asarray(ids), jnp.asarray(jpos), jnp.asarray(req.pixel_patches)))
    before = Q.A8_MATMULS["exact"]
    with Q.a8_acts(True):
        ours = forward(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(tpos),
                       pixel_patches=torch.from_numpy(req.pixel_patches), **kw)[0].numpy()
    v, t = tcfg.vision, tcfg.text
    assert Q.A8_MATMULS["exact"] - before == 5 * v.depth + 7 * t.num_hidden_layers + 1
    np.testing.assert_allclose(ours, theirs, atol=ATOL_MODEL, rtol=0)


def test_a8_engine_greedy_tokens_equal_jax(monkeypatch):
    """quantize_text + quantize_vision + a8_prefill in both engines: a vision
    request and two text requests (admissions of a few rows), greedy."""
    import jax.numpy as jnp

    from open_o3_video_tpu.engine import InferenceEngine as JaxEngine
    from open_o3_video_tpu.engine import Request as JaxRequest
    from open_o3_video_tpu.engine import SamplingParams as JaxSampling

    monkeypatch.setenv("O3V_PALLAS_INTERPRET", "1")
    jcfg, jparams, tcfg, tparams, _ = _a8_pair()
    reqs = [_vision_request(tcfg, 1, [20, 21]), Request(rng(2).integers(5, 90, 13).tolist()),
            Request(rng(3).integers(5, 90, 7).tolist())]
    engine = InferenceEngine(tparams, tcfg, cache_dtype=torch.float32, a8_prefill=True)
    ours = engine.generate(reqs, SamplingParams(**SAMPLING), return_logprobs=True)
    fields = [f.name for f in dataclasses.fields(Request)]
    theirs = JaxEngine(jparams, jcfg, prompt_buckets=(64,), cache_dtype=jnp.float32,
                       a8_prefill=True).generate(
        [JaxRequest(**{f: getattr(r, f) for f in fields}) for r in reqs],
        JaxSampling(**SAMPLING), return_logprobs=True)
    for o, t in zip(ours, theirs):
        assert o["token_ids"] == [int(x) for x in t["token_ids"]]
        np.testing.assert_allclose(o["logprobs"], t["logprobs"], atol=ATOL_MODEL)
        assert 1 <= len(o["token_ids"]) <= SAMPLING["max_tokens"]
    w8 = InferenceEngine(tparams, tcfg, cache_dtype=torch.float32).generate(
        reqs, SamplingParams(**SAMPLING), return_logprobs=True)
    assert any(not np.allclose(a["logprobs"], b["logprobs"], atol=ATOL_MODEL, rtol=0)
               for a, b in zip(ours, w8))  # a8 really changed the prefill


def test_a8_scope_stays_out_of_decode_and_other_engines(monkeypatch):
    """An a8 engine admits a long prompt in chunks while another row
    decodes: every prefill chunk and the tower run under a8, no decode step
    does. An engine without a8_prefill, called inside an enclosing a8
    scope, prefills without it; the scope is closed after each call."""
    _, _, tcfg, tparams, _ = _a8_pair()
    seen = {"decode": [], "prefill": [], "tower": []}
    real_step, real_fwd = InferenceEngine._decode_step, engine_module.text_forward
    real_tower = engine_module.encode_vision

    def step(self, st, sampling):
        seen["decode"].append(Q.a8_active())
        return real_step(self, st, sampling)

    def fwd(*a, **kw):
        if kw.get("validity_only") is not True:
            seen["prefill"].append(Q.a8_active())
        return real_fwd(*a, **kw)

    def tower(*a, **kw):
        seen["tower"].append(Q.a8_active())
        return real_tower(*a, **kw)

    monkeypatch.setattr(InferenceEngine, "_decode_step", step)
    monkeypatch.setattr(engine_module, "text_forward", fwd)
    monkeypatch.setattr(engine_module, "encode_vision", tower)
    short = _vision_request(tcfg, 4, [20])
    reqs = [short, Request(rng(5).integers(5, 90, 12).tolist()),
            Request(rng(6).integers(5, 90, 40).tolist())]
    knobs = dict(cache_dtype=torch.float32, a8_prefill=True, prefill_chunk=16, max_slots=2,
                 decode_segment=2)
    # The EOS moved to the token the first request emits at step 2: its slot
    # frees while the second decodes, and the third admits in chunks.
    eos = InferenceEngine(tparams, tcfg, **knobs).generate(
        [short], SamplingParams(**SAMPLING))[0]["token_ids"][2]
    engine = InferenceEngine(tparams, dataclasses.replace(tcfg, eos_token_id=eos), **knobs)
    for k in seen:
        seen[k].clear()
    engine.generate(reqs, SamplingParams(**SAMPLING))
    assert engine.counters["interleaved_segments"] >= 1 and engine.counters["prefills"] >= 4
    assert seen["decode"] and not any(seen["decode"])
    assert seen["prefill"] and all(seen["prefill"]) and seen["tower"] == [True]
    assert not Q.a8_active()
    for k in seen:
        seen[k].clear()
    other = InferenceEngine(tparams, tcfg, cache_dtype=torch.float32)
    with Q.a8_acts(True):
        other.generate([short], SamplingParams(**SAMPLING))
    assert seen["tower"] == [False] and not any(seen["prefill"]) and not any(seen["decode"])


def test_qwen_vl_engine_serves_both_knobs(monkeypatch):
    """QwenVLEngine passes a8_prefill to its engine and quantize_vision to
    load_pretrained with the decoder's mode, as JAX's wrapper does; the
    ViT blocks of an HF state dict then load int8."""
    from open_o3_video_tpu_torch.data.processor import O3VideoProcessor
    from open_o3_video_tpu_torch.eval import model_engine
    from open_o3_video_tpu_torch.models.qwen25vl import params as TP

    _, _, tcfg, tparams, _ = _a8_pair()
    plain = TP.init(tcfg, 0, torch.device("cpu"))
    got = {}

    def load(model_dir, device, cfg, quantize_text=False, quantize_vision=False):
        got.update(quantize_text=quantize_text, quantize_vision=quantize_vision)
        named = ((k, v.clone()) for k, v in TP.hf_named_tensors(plain, tcfg))
        return TP.from_hf_state_dict(named, tcfg, device, quantize_text=quantize_text,
                                     quantize_vision=quantize_vision), tcfg

    monkeypatch.setattr(model_engine.P, "load_pretrained", load)
    monkeypatch.setattr(O3VideoProcessor, "from_pretrained", classmethod(lambda cls, d: cls()))
    model = model_engine.QwenVLEngine("some/dir", device="cpu", load_in_int8=True,
                                      quantize_vision=True, a8_prefill=True)
    assert got == {"quantize_text": True, "quantize_vision": True}
    assert model.engine.a8_prefill is True
    blocks = model.engine.params["visual"]["blocks"]
    assert isinstance(blocks[0]["down_w"], Q.QuantizedLinear)
    ref = Q.quantize_weight(plain["visual"]["blocks"][0]["down_w"])
    torch.testing.assert_close(blocks[0]["down_w"].w_q, ref.w_q, rtol=0, atol=0)
    assert isinstance(model.engine.params["visual"]["merger"]["fc1_w"], torch.Tensor)
