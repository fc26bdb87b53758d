"""Aria in the port against the JAX package and HF transformers at tiny dims
(``tiny_aria``: a 2-block tower of 32, a projector of 3 queries over 4
patches, a 2-layer decoder of 48 with 4 experts, top 2, and 2 shared
experts). One module-scoped trio: HF's tiny ``AriaForConditionalGeneration``
(f32, weights from torch seed 0, built as ``tests/test_aria.py`` builds it),
its state dict loaded into JAX's tree and into the port.

- the config: the tiny one and its HF dict against JAX's, the round trip,
  and the published ``ARIA_CONFIG`` as transformers' ``AriaConfig`` reads it;
- ``get_image_features`` (tower + projector) against HF's and JAX's;
- multimodal and text-only logits against HF's and JAX's;
- the engine: a text request and a ``Request.vision_embeds`` request
  token for token against HF ``generate`` and JAX's engine, the same in
  chunks of 5 tokens (a chunk boundary inside the image rows), a pair of
  ``vision_embeds`` requests sharing a prefix (one prefix block) equal to
  each served plain, and the features as a tensor (the device path)
  equal to them as a numpy array;
- ``models.load_model`` / ``family_forward`` dispatch and the safetensors
  round trip both ways (the port's export read by JAX's ``load_model``);
- on the card (``cuda``): K3 at Aria's prefill (20 q heads over 20 KV
  heads of 128, a GQA group of 1) and K4 at group 1 against their plain
  versions.

Tolerances (f32 on the CPU): against JAX ATOL (1e-5; the packages sum in
different orders, ~1e-6 measured) and ATOL_MODEL (1e-4) for
log-probabilities; against HF the bounds of JAX's own ``test_aria.py``
(features 2e-5 absolute / 2e-4 relative, text logits 2e-4 / 2e-3,
multimodal 5e-4 / 5e-3).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_MODEL, cuda_device, rng

from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.models import aria as TA
from open_o3_video_tpu_torch.models import family_forward, is_aria, load_model

ATOL = 1e-5
GREEDY = SamplingParams(temperature=0.0, repetition_penalty=1.0, max_tokens=6)


@pytest.fixture(scope="module")
def trio():
    """(HF model, JAX params, JAX config, port params, port config)."""
    from transformers.models.aria import AriaConfig as HFAriaConfig
    from transformers.models.aria import AriaForConditionalGeneration, AriaTextConfig
    from transformers.models.idefics3 import Idefics3VisionConfig

    from open_o3_video_tpu.models.aria import params as JP
    from open_o3_video_tpu.models.aria import tiny_aria as jax_tiny

    cfg = TA.tiny_aria()
    v, t = cfg.vision, cfg.text
    hf_cfg = HFAriaConfig(
        vision_config=Idefics3VisionConfig(
            hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
            num_hidden_layers=v.num_hidden_layers, num_attention_heads=v.num_attention_heads,
            image_size=v.image_size, patch_size=v.patch_size, num_channels=v.in_channels,
            hidden_act="gelu_pytorch_tanh"),
        text_config=AriaTextConfig(
            vocab_size=t.vocab_size, hidden_size=t.hidden_size,
            intermediate_size=t.intermediate_size, num_hidden_layers=t.num_hidden_layers,
            num_attention_heads=t.num_attention_heads, num_key_value_heads=t.num_key_value_heads,
            rope_theta=t.rope_theta, rms_norm_eps=t.rms_norm_eps, attention_bias=False,
            moe_num_experts=t.moe_num_experts, moe_topk=t.moe_topk,
            moe_num_shared_experts=t.moe_num_shared_experts, tie_word_embeddings=False),
        projector_patch_to_query_dict={p: q for p, q in cfg.patch_to_query},
        image_token_id=cfg.image_token_id)
    torch.manual_seed(0)
    hf = AriaForConditionalGeneration(hf_cfg).eval().float()
    jcfg = jax_tiny()
    jparams = JP.from_torch_state_dict(hf.state_dict(), jcfg)
    params = TA.params.from_hf_state_dict(hf.state_dict().items(), cfg, torch.device("cpu"))
    return hf, jparams, jcfg, params, cfg


def _pixels(cfg, r, n=1):
    s = cfg.vision.image_size
    return r.standard_normal((n, 3, s, s)).astype(np.float32)


def _image_ids(cfg, r, pre=4, post=3):
    q = cfg.query_num(cfg.vision.num_patches_per_side ** 2)
    return (r.integers(5, 400, size=pre).tolist() + [cfg.image_token_id] * q
            + r.integers(5, 400, size=post).tolist())


def test_config_round_trip_and_the_published_config():
    import transformers

    from open_o3_video_tpu.models.aria import config as JC

    def fields(c):
        d = dataclasses.asdict(c)
        d.pop("dtype")
        return d

    tiny = TA.tiny_aria()
    assert fields(tiny) == fields(JC.tiny_aria())
    assert TA.AriaConfig.from_hf_dict(tiny.to_hf_dict(), dtype=tiny.dtype) == tiny
    assert tiny.to_hf_dict() == JC.AriaConfig.from_hf_dict(tiny.to_hf_dict()).to_hf_dict()
    ours = TA.AriaConfig.from_hf_dict(TA.ARIA_CONFIG)
    assert fields(ours) == fields(JC.AriaConfig.from_hf_dict(TA.ARIA_CONFIG))
    hf = transformers.AriaConfig(**json.loads(json.dumps(TA.ARIA_CONFIG)))
    t, ht, hv = ours.text, hf.text_config, hf.vision_config
    assert (t.hidden_size, t.intermediate_size, t.num_hidden_layers, t.num_attention_heads,
            t.num_key_value_heads, t.head_dim, t.moe_num_experts, t.moe_topk,
            t.moe_num_shared_experts, t.vocab_size, t.rms_norm_eps, t.rope_theta) == (
        ht.hidden_size, ht.intermediate_size, ht.num_hidden_layers, ht.num_attention_heads,
        ht.num_key_value_heads, ht.head_dim, ht.moe_num_experts, ht.moe_topk,
        ht.moe_num_shared_experts, ht.vocab_size, ht.rms_norm_eps, ht.rope_theta)
    v = ours.vision
    assert (v.hidden_size, v.intermediate_size, v.num_hidden_layers, v.num_attention_heads,
            v.image_size, v.patch_size, v.layer_norm_eps) == (
        hv.hidden_size, hv.intermediate_size, hv.num_hidden_layers, hv.num_attention_heads,
        hv.image_size, hv.patch_size, hv.layer_norm_eps)
    assert dict(ours.patch_to_query) == hf.projector_patch_to_query_dict
    assert ours.image_token_id == hf.image_token_id == 9
    assert (t.hidden_size, t.num_hidden_layers, t.moe_num_experts, t.moe_topk,
            t.intermediate_size, t.vocab_size) == (2560, 28, 64, 6, 1664, 100352)


def test_image_features_and_logits_match_hf_and_jax(trio):
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.models import aria as JA

    hf, jparams, jcfg, params, cfg = trio
    r = rng(1)
    pix = _pixels(cfg, r, 2)
    with torch.no_grad():
        want = hf.model.get_image_features(torch.from_numpy(pix), vision_feature_layer=-1)
        got = TA.get_image_features(params, cfg, torch.from_numpy(pix))
    want = (want[0] if isinstance(want, (list, tuple)) else want).reshape(-1, got.shape[-1])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-4)
    theirs = jax.jit(lambda p, x: JA.get_image_features(p, jcfg, x))(jparams, jnp.asarray(pix))
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs), atol=ATOL)

    ids = np.array([_image_ids(cfg, r)])
    one = pix[:1]
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids), pixel_values=torch.from_numpy(one)).logits
        got, _ = TA.forward(params, cfg, torch.from_numpy(ids),
                            pixel_values=torch.from_numpy(one))
        text_ids = r.integers(5, 400, size=(2, 12))
        want_text = hf(input_ids=torch.from_numpy(text_ids)).logits
        got_text, _ = family_forward(params, cfg, torch.from_numpy(text_ids),
                                     torch.from_numpy(TA.get_rope_index(cfg, text_ids)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-4, rtol=5e-3)
    np.testing.assert_allclose(got_text.numpy(), want_text.numpy(), atol=2e-4, rtol=2e-3)
    theirs = jax.jit(lambda p, i, x: JA.forward(p, jcfg, i, pixel_values=x)[0])(
        jparams, jnp.asarray(ids), jnp.asarray(one))
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs), atol=ATOL)


def test_engine_serves_text_and_vision_embeds(trio):
    """A text request and a vision_embeds request (the features computed by
    ``get_image_features``, entering the engine as rows) against HF
    ``generate`` and JAX's engine token for token, also prefilled in chunks
    whose boundary falls inside the image's rows; a pair of vision_embeds
    requests sharing a 12-token prefix equals each served plain (one prefix
    block, no tower pass), and the same rows as a tensor equal them as an
    array."""
    import jax.numpy as jnp

    from open_o3_video_tpu.engine import InferenceEngine as JaxEngine
    from open_o3_video_tpu.engine import Request as JaxRequest
    from open_o3_video_tpu.engine import SamplingParams as JaxSampling

    hf, jparams, jcfg, params, cfg = trio
    r = rng(5)
    text = r.integers(5, 400, size=10).tolist()
    pix = _pixels(cfg, r)
    ids = _image_ids(cfg, r)
    with torch.no_grad():
        feats = TA.get_image_features(params, cfg, torch.from_numpy(pix)).numpy()
        want = [hf.generate(input_ids=torch.tensor([i]), max_new_tokens=6, do_sample=False,
                            attention_mask=torch.ones(1, len(i), dtype=torch.long), **kw)
                [0, len(i):].tolist()
                for i, kw in ((text, {}), (ids, {"pixel_values": torch.from_numpy(pix)}))]
    reqs = [Request(text), Request(ids, vision_embeds=feats, vision_token_id=cfg.image_token_id)]
    engine = InferenceEngine(params, cfg, cache_dtype=torch.float32, prompt_buckets=(32,))
    ours = engine.generate(reqs, GREEDY, return_logprobs=True)
    assert [o["token_ids"] for o in ours] == want
    assert engine.counters["tower_passes"] == 0 and engine.counters["upload_bytes"] == feats.nbytes
    jax_engine = JaxEngine(jparams, jcfg, prompt_buckets=(32,), cache_dtype=jnp.float32)
    theirs = jax_engine.generate(
        [JaxRequest(q.input_ids, vision_embeds=q.vision_embeds,
                    vision_token_id=q.vision_token_id) for q in reqs],
        JaxSampling(**dataclasses.asdict(GREEDY)), return_logprobs=True)
    for o, t in zip(ours, theirs):
        assert o["token_ids"] == [int(x) for x in t["token_ids"]]
        np.testing.assert_allclose(o["logprobs"], t["logprobs"], atol=ATOL_MODEL)
    chunked = InferenceEngine(params, cfg, cache_dtype=torch.float32, prompt_buckets=(32,),
                              long_prefill_threshold=8, long_prefill_chunk=5)
    assert [o["token_ids"] for o in chunked.generate(reqs, GREEDY)] == want
    # both rows of 10 tokens in one admission, in chunks [0, 5) and [5, 10):
    # the image's rows at 4-6 straddle the boundary
    assert chunked.counters["prefills"] == 2

    shared = ids[:12]  # the prefix holds the image's query rows
    pair = [Request(shared + [20 + q, 30 + q], vision_embeds=feats,
                    vision_token_id=cfg.image_token_id) for q in range(2)]
    cached = InferenceEngine(params, cfg, cache_dtype=torch.float32, prompt_buckets=(32,),
                             prefix_cache_min=8, suffix_buckets=(8,))
    got = cached.generate(pair, GREEDY)
    assert cached.counters["prefix_blocks"] == 1 and cached.counters["tower_passes"] == 0
    plain = [engine.generate([q], GREEDY)[0] for q in pair]
    assert [g["token_ids"] for g in got] == [p["token_ids"] for p in plain]
    as_tensor = torch.from_numpy(feats.copy())
    cached.clear_prefix_cache()
    again = cached.generate([dataclasses.replace(q, vision_embeds=as_tensor) for q in pair],
                            GREEDY)
    assert [g["token_ids"] for g in again] == [p["token_ids"] for p in plain]
    assert cached.counters["prefix_blocks"] == 2
    with pytest.raises(ValueError, match="vision_embeds"):
        engine.generate([Request(ids, vision_embeds=feats[:, :5])], GREEDY)


def test_load_model_dispatch_and_safetensors_round_trip(tmp_path):
    """The port's Aria export loads in JAX's ``load_model`` leaf for leaf,
    and JAX's in the port's ``load_model``; a Qwen directory dispatches to
    the Qwen family, and Aria refuses the Qwen loaders' options."""
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.models import load_model as jax_load_model
    from open_o3_video_tpu.models.aria import params as JP
    from open_o3_video_tpu_torch.models.qwen25vl import Qwen25VLConfig
    from open_o3_video_tpu_torch.models.qwen25vl import params as TP

    cfg = TA.tiny_aria()
    params = TA.params.init(cfg, 3, torch.device("cpu"))
    ours, theirs, qwen = tmp_path / "ours", tmp_path / "theirs", tmp_path / "qwen"
    for d in (ours, theirs, qwen):
        d.mkdir()
    for d in (ours, theirs):
        (d / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    TA.params.save_safetensors(params, cfg, str(ours / "model.safetensors"))
    loaded, jcfg, fam = jax_load_model(str(ours), dtype=jnp.float32)
    assert fam.__name__.endswith(".aria")
    want = TP.to_jax_layout(params)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a, np.float32), b),
                 loaded, want)
    JP.save_safetensors(loaded, jcfg, str(theirs / "model.safetensors"))
    back, cfg_b, fam_b = load_model(str(theirs), torch.device("cpu"), dtype=torch.float32)
    assert fam_b is TA and is_aria(cfg_b) and cfg_b == cfg
    jax.tree.map(np.testing.assert_array_equal, TP.to_jax_layout(back), want)
    carried = TA.params.from_jax_params(jax.tree.map(np.asarray, loaded), cfg,
                                        torch.device("cpu"))
    jax.tree.map(np.testing.assert_array_equal, TP.to_jax_layout(carried), want)
    with pytest.raises(ValueError, match="loader options"):
        load_model(str(ours), torch.device("cpu"), quantize_text=True)
    qcfg = Qwen25VLConfig.tiny()
    (qwen / "config.json").write_text(json.dumps(qcfg.to_hf_dict()))
    TP.save_safetensors(TP.init(qcfg, 0, torch.device("cpu")), qcfg,
                        str(qwen / "model.safetensors"))
    _, got_cfg, fam_q = load_model(str(qwen), torch.device("cpu"), dtype=torch.float32)
    assert fam_q.__name__.endswith(".qwen25vl") and got_cfg == qcfg and not is_aria(got_cfg)
    with pytest.raises(ValueError, match="pixel_values"):
        family_forward(back, cfg, torch.zeros(1, 2, dtype=torch.long), None,
                       grid_thw=np.array([[1, 2, 2]]))


@pytest.mark.cuda
def test_k3_and_k4_at_arias_group_of_one_on_the_card():
    """Aria's attention: 20 q heads over 20 KV heads of 128 (a GQA group of
    1). K3 at a left-padded prefill of two rows and K4 (a decode step over
    32768 slots) against their plain versions."""
    from _torch_parity import assert_kernel_close

    from open_o3_video_tpu_torch.ops import decode_attention as da
    from open_o3_video_tpu_torch.ops import flash_attention as fa

    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, T, H = 2, 300, 364, 20
    q = torch.randn((B, S, H, 128), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, T, H, 128), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
    valid[0, :S] = 1
    valid[1, 40:S] = 1
    keep = valid[:, :S, None, None] != 0
    assert_kernel_close(fa.flash_attention_gqa(q, k, v, pos, valid) * keep,
                        fa.flash_attention_gqa_torch(q, k, v, pos, valid) * keep)
    T = 32768
    k, v = (torch.randn((1, T, H, 128), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    q = torch.randn((1, 1, H, 128), generator=g, device=dev).to(torch.bfloat16)
    qpos = torch.full((1, 1), T - 1, dtype=torch.int32, device=dev)
    valid = torch.ones((1, T), dtype=torch.int32, device=dev)
    assert_kernel_close(da.decode_attention_gqa(q, k, v, qpos, valid),
                        da.decode_attention_gqa_torch(q, k, v, qpos, valid))
