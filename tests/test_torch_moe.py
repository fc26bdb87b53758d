"""Qwen3-VL-MoE in the port against the JAX package and HF transformers at
tiny dims (``tiny_qwen3_moe``: 4 experts, top 2, softmax -> top-k ->
renormalised), and the routed-expert MLP of both routings.

- the config: the tiny one, the published 30B-A3B file and their HF dicts
  field for field against JAX's, its refusals, and the 30B decoder's
  parameter count;
- the MLP: ``moe_mlp`` (routed: tokens sorted by expert, one grouped
  product per weight stack) against JAX's ``_moe_mlp`` (every expert, a
  dense combine) and the port's own dense form, for Qwen3-VL-MoE's routing
  and Aria's (with shared experts), on random tokens and on tokens whose
  router logits tie, where JAX's ``lax.top_k`` takes the lower index;
- logits of a text-only batch and of an image request (deepstack taps
  included) against JAX's ``forward`` (JAX's random init carried across);
- the engine's greedy tokens against JAX's engine (five queries sharing a
  prefix over one image) and against HF's tiny ``Qwen3VLMoe`` generate;
- the safetensors export read by JAX's ``load_pretrained``, and
  ``quantize_text``'s int8 leaves equal to JAX's set;
- ``QwenVLEngine`` refusing Qwen3-VL-MoE (its harnesses cut frames for
  patch 14), and ``require_trainable`` passing it;
- on the card (``cuda``): K3 at the 30B's prefill (32/4 heads of 128 on a
  2048-wide residual) and the routed MLP in bf16 against float32.

Tolerances: f32 on the CPU, the packages summing in different orders:
ATOL (1e-5) for the MLP and the logits against JAX (measured ~2e-7),
ATOL_MODEL (1e-4) for log-probabilities, and HF's own parity bounds (5e-4
absolute, 5e-3 relative with vision) against HF.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_MODEL, cuda_device, family_pair, rng

from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.models.qwen25vl import config as TC
from open_o3_video_tpu_torch.models.qwen25vl import model as TM
from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.models.qwen25vl import text as TT

ATOL = 1e-5
NAME = "tiny_qwen3_moe"


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    return d


def test_config_and_published_30b_match_jax():
    from open_o3_video_tpu.models.qwen25vl import config as JC

    assert _fields(TC.tiny_qwen3_moe()) == _fields(JC.tiny_qwen3_moe())
    hf = TC.QWEN3_VL_30B_A3B_INSTRUCT_CONFIG
    ours = TC.Qwen25VLConfig.from_hf_dict(hf)
    assert _fields(ours) == _fields(JC.Qwen25VLConfig.from_hf_dict(hf))
    v, t = ours.vision, ours.text
    assert ours.model_type == "qwen3_vl_moe"
    assert (t.num_hidden_layers, t.hidden_size, t.num_attention_heads, t.num_key_value_heads,
            t.head_dim, t.moe_num_experts, t.moe_topk, t.moe_intermediate_size,
            t.moe_routing, t.vocab_size) == (48, 2048, 32, 4, 128, 128, 8, 768,
                                             "softmax_topk_norm", 151936)
    assert (v.depth, v.hidden_size, v.head_dim, v.deepstack_visual_indexes,
            v.out_hidden_size) == (27, 1152, 72, (8, 16, 24), 2048)
    for cfg in (ours, TC.tiny_qwen3_moe()):
        assert TC.Qwen25VLConfig.from_hf_dict(cfg.to_hf_dict(), dtype=cfg.dtype) == cfg
        assert cfg.to_hf_dict() == JC.Qwen25VLConfig.from_hf_dict(cfg.to_hf_dict()).to_hf_dict()
    for extra in ({"mlp_only_layers": [3]}, {"decoder_sparse_step": 2}):
        bad = {**hf, "text_config": {**hf["text_config"], **extra}}
        with pytest.raises(NotImplementedError, match="mlp_only_layers"):
            TC.Qwen25VLConfig.from_hf_dict(bad)
    # the decoder's parameters by its leaves (every layer a mixture, the
    # dense MLP fields unused): 30.53B of the 31,070,754,032 that HF's
    # Qwen3VLMoeForConditionalGeneration has at this config (counted on the
    # meta device, ~12 s; the tower and mergers are the other 0.54B)
    per_layer = (2 * t.hidden_size * (t.num_attention_heads + t.num_key_value_heads) * t.head_dim
                 + 2 * t.hidden_size + 2 * t.head_dim
                 + t.hidden_size * t.moe_num_experts
                 + 3 * t.moe_num_experts * t.hidden_size * t.moe_intermediate_size)
    assert t.num_hidden_layers * per_layer + (2 * t.vocab_size + 1) * t.hidden_size == 30532122624


def _layer(r, D, E, F, shared):
    """A mixture layer's weights (numpy, f32), ``shared`` shared experts."""
    p = {"router": r.standard_normal((D, E)) * 0.3,
         "moe_fc1": r.standard_normal((E, D, 2 * F)) * 0.2,
         "moe_fc2": r.standard_normal((E, F, D)) * 0.2}
    if shared:
        p.update(gate_w=r.standard_normal((D, F * shared)) * 0.2,
                 up_w=r.standard_normal((D, F * shared)) * 0.2,
                 down_w=r.standard_normal((F * shared, D)) * 0.2)
    return {k: x.astype(np.float32) for k, x in p.items()}


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("routing,shared", [("softmax_topk_norm", 0), ("topk_softmax", 2)])
def test_routed_mlp_matches_jax_moe_mlp(routing, shared, tie):
    """Both routings, Aria's with its shared experts. With ``tie`` the
    router's columns 1 and 2 are zero and the tokens positive: expert 0
    ranks first (column 0 positive), 3 last (negative), and 1 and 2 tie
    exactly, so top-2 must take expert 1, as ``lax.top_k`` does; taking 2
    would change the output (other weights)."""
    import jax.numpy as jnp

    from open_o3_video_tpu.models.qwen25vl import text as JT
    from open_o3_video_tpu.models.qwen25vl.config import TextConfig as JaxText

    D, E, F, k = 32, 4, 16, 2
    r = rng(7)
    p = _layer(r, D, E, F, shared)
    x = r.standard_normal((3, 5, D)).astype(np.float32)
    if tie:
        p["router"][:, 1:3] = 0.0
        p["router"][:, 0] = np.abs(p["router"][:, 0])
        p["router"][:, 3] = -np.abs(p["router"][:, 3])
        x = np.abs(x)
    kw = dict(hidden_size=D, intermediate_size=F, moe_num_experts=E, moe_topk=k,
              moe_num_shared_experts=shared, moe_routing=routing)
    tcfg = TC.TextConfig(**kw)
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    ours = TT.moe_mlp(tp, tcfg, torch.from_numpy(x))
    theirs = np.asarray(JT._moe_mlp({n: jnp.asarray(a) for n, a in p.items()}, JaxText(**kw),
                                    jnp.asarray(x)))
    np.testing.assert_allclose(ours.numpy(), theirs, atol=ATOL)
    np.testing.assert_allclose(TT.moe_mlp_dense(tp, tcfg, torch.from_numpy(x)).numpy(), theirs,
                               atol=ATOL)
    idx, w = TT.moe_route(tp, tcfg, torch.from_numpy(x.reshape(-1, D)))
    torch.testing.assert_close(w.sum(-1), torch.ones(15))
    if tie:
        assert (idx == torch.tensor([0, 1])).all()
        swapped = dict(tp, router=tp["router"][:, [0, 2, 1, 3]],
                       moe_fc1=tp["moe_fc1"][[0, 2, 1, 3]], moe_fc2=tp["moe_fc2"][[0, 2, 1, 3]])
        # the same experts relabelled: the tie now takes the other one
        assert (TT.moe_mlp(swapped, tcfg, torch.from_numpy(x)) - ours).abs().max() > 1e-3


def _image_case(cfg, r):
    from test_torch_qwen3vl import _image_prompt, _patches

    grid = np.array([[1, 4, 8]])
    return np.array([_image_prompt(cfg, r, grid)]), _patches(cfg, r, grid), grid


@pytest.mark.parametrize("kind", ["text", "image"])
def test_forward_logits_match_jax(kind):
    from test_torch_qwen3vl import jax_logits

    _, _, tcfg, tparams = family_pair(NAME)
    r = rng(4)
    if kind == "text":
        ids, vision, kw = r.integers(0, 400, size=(2, 12)), {}, {}
        pos, _ = TM.get_rope_index(tcfg, ids)
    else:
        ids, pix, grid = _image_case(tcfg, r)
        pos, _ = TM.get_rope_index(tcfg, ids, image_grid_thw=grid)
        vision = dict(pixel_patches=pix, grid_thw=grid, vision_token_id=tcfg.image_token_id)
        kw = dict(vision, pixel_patches=torch.from_numpy(pix))
    ours, _ = TM.forward(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(ours.numpy(), jax_logits(NAME, ids, pos, **vision), atol=ATOL)


def test_engine_tokens_match_jax_engine_and_hf_generate():
    """Five queries sharing a prefix over one image through both engines
    (tokens equal, log-probabilities to ATOL_MODEL; one prefix block, one
    tower pass), an image request beside one of precomputed rows
    (``vision_embeds``: zeros at the deepstack layers) through both
    engines, then 8 greedy tokens of an image request against HF's
    tiny Qwen3-VL-MoE, its weights loaded by the port's HF loader."""
    from test_torch_qwen3vl import KNOBS, _jax_engine, run_engine_case

    from open_o3_video_tpu.engine import Request as JaxRequest
    from open_o3_video_tpu.engine import SamplingParams as JaxSampling

    _, engine = run_engine_case(NAME, "prefix")
    assert engine.counters["prefix_blocks"] == 1 and engine.counters["tower_passes"] == 1
    # precomputed rows beside an image: they add zeros at the deepstack
    # layers, the image its taps
    _, _, tcfg, tparams = family_pair(NAME)
    r = rng(8)
    ids, pix, grid = _image_case(tcfg, r)
    n = int((ids == tcfg.image_token_id).sum())
    rows = r.standard_normal((n, tcfg.text.hidden_size)).astype(np.float32)
    reqs = [Request(ids[0].tolist(), pixel_patches=pix, grid_thw=grid,
                    vision_token_id=tcfg.image_token_id),
            Request(ids[0].tolist()[:-2], vision_embeds=rows,
                    vision_token_id=tcfg.image_token_id)]
    greedy = SamplingParams(temperature=0.0, repetition_penalty=1.0, max_tokens=6)
    ours = InferenceEngine(tparams, tcfg, cache_dtype=torch.float32, **KNOBS).generate(reqs, greedy)
    theirs = _jax_engine(NAME).generate(
        [JaxRequest(q.input_ids, pixel_patches=q.pixel_patches, grid_thw=q.grid_thw,
                    vision_token_id=q.vision_token_id, vision_embeds=q.vision_embeds)
         for q in reqs], JaxSampling(**dataclasses.asdict(greedy)))
    assert [o["token_ids"] for o in ours] == [[int(x) for x in t["token_ids"]] for t in theirs]
    hf, cfg, params = _hf_tiny_moe()
    ids, pix, grid = _image_case(cfg, rng(6))
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids), pixel_values=torch.from_numpy(pix),
                  image_grid_thw=torch.from_numpy(grid)).logits.numpy()
        pos, _ = TM.get_rope_index(cfg, ids, image_grid_thw=grid)
        got, _ = TM.forward(params, cfg, torch.from_numpy(ids), torch.from_numpy(pos),
                            pixel_patches=torch.from_numpy(pix), grid_thw=grid,
                            vision_token_id=cfg.image_token_id)
        np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-3)
        tokens = hf.generate(input_ids=torch.from_numpy(ids), pixel_values=torch.from_numpy(pix),
                             image_grid_thw=torch.from_numpy(grid), max_new_tokens=8,
                             do_sample=False, repetition_penalty=1.0,
                             attention_mask=torch.ones(ids.shape, dtype=torch.long))
    out = InferenceEngine(params, cfg, cache_dtype=torch.float32, prompt_buckets=(64,)).generate(
        [Request(ids[0].tolist(), pixel_patches=pix, grid_thw=grid,
                 vision_token_id=cfg.image_token_id)],
        SamplingParams(temperature=0.0, repetition_penalty=1.0, max_tokens=8))
    assert out[0]["token_ids"] == tokens[0, ids.shape[1]:].tolist()


def _hf_tiny_moe():
    """HF's tiny Qwen3-VL-MoE (f32, weights from torch seed 0) at the port's
    ``tiny_qwen3_moe`` widths, its state dict loaded by the port's loader."""
    import transformers

    cfg = TC.tiny_qwen3_moe()
    hf_cfg = transformers.Qwen3VLMoeConfig(**cfg.to_hf_dict())
    torch.manual_seed(0)
    hf = transformers.Qwen3VLMoeForConditionalGeneration(hf_cfg).eval().float()
    return hf, cfg, TP.from_hf_state_dict(hf.state_dict().items(), cfg, torch.device("cpu"))


def test_export_read_by_jax_and_quantized_leaves_match(tmp_path):
    """The port's safetensors export (router, expert stacks) loads in JAX's
    ``load_pretrained`` leaf for leaf; ``quantize_text`` quantizes the leaves
    JAX's init quantizes, the router and expert stacks staying plain."""
    import jax

    from open_o3_video_tpu.models.qwen25vl import params as JP

    jcfg, jparams, tcfg, tparams = family_pair(NAME)
    (tmp_path / "config.json").write_text(json.dumps(tcfg.to_hf_dict()))
    TP.save_safetensors(tparams, tcfg, str(tmp_path / "model.safetensors"))
    loaded, _ = JP.load_pretrained(str(tmp_path), cfg=jcfg)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 loaded, jparams)
    back, _ = TP.load_pretrained(str(tmp_path), torch.device("cpu"), tcfg)
    jax.tree.map(np.testing.assert_array_equal, TP.to_jax_layout(back), TP.to_jax_layout(tparams))

    def quantized(tree):
        return {k for k, x in tree["text"]["layers"][0].items() if hasattr(x, "scale")}

    jq = jax.eval_shape(lambda: JP.init(jcfg, 0, quantize_text=True))
    ours = TP.init(tcfg, 0, torch.device("cpu"), quantize_text=True)
    assert quantized(ours) == quantized(jq) == {"q_w", "k_w", "v_w", "o_w"}
    assert hasattr(ours["text"]["lm_head"], "scale") and hasattr(jq["text"]["lm_head"], "scale")
    assert not any(hasattr(ours["text"]["layers"][0][k], "scale")
                   for k in ("router", "moe_fc1", "moe_fc2"))


def test_eval_engine_refuses_the_moe_family_and_training_takes_it():
    """``QwenVLEngine``'s harnesses cut frames for patch 14 and
    Qwen3-VL-MoE's patch is 16: refused as Qwen3-VL is. Its training is
    ported (tests/test_torch_train_moe.py): ``require_trainable`` passes
    the 30B and the tiny config."""
    from open_o3_video_tpu_torch.eval.model_engine import QwenVLEngine
    from open_o3_video_tpu_torch.train.sft import require_trainable

    cfg = TC.Qwen25VLConfig.from_hf_dict(TC.QWEN3_VL_30B_A3B_INSTRUCT_CONFIG)
    with pytest.raises(NotImplementedError, match="patch 14"):
        QwenVLEngine({}, cfg=cfg)
    for c in (cfg, TC.tiny_qwen3_moe()):
        require_trainable(c)


@pytest.mark.cuda
def test_k3_at_the_30b_prefill_and_the_routed_mlp_on_the_card():
    """K3 at the 30B's prefill heads (32 q over 4 KV heads of 128) against
    its plain version; the routed MLP at the 30B's expert widths (16
    experts, top 8) in bf16 against the float32 dense form on the same
    experts: within 1e-2 relative L2 and at most 1.25x the bf16 dense
    form's error (SLICE_REL_RATIO, the bound phase 22 holds)."""
    from _torch_parity import assert_kernel_close

    from open_o3_video_tpu_torch.ops import flash_attention as fa

    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, T = 2, 300, 364
    q = torch.randn((B, S, 32, 128), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, T, 4, 128), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
    valid[0, :S] = 1
    valid[1, 40:S] = 1
    keep = valid[:, :S, None, None] != 0
    assert_kernel_close(fa.flash_attention_gqa(q, k, v, pos, valid) * keep,
                        fa.flash_attention_gqa_torch(q, k, v, pos, valid) * keep)
    t = TC.TextConfig(hidden_size=2048, moe_num_experts=16, moe_topk=8,
                      moe_intermediate_size=768, moe_routing="softmax_topk_norm")
    p = {n: (torch.from_numpy(a).to(dev) * 0.1).to(torch.bfloat16)
         for n, a in _layer(rng(1), 2048, 16, 768, 0).items()}
    x = torch.randn((300, 2048), generator=g, device=dev).to(torch.bfloat16)
    route = TT.moe_route(p, t, x)
    ref = TT.moe_mlp_dense({n: a.float() for n, a in p.items()}, t, x.float(), route=route)

    def rel(y):
        return ((y.float() - ref).norm() / ref.norm()).item()

    routed, plain = rel(TT.moe_mlp(p, t, x)), rel(TT.moe_mlp_dense(p, t, x))
    assert routed < 1e-2 and routed <= 1.25 * plain, (routed, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("routing", ["softmax_topk_norm", "topk_softmax"])
def test_decode_graph_captures_the_routed_experts_on_the_card(routing):
    """A small mixture model on the card (8 experts, top 2; with Aria's
    routing, 2 shared experts), two text-only requests greedy and sampled:
    the graphed decode (the routed MLP captured: group ends searched on the
    device, one grouped product per stack) gives the eager decode's tokens
    and log-probabilities."""
    from test_torch_engine import _card_config

    dev = cuda_device()
    base = _card_config()
    cfg = dataclasses.replace(base, model_type="qwen3_vl_moe", text=dataclasses.replace(
        base.text, moe_num_experts=8, moe_topk=2, moe_intermediate_size=64, moe_routing=routing,
        moe_num_shared_experts=2 if routing == "topk_softmax" else 0))
    params = TP.init(cfg, 0, dev)
    if routing == "topk_softmax":  # Aria's shared experts on top of the routed ones
        for layer in params["text"]["layers"]:
            layer.update(gate_w=layer["moe_fc1"][0, :, :64].clone(),
                         up_w=layer["moe_fc1"][1, :, :64].clone(),
                         down_w=layer["moe_fc2"][0].clone())
    r = rng(7)
    reqs = [Request(r.integers(5, 400, size=n).tolist()) for n in (40, 27)]
    for sampling in (SamplingParams(temperature=0.0, repetition_penalty=1.05, max_tokens=16),
                     SamplingParams(temperature=0.7, top_p=0.9, repetition_penalty=1.05,
                                    max_tokens=16, seed=3)):
        outs = [InferenceEngine(params, cfg, decode_graph=graph).generate(
            reqs, sampling, return_logprobs=True) for graph in (True, False)]
        assert outs[0] == outs[1]
