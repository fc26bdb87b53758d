"""Kimi-VL on the port against its plain float32 reference
(``tests/reference_kimi_vl.py``) at a tiny size on the CPU, on seeded random
weights: the whole forward, prefill then decode through the latent cache,
the engine's prefix blocks, suffix admissions and wrapped ring, the
absorbed and expanded attention, the router, the MLPs, the tower and the
loader. The ``cuda`` tests hold the MLA kernels to their plain versions on
the card (``python -m pytest --noconftest -m cuda tests/test_torch_kimi_vl.py``).

Tolerances: the port and the reference both compute in float32 here, in
other orders of summation, so logits agree to ~1e-6 of their scale;
``ATOL`` (1e-4 of logits of magnitude ~0.5) leaves that a hundredfold, and a
bf16 computation (8 bits of mantissa: ~4e-3 relative a product) misses it
by an order of magnitude (``test_a_bf16_port_misses_the_tolerance``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import reference_kimi_vl as R
from _torch_parity import assert_kernel_close, cuda_device

from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.models import kimi_vl as K
from open_o3_video_tpu_torch.models.kimi_vl import text as KT
from open_o3_video_tpu_torch.models.qwen25vl import text as QT
from open_o3_video_tpu_torch.ops import mla
from open_o3_video_tpu_torch.ops.preprocess import patchify_device

ATOL = 1e-4
PLACEHOLDER = 300


@pytest.fixture(scope="module")
def model():
    cfg = K.tiny_kimi_vl()
    return cfg, K.params.init(cfg, 0, "cpu")


def _frames(seed: int, t: int = 2, hw=(56, 56)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(t, 3, *hw), dtype=np.uint8)


def _tower_ref(params, cfg, frames: np.ndarray):
    rows = patchify_device(torch.from_numpy(frames), cfg.vision.patch_size, 1,
                           cfg.vision.spatial_merge_size, mean=cfg.vision.image_mean,
                           std=cfg.vision.image_std)
    t, _, h, w = frames.shape
    grid = (t, h // cfg.vision.patch_size, w // cfg.vision.patch_size)
    return rows, grid, R.tower(params["visual"], cfg.vision, rows, [grid])


def _prompt(n_vis: int, text_len: int, tail) -> list:
    return [5, 6] + [PLACEHOLDER] * n_vis + [10 + i % 250 for i in range(text_len)] + list(tail)


def test_forward_logits_match_the_reference(model):
    cfg, params = model
    rows, grid, vis = _tower_ref(params, cfg, _frames(0))
    ids = _prompt(vis.shape[0], 20, [7, 8])
    got, _ = K.forward(params, cfg, torch.tensor([ids]), pixel_patches=rows,
                       grid_thw=np.array([grid]))
    ref = R.logits(params, cfg, ids, vis)
    torch.testing.assert_close(got[0], ref, atol=ATOL, rtol=0)


def test_a_bf16_port_misses_the_tolerance(model):
    """The same forward with the weights and activations in bf16 is held
    to the float32 reference: it must exceed ATOL, so ATOL tells a bf16
    computation from a float32 one."""
    cfg, params = model
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    p16 = K.params.init(cfg16, 0, "cpu")
    p32 = _cast(p16, torch.float32)
    ids = _prompt(0, 30, [])
    got, _ = K.forward(p16, cfg16, torch.tensor([ids]))
    ref = R.logits(p32, cfg, ids)
    assert (got[0] - ref).abs().max().item() > 10 * ATOL


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def _count_paths(monkeypatch) -> dict:
    """Counts of the expanded and absorbed attention calls (a call a layer)."""
    seen = {"expanded": 0, "absorbed": 0}
    for name, path in (("mla_prefill_attention", "expanded"), ("mla_decode", "absorbed")):
        def counted(*a, _fn=getattr(KT, name), _path=path, **kw):
            seen[_path] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(KT, name, counted)
    return seen


def test_prefill_then_decode_through_the_latent_cache(model, monkeypatch):
    """A prompt prefilled into the latent cache (expanded path), then 6
    tokens decoded one at a time at a column held on the device (absorbed
    path): every step's logits equal the reference's full forward at that
    position. The cache holds 576-wide rows only (here 32 + 8)."""
    cfg, params = model
    seen = _count_paths(monkeypatch)
    t = cfg.text
    ids = _prompt(0, 40, [])
    extra = [11, 12, 13, 14, 15, 16]
    ref = R.logits(params, cfg, ids + extra)
    T = len(ids) + len(extra)
    cache = K.init_kv_cache(t, 1, T, dtype=torch.float32)
    assert set(cache) == {"kv"} and cache["kv"].shape == (t.num_hidden_layers, 1, T,
                                                          t.latent_dim)
    emb = params["text"]["embed_tokens"]
    pos = torch.arange(len(ids))[None].expand(3, 1, -1)
    hidden, _ = K.text_forward(params["text"], t, emb[torch.tensor([ids])], pos, cache=cache,
                               cache_offset=0)
    got = [QT.logits_from_hidden(params["text"], hidden[:, -1])[0]]
    valid = torch.zeros(1, T, dtype=torch.bool)
    valid[:, :len(ids)] = True
    for j, tok in enumerate(extra[:-1]):
        col = len(ids) + j
        valid[:, col] = True
        hidden, _ = K.text_forward(
            params["text"], t, emb[torch.tensor([[tok]])], torch.full((3, 1, 1), col),
            seq_positions=torch.tensor([[T]]), attn_valid=valid, cache=cache,
            cache_offset=torch.tensor(col), validity_only=True)
        got.append(QT.logits_from_hidden(params["text"], hidden[:, 0])[0])
    torch.testing.assert_close(torch.stack(got), ref[len(ids) - 1:-1], atol=ATOL, rtol=0)
    L = t.num_hidden_layers
    assert seen == {"expanded": L, "absorbed": L * (len(extra) - 1)}


def test_absorbed_attention_equals_expanded_attention(model, monkeypatch):
    """A 5-row block after a 30-token prompt through the absorbed path and
    again through the expanded path: the same logits."""
    cfg, params = model
    t = cfg.text
    ids = _prompt(0, 40, [])
    emb = params["text"]["embed_tokens"]

    def run():
        cache = K.init_kv_cache(t, 1, 40, dtype=torch.float32)
        K.text_forward(params["text"], t, emb[torch.tensor([ids[:30]])],
                       torch.arange(30)[None].expand(3, 1, -1), cache=cache, cache_offset=0)
        hidden, _ = K.text_forward(params["text"], t, emb[torch.tensor([ids[30:35]])],
                                   torch.arange(30, 35)[None].expand(3, 1, -1), cache=cache,
                                   cache_offset=30)
        return QT.logits_from_hidden(params["text"], hidden)[0]

    absorbed = run()
    monkeypatch.setattr(KT, "ABSORB_MAX_ROWS", 0)
    torch.testing.assert_close(absorbed, run(), atol=ATOL, rtol=0)
    torch.testing.assert_close(absorbed, R.logits(params, cfg, ids[:35])[30:], atol=ATOL, rtol=0)


def test_the_plain_kernels_agree_with_each_other():
    """``mla_decode_torch`` over a latent cache equals
    ``mla_prefill_attention_torch`` over its expansion, with holes and a
    row whose columns are all invalid (0 out)."""
    g = torch.Generator().manual_seed(0)
    B, S, H, N, P, R_, Dv, T = 2, 3, 4, 8, 4, 16, 8, 20
    kv_b = torch.randn(R_, H, N + Dv, generator=g)
    cache = torch.randn(B, T, R_ + P, generator=g)
    q_nope = torch.randn(B, S, H, N, generator=g)
    q_pe = torch.randn(B, S, H, P, generator=g)
    pos = torch.tensor([[5, 12, 19], [3, 4, 19]])
    valid = torch.rand(B, T, generator=g) > 0.3
    valid[1] = False
    kv = torch.einsum("btr,rhd->bthd", cache[..., :R_], kv_b)
    want = mla.mla_prefill_attention_torch(q_nope, q_pe, kv[..., :N], cache[..., R_:],
                                           kv[..., N:], pos, valid, 0.3)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, kv_b[..., :N])
    o_lat = mla.mla_decode_torch(q_lat, q_pe, cache, pos, valid, 0.3)
    got = torch.einsum("bshr,rhd->bshd", o_lat, kv_b[..., N:])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert got[1].abs().max() == 0


def test_split_plan_covers_every_column():
    """At most one CTA an SM, at least one split, none shorter than
    MIN_SPLIT_KEYS columns; the kernel's division of the written columns'
    32-key tiles among the splits covers each tile once."""
    for B, rows, T, sms in ((8, 16, 18700, 132), (1, 128, 300, 132), (2, 16, 31, 132),
                            (8, 16, 600, 132), (1, 16, 81920, 132)):
        n = mla.split_plan(B, rows, T, sms)
        assert n >= 1 and (n == 1 or B * -(-rows // mla.DECODE_ROWS) * n <= sms)
        assert n == 1 or T // n >= mla.MIN_SPLIT_KEYS
        for k_end in (0, 1, T // 3, T):
            tiles = -(-k_end // 32)
            per = -(-tiles // n)
            got = [j for i in range(n) for j in range(i * per, min(tiles, (i + 1) * per))]
            assert got == list(range(tiles))


def _route_layer(E=8, D=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"router": torch.randn(D, E, generator=g) * 0.3,
            "router_bias": torch.randn(E, generator=g) * 0.1}


def test_router_matches_the_reference_with_ties_and_the_bias(model):
    cfg, _ = model
    t = cfg.text
    p = _route_layer(t.moe_num_experts)
    h = torch.randn(12, 16, generator=torch.Generator().manual_seed(1))
    idx, w = QT.moe_route(p, t, h)
    ridx, rw = R.route(p, t, h)
    assert torch.equal(idx, ridx)
    torch.testing.assert_close(w, rw, atol=1e-6, rtol=0)
    # ties: equal scores and no bias choose the lower indices, in order
    tie = {"router": torch.zeros(16, t.moe_num_experts),
           "router_bias": torch.zeros(t.moe_num_experts)}
    idx, w = QT.moe_route(tie, t, h[:2])
    assert idx.tolist() == [list(range(t.moe_topk))] * 2
    torch.testing.assert_close(w, torch.full_like(w, t.routed_scaling_factor / t.moe_topk))
    # the bias changes the choice, not the weights: a large bias on the
    # last experts chooses them, weighted by their own scores
    biased = dict(tie, router_bias=torch.arange(t.moe_num_experts, dtype=torch.float32))
    idx, w = QT.moe_route(biased, t, h[:2])
    assert idx.tolist() == [list(range(t.moe_num_experts - 1,
                                       t.moe_num_experts - 1 - t.moe_topk, -1))] * 2
    torch.testing.assert_close(w, torch.full_like(w, t.routed_scaling_factor / t.moe_topk))
    assert abs(float(w.sum(-1)[0]) - t.routed_scaling_factor) < 1e-5


def test_shared_experts_and_the_dense_first_layer(model):
    cfg, params = model
    t = cfg.text
    h = torch.randn(2, 7, t.hidden_size, generator=torch.Generator().manual_seed(2))
    dense_layer, moe_layer = params["text"]["layers"][0], params["text"]["layers"][1]
    assert "router" not in dense_layer and dense_layer["gate_w"].shape[1] == t.intermediate_size
    assert moe_layer["gate_w"].shape[1] == t.moe_intermediate_size * t.moe_num_shared_experts
    torch.testing.assert_close(KT._mlp(dense_layer, t, h, "auto"), R.swiglu(
        h, dense_layer["gate_w"], dense_layer["up_w"], dense_layer["down_w"]), atol=1e-6, rtol=0)
    got = KT._mlp(moe_layer, t, h, "auto").reshape(-1, t.hidden_size)
    torch.testing.assert_close(got, R.moe(moe_layer, t, h.reshape(-1, t.hidden_size)),
                               atol=1e-6, rtol=0)
    shared = R.swiglu(h.reshape(-1, t.hidden_size), moe_layer["gate_w"], moe_layer["up_w"],
                      moe_layer["down_w"])
    assert (got - shared).abs().max() > 1e-3  # the routed part is there too


@pytest.mark.parametrize("hw", [(112, 112), (84, 140)])
def test_tower_matches_the_reference(model, hw):
    """8 x 8 patches use the 8 x 8 position table as it is; 6 x 10 resize it."""
    cfg, params = model
    rows, grid, ref = _tower_ref(params, cfg, _frames(3, 2, hw))
    got = K.encode_vision(params, cfg, rows, np.array([grid]))
    assert got.shape == (2 * grid[1] * grid[2] // 4, cfg.text.hidden_size)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


def _engine_case(params, cfg, n_req: int, slots: int, max_tokens: int, **kw):
    frames = _frames(5)
    n_vis = frames.shape[0] * (frames.shape[2] // 14) * (frames.shape[3] // 14) // 4
    reqs = [Request(input_ids=_prompt(n_vis, 280, [20 + i, 21, 22 + i] + [30] * (9 * (i % 2))),
                    frames=frames, grid_thw=np.array([[frames.shape[0], 4, 4]]),
                    vision_token_id=PLACEHOLDER) for i in range(n_req)]
    eng = InferenceEngine(params, cfg, max_slots=slots, cache_dtype=torch.float32, **kw)
    outs = eng.generate(reqs, SamplingParams(max_tokens=max_tokens, repetition_penalty=1.0),
                        return_logprobs=True)
    _, _, vis = _tower_ref(params, cfg, frames)
    for r, o in zip(reqs, outs):
        seq = list(r.input_ids) + o["token_ids"][:-1]
        z = R.logits(params, cfg, seq, vis)[len(r.input_ids) - 1:]
        lp = torch.log_softmax(z, -1).gather(1, torch.tensor(o["token_ids"])[:, None])[:, 0]
        torch.testing.assert_close(torch.tensor(o["logprobs"]), lp, atol=ATOL, rtol=0)
        gap = z.max(-1).values - z.gather(1, torch.tensor(o["token_ids"])[:, None])[:, 0]
        assert gap.max() <= ATOL  # greedy: each token the reference's best
    return eng


def test_engine_prefix_block_suffix_admissions_and_the_wrapped_ring(model, monkeypatch):
    """Three requests over one video sharing a 290-token prefix through 2
    slots: one tower pass, one prefix block (expanded), suffixes of 3 and
    12 tokens (absorbed and expanded), decode through the ring after it
    wrapped; every emitted token's log-probability is the reference's."""
    cfg, params = model
    seen = _count_paths(monkeypatch)
    eng = _engine_case(params, cfg, 3, 2, 6)
    c = eng.counters
    assert c["tower_passes"] == 1 and c["prefix_blocks"] == 1 and c["prefix_hits"] >= 1
    assert c["ring_wraps"] >= 1
    L = cfg.text.num_hidden_layers
    assert seen["expanded"] >= 2 * L and seen["absorbed"] >= L  # the block and a suffix
    assert eng.groups[0]["arena_bytes"] == (cfg.text.num_hidden_layers * 2 * eng.groups[0][
        "columns"] * cfg.text.latent_dim * 4)


def test_engine_plain_prefill_without_the_prefix_cache(model):
    cfg, params = model
    eng = _engine_case(params, cfg, 2, 2, 4, prefix_cache_min=0)
    assert eng.counters["prefix_blocks"] == 0 and eng.counters["prefills"] == 1


@pytest.mark.parametrize("kw", [{"spec_decode": True}, {"cache_dtype": torch.float8_e4m3fn},
                                {"spec_sample": True}, {"a8_prefill": True}])
def test_engine_refuses_what_it_does_not_serve(model, kw):
    cfg, params = model
    with pytest.raises(ValueError, match="Kimi-VL"):
        InferenceEngine(params, cfg, **kw)


def test_loader_reads_a_written_checkpoint(model, tmp_path):
    from safetensors.torch import save_file

    cfg, params = model
    named = {k: v.contiguous().clone() for k, v in K.params.hf_named_tensors(params, cfg)}
    assert "language_model.model.layers.1.self_attn.kv_a_proj_with_mqa.weight" in named
    assert "language_model.model.layers.1.mlp.gate.e_score_correction_bias" in named
    save_file(named, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(__import__("json").dumps(cfg.to_hf_dict()))
    from open_o3_video_tpu_torch.models import load_model

    got, cfg2, family = load_model(str(tmp_path), "cpu", dtype=torch.float32)
    assert family is K and cfg2 == cfg

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            return all(same(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return all(same(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)

    assert same(got, params)
    named.pop("language_model.model.layers.2.mlp.experts.3.up_proj.weight")
    save_file(named, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="missing"):
        load_model(str(tmp_path), "cpu", dtype=torch.float32)


def test_the_benchmark_reference_equals_the_test_reference(model):
    """``portbench/reference/kimi_vl.py`` (the card's copy, blocked) on one
    tiny forward: the same tower rows and logits as this file's."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench.lib.kimi_arch import read_arch
    from portbench.reference import kimi_vl as B

    cfg, params = model
    rows, grid, vis = _tower_ref(params, cfg, _frames(7))
    ids = _prompt(vis.shape[0], 25, [9])
    arch = read_arch(cfg.to_hf_dict())
    torch.testing.assert_close(B.patch_rows(torch.from_numpy(_frames(7)).float(), arch), rows)
    with torch.no_grad(), B.full_float32():
        bvis = B.vision_tower(params["visual"], arch, rows, [grid])
        z = B.logits(params, arch, ids, bvis, slice(0, len(ids)), query_block=16)
    torch.testing.assert_close(bvis, vis, atol=1e-5, rtol=0)
    torch.testing.assert_close(z, R.logits(params, cfg, ids, vis), atol=ATOL, rtol=0)


# ------------------------------------------------------------------ the card


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T", [(8, 1, 18700), (2, 4, 3000), (1, 8, 40000), (1, 1, 100)])
def test_mla_decode_kernel_matches_its_plain_version(B, S, T):
    """The longvideo.kimi-vl-a3b cell's decode step (8 rows x ~18.7k latent
    columns), a verify-sized block, eight 16-row blocks of one batch row,
    and a row shorter than one split; a fifth of the columns invalid and
    one row at a third of the buffer."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(B + T)
    H, R_, P = 16, 512, 64
    cache = torch.randn(B, T, R_ + P, device=dev, generator=g).bfloat16()
    q_lat = torch.randn(B, S, H, R_, device=dev, generator=g).bfloat16()
    q_pe = torch.randn(B, S, H, P, device=dev, generator=g).bfloat16()
    valid = torch.rand(B, T, device=dev, generator=g) > 0.2
    pos = torch.full((B, S), T, device=dev, dtype=torch.long)
    pos[0, 0] = T // 3
    got = mla.mla_decode(q_lat, q_pe, cache, pos, valid, 192 ** -0.5)
    want = mla.mla_decode_torch(q_lat, q_pe, cache, pos, valid, 192 ** -0.5)
    assert_kernel_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,rows", [(1, 1000, 1000, None), (3, 40, 700, None),
                                        (1, 18262, 18262, 256), (8, 96, 18358, None)])
def test_mla_prefill_kernel_matches_its_plain_version(B, S, T, rows):
    """Small blocks, then the cell's prefix block (18262 causal rows; the
    plain version at ``rows`` of them, spread over the block and its end)
    and its suffix admission (8 x 96 rows after the prefix, the last row
    left-padded), each with a hole in the last batch row's columns."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(S)
    H = 16
    kv = torch.randn(B, T, H, 256, device=dev, generator=g).bfloat16()
    lat = torch.randn(B, T, 576, device=dev, generator=g).bfloat16()
    q = torch.randn(B, S, H, 192, device=dev, generator=g).bfloat16()
    q_pe = q[..., 128:].contiguous()
    pos = (torch.arange(S, device=dev) + T - S)[None].repeat(B, 1)
    valid = torch.ones(B, T, dtype=torch.bool, device=dev)
    valid[-1, : T // 4] = False  # left padding and a hole
    if S < T:
        valid[-1, T - S:T - S + 8] = False
        pos[-1, :8] = -1
    args = (kv[..., :128], lat[..., 512:], kv[..., 128:])
    got = mla.mla_prefill_attention(q[..., :128], q_pe, *args, pos, valid, 192 ** -0.5)
    idx = (torch.arange(S, device=dev) if rows is None else
           torch.cat([torch.arange(0, S, S // (rows // 2), device=dev)[:rows // 2],
                      torch.arange(S - rows // 2, S, device=dev)]))
    want = mla.mla_prefill_attention_torch(q[:, idx, :, :128], q_pe[:, idx], *args, pos[:, idx],
                                           valid, 192 ** -0.5)
    assert_kernel_close(got[:, idx], want)
