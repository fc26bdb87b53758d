"""The port's tiny Qwen2.5-VL against the JAX package's, with the same
weights (JAX init -> numpy -> port params), in float32 on the CPU: the
vision tower, the prefill logits and four cached decode steps."""

import numpy as np
import torch

from _torch_parity import ATOL_MODEL, frames, model_pair, rng

from open_o3_video_tpu_torch.data.processor import ByteTokenizer, O3VideoProcessor
from open_o3_video_tpu_torch.models.qwen25vl import model as tmodel
from open_o3_video_tpu_torch.models.qwen25vl import params as tparams_mod
from open_o3_video_tpu_torch.models.qwen25vl.text import init_kv_cache

# 140x196 frames: a 10x14-patch grid, whose 2x2 edge windows pack into
# shared rows (segment ids 1-2 within a row), plus a whole-frame global block.
N_FRAMES, H, W = 4, 140, 196


def _prompt(proc):
    body = "".join("<|vision_start|><|image_pad|><|vision_end|>" for _ in range(N_FRAMES))
    return f"<|im_start|>user\n{body}What is shown?<|im_end|>\n<|im_start|>assistant\n"


def test_from_jax_params_is_the_same_tree():
    jcfg, jparams, tcfg, tparams = model_pair(0)
    assert tparams["visual"]["blocks"][1]["qkv_w"].shape == (64, 192)
    np.testing.assert_array_equal(
        tparams["text"]["layers"][1]["down_w"].numpy(),
        np.asarray(jparams["text"]["layers"][1]["down_w"]),
    )
    assert tparams_mod.count(tparams) == sum(
        np.asarray(x).size for x in __import__("jax").tree.leaves(jparams)
    )
    # init() draws the same tree shape on any device
    fresh = tparams_mod.init(tcfg, 0, torch.device("cpu"))
    assert tparams_mod.count(fresh) == tparams_mod.count(tparams)


def test_vision_prefill_and_decode_logits_match_jax():
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.models.qwen25vl import model as jmodel
    from open_o3_video_tpu.models.qwen25vl.text import init_kv_cache as jax_init_kv_cache

    jcfg, jparams, tcfg, tparams = model_pair(0)
    proc = O3VideoProcessor(tokenizer=ByteTokenizer.for_config(tcfg))
    x = proc(_prompt(proc), images=list(frames(rng(1), N_FRAMES, H, W)))
    patches, grid = x.pixel_patches, x.grid_thw

    vis_t = tmodel.encode_vision(tparams, tcfg, torch.from_numpy(patches), grid).numpy()
    vis_j = np.asarray(jax.jit(lambda p, a: jmodel.encode_vision(p, jcfg, a, grid))(
        jparams, jnp.asarray(patches)))
    np.testing.assert_allclose(vis_t, vis_j, atol=ATOL_MODEL)

    # two rows: the vision prompt, and a shorter text-only prompt left-padded
    S = len(x.input_ids)
    ids = np.full((2, S), tcfg.pad_token_id, np.int64)
    ids[0] = x.input_ids
    ids[1, S - 9:] = rng(2).integers(3, 99, 9)
    mask = np.zeros((2, S), np.int64)
    mask[0] = 1
    mask[1, S - 9:] = 1
    pos, _ = tmodel.get_rope_index(tcfg, ids, image_grid_thw=grid, attention_mask=mask)
    steps = 4
    T = S + steps
    valid = np.zeros((2, T), bool)
    valid[:, :S] = mask

    jcache = jax_init_kv_cache(jcfg.text, 2, T, dtype=jnp.float32)
    tcache = init_kv_cache(tcfg.text, 2, T, dtype=torch.float32)
    # JAX runs jitted (eager dispatch compiles op by op).
    prefill = jax.jit(lambda p, i, q, x, v, c: jmodel.forward(
        p, jcfg, i, q, pixel_patches=x, grid_thw=grid, attn_valid=v, cache=c, attn_impl="xla"))
    decode = jax.jit(lambda p, i, q, v, c, off: jmodel.forward(
        p, jcfg, i, q, attn_valid=v, cache=c, cache_offset=off, attn_impl="xla"))
    lj, jcache = prefill(jparams, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(patches),
                         jnp.asarray(valid), jcache)
    lt, tcache = tmodel.forward(
        tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(pos),
        pixel_patches=torch.from_numpy(patches), grid_thw=grid,
        attn_valid=torch.from_numpy(valid), cache=tcache,
    )
    keep = mask.astype(bool)
    np.testing.assert_allclose(lt.numpy()[keep], np.asarray(lj)[keep], atol=ATOL_MODEL)

    nxt = np.asarray(lj)[:, -1].argmax(-1)
    cur = pos.max(axis=(0, 2)) + 1
    for i in range(steps):
        valid[:, S + i] = True
        p = np.broadcast_to(cur[None, :, None], (3, 2, 1)).copy()
        lj, jcache = decode(jparams, jnp.asarray(nxt[:, None]), jnp.asarray(p),
                            jnp.asarray(valid), jcache, S + i)
        lt, tcache = tmodel.forward(
            tparams, tcfg, torch.from_numpy(nxt[:, None]), torch.from_numpy(p),
            attn_valid=torch.from_numpy(valid), cache=tcache, cache_offset=S + i,
        )
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL_MODEL)
        nxt = np.asarray(lj)[:, -1].argmax(-1)
        cur = cur + 1


def test_from_hf_state_dict_round_trips_jax_export(tmp_path):
    """The JAX package's HF export (safetensors, HF names and layouts)
    imports into the port as the same weights."""
    import jax
    import pytest

    safetensors_torch = pytest.importorskip("safetensors.torch")
    from open_o3_video_tpu.models.qwen25vl import params as jparams_mod

    jcfg, jparams, tcfg, _ = model_pair(0)
    path = str(tmp_path / "model.safetensors")
    jparams_mod.save_safetensors(jparams, jcfg, path)
    sd = safetensors_torch.load_file(path)
    ours = tparams_mod.from_hf_state_dict(sd.items(), tcfg, torch.device("cpu"))
    want = jax.tree.map(np.asarray, jparams)
    got = jax.tree.map(lambda x: x.numpy(), ours)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    sd.pop("lm_head.weight")  # tied embeddings
    tied = tparams_mod.from_hf_state_dict(sd.items(), tcfg, torch.device("cpu"))
    assert torch.equal(tied["text"]["lm_head"], tied["text"]["embed_tokens"].T)
    sd.pop("model.norm.weight")
    with pytest.raises(ValueError, match="missing"):
        tparams_mod.from_hf_state_dict(sd.items(), tcfg, torch.device("cpu"))


def test_vision_mixed_resolution_matches_jax():
    """Frames of different grids: the global blocks run K2 through the
    gather/scatter plan (no whole-frame reshape exists)."""
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.models.qwen25vl import model as jmodel

    jcfg, jparams, tcfg, tparams = model_pair(0)
    proc = O3VideoProcessor(tokenizer=ByteTokenizer.for_config(tcfg))
    r = rng(3)
    imgs = [frames(r, 1, 140, 196)[0], frames(r, 1, 84, 112)[0]]
    x = proc("<|vision_start|><|image_pad|><|vision_end|>" * 2, images=imgs)
    assert len({tuple(g) for g in x.grid_thw.tolist()}) == 2
    ours = tmodel.encode_vision(tparams, tcfg, torch.from_numpy(x.pixel_patches), x.grid_thw)
    theirs = jax.jit(lambda p, a: jmodel.encode_vision(p, jcfg, a, x.grid_thw))(
        jparams, jnp.asarray(x.pixel_patches))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL_MODEL)
