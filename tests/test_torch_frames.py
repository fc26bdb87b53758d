"""The engine's uint8 frame path against the JAX package, on the CPU at tiny
dims, inputs made from a numpy seed: ``patchify_device`` and
``frames_as_images_patches`` bit for bit (float32, and bf16 after the cast),
``resize_frames_device`` in both modes within one LSB of JAX's,
``fetch_video_raw`` on a lossless AVI written by ``data/raw_media.py``, and
engine greedy tokens (f32 caches) for ``Request.frames``, ``frames`` +
``resize_hw`` and ``prestage_frames``, each against JAX's engine on the
same requests and against the port's own ``pixel_patches`` path; then the
prefix cache's keys over frames."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_parity import ATOL_MODEL, cuda_device, frames, model_pair, rng
from _torch_parity import port_reader  # noqa: F401 (fixture)

from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.ops import preprocess as TPRE
from open_o3_video_tpu_torch.ops import resize as TRES

# Frames of 2 x 56 x 84 (a 4 x 6 patch grid each) and a decoded size of
# 90 x 130 that the device resize takes to 56 x 84.
T, H, W = 2, 56, 84
RAW_HW = (90, 130)
SAMPLING = dict(temperature=0.0, repetition_penalty=1.05, max_tokens=10)


def _jax_patchify(x_u8, out_dtype=None):
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.preprocess import patchify_device

    return np.asarray(patchify_device(jnp.repeat(jnp.asarray(x_u8), 2, axis=0),
                                      out_dtype=out_dtype).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patchify_device_equals_jax_bit_for_bit(dtype):
    import jax.numpy as jnp

    x = frames(rng(0), 3, H, W)
    ours = TPRE.patchify_device(torch.from_numpy(x).repeat_interleave(2, dim=0),
                                out_dtype=getattr(torch, dtype))
    theirs = _jax_patchify(x, getattr(jnp, dtype))
    np.testing.assert_array_equal(ours.float().numpy(), theirs)
    if dtype == "float32":
        # and the host path's rows, which the processor feeds the tower
        np.testing.assert_array_equal(ours.numpy(), TPRE.frames_as_images_patches(x)[0])


def test_frames_as_images_patches_equals_jax():
    from open_o3_video_tpu.ops.preprocess import frames_as_images_patches

    x = frames(rng(1), 3, H, W)
    ours, ours_grid = TPRE.frames_as_images_patches(x)
    theirs, theirs_grid = frames_as_images_patches(x)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours_grid, theirs_grid)


@pytest.mark.parametrize("quantize", [True, False])
def test_resize_frames_device_within_one_lsb_of_jax(quantize):
    """The PIL-parity mode rounds each pass to uint8 values: the float32
    sums of the two packages may land a tie on either side, so a pixel may
    differ by one LSB, never more. The continuous mode differs only by the
    sums' rounding (bound 1e-3 of an LSB)."""
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.resize import resize_frames_device, resize_frames_host

    x = frames(rng(2), T, *RAW_HW)
    wh, ww = TRES.pil_resize_weights(RAW_HW[0], H), TRES.pil_resize_weights(RAW_HW[1], W)
    ours = TRES.resize_frames_device(torch.from_numpy(x), torch.from_numpy(wh),
                                     torch.from_numpy(ww), quantize=quantize).numpy()
    theirs = np.asarray(resize_frames_device(jnp.asarray(x), jnp.asarray(wh), jnp.asarray(ww),
                                             quantize=quantize))
    assert ours.shape == theirs.shape == (T, 3, H, W)
    assert np.abs(ours - theirs).max() <= (1.0 if quantize else 1e-3)
    if quantize:
        np.testing.assert_array_equal(TRES.resize_frames_host(x, H, W),
                                      resize_frames_host(x, H, W))
        assert np.abs(ours - TRES.resize_frames_host(x, H, W)).max() <= 1.0


def test_resize_frames_device_keeps_the_tf32_flag():
    prev = torch.backends.cuda.matmul.allow_tf32
    x = torch.from_numpy(frames(rng(3), 1, *RAW_HW))
    wh, ww = (torch.from_numpy(TRES.pil_resize_weights(i, o)) for i, o in zip(RAW_HW, (H, W)))
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        a = TRES.resize_frames_device(x, wh, ww)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.testing.assert_close(a, TRES.resize_frames_device(x, wh, ww), rtol=0, atol=0)


@pytest.mark.cuda
def test_resize_frames_device_is_float32_under_tf32_on_the_card():
    """On the card the same resize with TF32 switched on around it equals
    the one with TF32 off, and stays within one LSB of the host twin."""
    dev = cuda_device()
    x = frames(rng(4), T, *RAW_HW)
    wh, ww = (torch.from_numpy(TRES.pil_resize_weights(i, o)).to(dev)
              for i, o in zip(RAW_HW, (H, W)))
    xd = torch.from_numpy(x).to(dev)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = TRES.resize_frames_device(xd, wh, ww)
        torch.backends.cuda.matmul.allow_tf32 = True
        on = TRES.resize_frames_device(xd, wh, ww)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.testing.assert_close(on, off, rtol=0, atol=0)
    assert np.abs(off.cpu().numpy() - TRES.resize_frames_host(x, H, W)).max() <= 1.0


@pytest.mark.parametrize("reader", ["native", "cv2"])
def test_fetch_video_raw_equals_jax(tmp_path, port_reader, reader):
    """A lossless AVI (raw BGR24 frames) read by JAX's fetch_video_raw (its
    native decoder) and by the port's through its reader: the same frames,
    target size and sample fps."""
    from open_o3_video_tpu.data import video as JV
    from open_o3_video_tpu_torch.data import fetch_video_raw
    from open_o3_video_tpu_torch.data.raw_media import write_raw_avi

    if not JV.is_native_available():
        pytest.skip("the JAX package's native decoder is not available")
    if reader == "cv2":
        pytest.importorskip("cv2")
    port_reader(reader)
    video = rng(5).integers(0, 256, size=(12, 360, 640, 3), dtype=np.uint8)
    path = str(tmp_path / "raw.avi")
    write_raw_avi(path, video, fps=6.0)
    ele = {"video": path, "nframes": 4}
    ours, ours_hw, ours_fps = fetch_video_raw(ele)
    theirs, theirs_hw, theirs_fps = JV.fetch_video_raw(dict(ele))
    assert ours.dtype == np.uint8 and ours.shape == (4, 3, 360, 640)
    np.testing.assert_array_equal(ours, theirs)
    assert tuple(ours_hw) == tuple(theirs_hw) and ours_fps == pytest.approx(theirs_fps)


def test_fetch_video_fast_raises_without_libav(monkeypatch):
    from open_o3_video_tpu_torch.data import fetch_video_fast
    from open_o3_video_tpu_torch.native import video_decoder

    monkeypatch.setattr(video_decoder, "missing", lambda: ["libswscale/swscale.h"])
    with pytest.raises(ImportError, match="swscale"):
        fetch_video_fast({"video": "x.mp4"})


# ----------------------------------------------------------------- engine


def _prompt(cfg, n_tok, tail):
    return [7, 8, cfg.vision_start_token_id] + [cfg.image_token_id] * n_tok + [
        cfg.vision_end_token_id] + tail


@functools.cache
def _cases():
    """Frames at the model size, raw frames with their resize target, and
    each request's host patches (the processor's path; the raw frames
    resized on the host as ``fetch_video`` resizes them) as the
    reference."""
    _, _, tcfg, _ = model_pair(0)
    r = rng(6)
    small, raw = frames(r, T, H, W), frames(r, T, *RAW_HW)
    patches, grid = TPRE.frames_as_images_patches(small)
    raw_patches, _ = TPRE.frames_as_images_patches(
        TRES.resize_frames(torch.from_numpy(raw), H, W).numpy())
    n_tok = patches.shape[0] // tcfg.vision.merge_unit
    kw = dict(grid_thw=grid, vision_token_id=tcfg.image_token_id)
    reqs = {
        "frames": Request(_prompt(tcfg, n_tok, [20, 21]), frames=small, **kw),
        "resize": Request(_prompt(tcfg, n_tok, [22, 23, 24]), frames=raw, resize_hw=(H, W), **kw),
    }
    refs = {"frames": dataclasses.replace(reqs["frames"], frames=None, pixel_patches=patches),
            "resize": dataclasses.replace(reqs["resize"], frames=None, resize_hw=None,
                                          pixel_patches=raw_patches)}
    return reqs, refs


@functools.cache
def _engine_runs():
    """One call of each engine over the two frame requests and a third that
    passes prestage_frames' output of the raw frames (resized), and one
    call of the port over the host-patch references."""
    import jax.numpy as jnp

    from open_o3_video_tpu.engine import InferenceEngine as JaxEngine
    from open_o3_video_tpu.engine import Request as JaxRequest
    from open_o3_video_tpu.engine import SamplingParams as JaxSampling

    jcfg, jparams, tcfg, tparams = model_pair(0)
    reqs, refs = _cases()
    engine = InferenceEngine(tparams, tcfg, cache_dtype=torch.float32)
    staged = engine.prestage_frames([reqs["resize"].frames], resize_hws=[(H, W)])[0]
    pre = dataclasses.replace(reqs["resize"], frames=None, resize_hw=None, pixel_patches=staged)
    calls = [reqs["frames"], reqs["resize"], pre]
    ours = engine.generate(calls, SamplingParams(**SAMPLING), return_logprobs=True)
    plain = engine.generate([refs["frames"], refs["resize"]], SamplingParams(**SAMPLING))
    jeng = JaxEngine(jparams, jcfg, prompt_buckets=(64,), cache_dtype=jnp.float32)
    jstaged = jeng.prestage_frames([reqs["resize"].frames], resize_hws=[(H, W)])[0]
    fields = [f.name for f in dataclasses.fields(Request)]
    jreqs = [JaxRequest(**{f: getattr(r, f) for f in fields}) for r in calls[:2]]
    jreqs.append(dataclasses.replace(jreqs[1], frames=None, resize_hw=None,
                                     pixel_patches=jstaged))
    theirs = jeng.generate(jreqs, JaxSampling(**SAMPLING), return_logprobs=True)
    return {"ours": ours, "plain": plain, "theirs": theirs, "engine": engine, "staged": staged,
            "jstaged": np.asarray(jstaged.astype(jnp.float32))}


@pytest.mark.parametrize("way", ["frames", "frames + resize_hw", "prestage_frames"])
def test_engine_greedy_tokens_equal_jax_and_the_patch_path(way):
    runs = _engine_runs()
    i = ["frames", "frames + resize_hw", "prestage_frames"].index(way)
    o, t = runs["ours"][i], runs["theirs"][i]
    assert o["token_ids"] == [int(x) for x in t["token_ids"]]
    np.testing.assert_allclose(o["logprobs"], t["logprobs"], atol=ATOL_MODEL)
    assert o["token_ids"] == runs["plain"][min(i, 1)]["token_ids"]
    assert 1 <= len(o["token_ids"]) <= SAMPLING["max_tokens"]


def test_frame_uploads_and_tower_input():
    """The admission uploaded each frame array once as uint8 (the third
    request's frames came staged); the staged rows equal the host path's
    bit for bit, and JAX's within 1e-6 (JAX's jitted resize and patchify
    rounds some rows an ulp away from its own host path)."""
    runs = _engine_runs()
    engine = runs["engine"]
    reqs, refs = _cases()
    assert engine.counters["upload_bytes"] == (
        reqs["frames"].frames.nbytes + reqs["resize"].frames.nbytes
        + refs["frames"].pixel_patches.nbytes + refs["resize"].pixel_patches.nbytes)
    assert engine.counters["prestage_upload_bytes"] == reqs["resize"].frames.nbytes
    assert engine.counters["tower_passes"] == 5
    staged = runs["staged"].numpy()
    np.testing.assert_array_equal(staged, refs["resize"].pixel_patches)
    assert np.abs(staged - runs["jstaged"]).max() <= 1e-6


def test_frames_and_patches_never_share_a_prefix_block():
    """Three requests over the same token prefix: two pass equal frames as
    different arrays and share one block; the third passes patches of other
    frames and runs plain (a key without the frames would have given it the
    frames' block). Each request's tokens equal a run without the prefix
    cache and JAX's engine."""
    import jax.numpy as jnp

    from open_o3_video_tpu.engine import InferenceEngine as JaxEngine
    from open_o3_video_tpu.engine import Request as JaxRequest
    from open_o3_video_tpu.engine import SamplingParams as JaxSampling

    jcfg, jparams, tcfg, tparams = model_pair(0)
    reqs, refs = _cases()
    base = reqs["frames"]
    other = TPRE.frames_as_images_patches(frames(rng(7), T, H, W))[0]
    calls = [dataclasses.replace(base, input_ids=base.input_ids + [30]),
             dataclasses.replace(base, input_ids=base.input_ids + [31, 32],
                                 frames=base.frames.copy()),
             dataclasses.replace(refs["frames"], input_ids=base.input_ids + [33],
                                 pixel_patches=other)]
    knobs = dict(prompt_buckets=(64,), prefix_cache_min=8, suffix_buckets=(16,))
    engine = InferenceEngine(tparams, tcfg, cache_dtype=torch.float32, **knobs)
    pl = len(base.input_ids)
    assert engine._detect_prefixes(calls) == [pl, pl, 0]
    resized = dataclasses.replace(calls[0], resize_hw=(H, W))
    assert engine._vis_key(resized) != engine._vis_key(calls[0])
    ours = engine.generate(calls, SamplingParams(**SAMPLING))
    assert engine.counters["prefix_blocks"] == 1 and engine.counters["tower_passes"] == 2
    alone = InferenceEngine(tparams, tcfg, cache_dtype=torch.float32, prefix_cache_min=0)
    assert ours == alone.generate(calls, SamplingParams(**SAMPLING))
    fields = [f.name for f in dataclasses.fields(Request)]
    theirs = JaxEngine(jparams, jcfg, cache_dtype=jnp.float32, **knobs).generate(
        [JaxRequest(**{f: getattr(r, f) for f in fields}) for r in calls],
        JaxSampling(**SAMPLING))
    for o, t in zip(ours, theirs):
        assert o["token_ids"] == [int(x) for x in t["token_ids"]]
