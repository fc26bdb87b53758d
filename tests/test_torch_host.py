"""Host-side numpy code of the port equals the JAX package's: the vision
planner, M-RoPE indices, rotary tables, the processor and the config."""

import dataclasses

import numpy as np
import pytest

from _torch_parity import frames, rng, tiny_configs

from open_o3_video_tpu_torch.data import processor as tproc
from open_o3_video_tpu_torch.models.qwen25vl import config as tconfig
from open_o3_video_tpu_torch.models.qwen25vl import model as tmodel
from open_o3_video_tpu_torch.models.qwen25vl import vision as tvision
from open_o3_video_tpu_torch.ops import rope as trope

GRIDS = {
    "single": [(1, 18, 24)],
    "slice_16_frames": [(1, 18, 24)] * 16,  # ragged: 9x12 merged, 4x4 windows
    "packed_w128": [(1, 18, 26)] * 2,
    "video_t2": [(2, 28, 28)],
    "mixed_resolution": [(1, 18, 24), (1, 28, 40), (1, 10, 14)],
}


def _assert_same(ours, theirs, path):
    if isinstance(ours, (tvision.SegmentSpec,)):
        for f in dataclasses.fields(ours):
            _assert_same(getattr(ours, f.name), getattr(theirs, f.name), f"{path}.{f.name}")
    elif isinstance(ours, np.ndarray):
        assert ours.dtype == np.asarray(theirs).dtype, path
        assert np.array_equal(ours, theirs), path
    else:
        assert ours == theirs, path


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_compute_vision_spec_matches_jax(name, monkeypatch):
    from open_o3_video_tpu.models.qwen25vl import VisionConfig as JaxVisionConfig
    from open_o3_video_tpu.models.qwen25vl.vision import compute_vision_spec

    monkeypatch.delenv("O3V_VIT_PACK", raising=False)  # the JAX default, 2
    grids = GRIDS[name]
    ours = tvision.compute_vision_spec(grids, tconfig.VisionConfig())
    theirs = compute_vision_spec(grids, JaxVisionConfig())
    for f in dataclasses.fields(ours):
        _assert_same(getattr(ours, f.name), getattr(theirs, f.name), f.name)


def test_slice_geometry():
    """16 frames of 18x24 patches: 64-token rows (packing would add pad
    rows), 112 rows, 448-token frames; 18x26 frames pack into 128."""
    spec = tvision.compute_vision_spec(GRIDS["slice_16_frames"], tconfig.VisionConfig())
    assert (spec.win_w, len(spec.padded_index) // spec.win_w, spec.frame_w) == (64, 112, 448)
    assert spec.padded_gids.max() == 3
    assert spec.seq_len == 6912 and len(spec.merged_out_index) == 1728
    wide = tvision.compute_vision_spec(GRIDS["packed_w128"], tconfig.VisionConfig())
    assert wide.win_w == 128


def test_vision_pos_freqs_matches_jax():
    from open_o3_video_tpu.ops.rope import vision_pos_freqs

    grids = [(1, 18, 24), (2, 10, 14)]
    ours = trope.vision_pos_freqs(grids, 2, 80)
    assert np.array_equal(ours, vision_pos_freqs(grids, 2, 80))


def _chat(proc, n_frames):
    body = "".join(
        f"Frame {i + 1} at {i / 2} second: <|vision_start|><|image_pad|><|vision_end|>\n"
        for i in range(n_frames)
    )
    return proc.apply_chat_template([
        {"role": "system", "content": [{"type": "text", "text": "You are a helpful assistant."}]},
        {"role": "user", "content": [{"type": "text", "text": body + "What happens first?"}]},
    ], add_generation_prompt=True)


def test_processor_and_rope_index_match_jax():
    from open_o3_video_tpu.data.processor import ByteTokenizer, O3VideoProcessor
    from open_o3_video_tpu.models.qwen25vl.model import get_rope_index

    jcfg, tcfg = tiny_configs()
    imgs = list(frames(rng(0), 4, 140, 196))
    theirs_proc = O3VideoProcessor(tokenizer=ByteTokenizer.for_config(jcfg))
    ours_proc = tproc.O3VideoProcessor(tokenizer=tproc.ByteTokenizer.for_config(tcfg))
    theirs = theirs_proc(_chat(theirs_proc, 4), images=imgs)
    ours = ours_proc(_chat(ours_proc, 4), images=imgs)
    assert ours.input_ids == theirs.input_ids
    assert np.array_equal(ours.pixel_patches, theirs.pixel_patches)
    assert np.array_equal(ours.grid_thw, theirs.grid_thw)
    assert ours_proc.decode(ours.input_ids[:40]) == theirs_proc.decode(theirs.input_ids[:40])

    ids = np.asarray([ours.input_ids, [7] * 5 + ours.input_ids[5:]])
    mask = np.ones_like(ids)
    mask[1, :5] = 0
    grids = np.concatenate([ours.grid_thw, ours.grid_thw])  # 4 images per row
    for kw in ({}, {"attention_mask": mask}):
        pos_o, delta_o = tmodel.get_rope_index(tcfg, ids, image_grid_thw=grids, **kw)
        pos_t, delta_t = get_rope_index(jcfg, ids, image_grid_thw=grids, **kw)
        assert np.array_equal(pos_o, pos_t) and np.array_equal(delta_o, delta_t)
    pos_o, _ = tmodel.get_rope_index(tcfg, ids[:, :20], attention_mask=mask[:, :20])
    pos_t, _ = get_rope_index(jcfg, ids[:, :20], attention_mask=mask[:, :20])
    assert np.array_equal(pos_o, pos_t)


def test_build_vision_row_index_matches_jax():
    from open_o3_video_tpu.models.qwen25vl.model import build_vision_row_index

    ids = np.array([[5, 103, 103, 6], [103, 7, 103, 103]])
    for tok, offs in ((103, [0, 2]), ([103, None], [0, None])):
        assert np.array_equal(
            tmodel.build_vision_row_index(ids, tok, offs), build_vision_row_index(ids, tok, offs)
        )


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    return d


def test_config_defaults_and_tiny_match_jax():
    from open_o3_video_tpu.models.qwen25vl import Qwen25VLConfig as JaxConfig

    assert _fields(tconfig.Qwen25VLConfig()) == _fields(JaxConfig())
    assert _fields(tconfig.Qwen25VLConfig.tiny()) == _fields(JaxConfig.tiny())
    assert tconfig.Qwen25VLConfig().vision.head_dim == 80
    assert tconfig.Qwen25VLConfig().text.head_dim == 128
    hf = JaxConfig().to_hf_dict()
    assert _fields(tconfig.Qwen25VLConfig.from_hf_dict(hf)) == _fields(JaxConfig.from_hf_dict(hf))
    # Qwen3-VL-MoE is read as JAX reads it; an Aria file is Aria's config's
    hf = {"model_type": "qwen3_vl_moe"}
    assert _fields(tconfig.Qwen25VLConfig.from_hf_dict(hf)) == _fields(JaxConfig.from_hf_dict(hf))
    assert tconfig.TextConfig(moe_num_experts=4).moe_num_experts == 4
    assert tconfig.Qwen25VLConfig(model_type="qwen3_vl_moe").model_type == "qwen3_vl_moe"
    for make in (lambda: tconfig.Qwen25VLConfig.from_hf_dict({"model_type": "aria"}),
                 lambda: tconfig.Qwen25VLConfig(model_type="aria")):
        with pytest.raises(ValueError, match="load_model"):
            make()
