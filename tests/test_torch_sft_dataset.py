"""The port's SFT dataset (``data/sft_dataset.py``: ``load_sft_dataset``,
``prepare_sft_example``, ``collate_sft``, ``collate_sft_batch``) against the
JAX package's on the CPU, for all four tasks, over a tiny dataset in the
reference's media layout (``_torch_sft_data.py``: a raw AVI, PNG keyframe and
image), each package's video reader set to the same backend (native or cv2;
JAX reads images with PIL, the port with cv2 or the native decoder).

- ``load_sft_dataset`` and ``prepare_sft_example``: equal outputs (and the
  same error for an unknown task).
- ``collate_sft``: input ids, labels, M-RoPE positions, grids and the vision
  token exactly equal; patches within one uint8 step after normalization
  (1 / 255 / the smallest channel std), the PIL-parity resize's bound.
- ``collate_sft_batch``: the packed batch of two examples, the same way.
- The temporal and general branches are ``collate_sft_frames`` on the
  fetched frames, exactly.
"""

import json
import os

import numpy as np
import pytest

from _torch_parity import jax_reader, port_reader, tiny_configs  # noqa: F401
from _torch_sft_data import EXAMPLES, TASK_IDS, sft_root  # noqa: F401

from open_o3_video_tpu_torch.data import sft_dataset as TD
from open_o3_video_tpu_torch.data.processor import ByteTokenizer, O3VideoProcessor

# 1 / 255 over the smallest channel std of the patch normalization
PATCH_LSB = (1 / 255) / 0.26130258 * 1.001
NFRAMES = 4


def _pair():
    """(port cfg, port processor, JAX cfg, JAX processor) at tiny dims."""
    from open_o3_video_tpu.data.processor import ByteTokenizer as JaxByteTokenizer
    from open_o3_video_tpu.data.processor import O3VideoProcessor as JaxProcessor

    jcfg, tcfg = tiny_configs()
    return (tcfg, O3VideoProcessor(tokenizer=ByteTokenizer.for_config(tcfg)),
            jcfg, JaxProcessor(tokenizer=JaxByteTokenizer.for_config(jcfg)))


def _assert_same_single(ours, theirs):
    assert ours.keys() == theirs.keys()
    for key in ("input_ids", "labels", "position_ids", "grid_thw"):
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    assert ours["vision_token_id"] == theirs["vision_token_id"]
    np.testing.assert_allclose(ours["pixel_patches"], theirs["pixel_patches"], atol=PATCH_LSB,
                               rtol=0)


def test_load_sft_dataset_matches_jax(sft_root, tmp_path):
    from open_o3_video_tpu.data import sft_dataset as JD

    path = os.path.join(sft_root, "sft.json")
    assert TD.load_sft_dataset(path) == JD.load_sft_dataset(path) == EXAMPLES
    jsonl = tmp_path / "sft.jsonl"
    jsonl.write_text("\n".join(json.dumps(e) for e in EXAMPLES) + "\n\n")
    assert TD.load_sft_dataset(str(jsonl)) == JD.load_sft_dataset(str(jsonl)) == EXAMPLES


@pytest.mark.parametrize("index", range(len(EXAMPLES)), ids=TASK_IDS)
def test_prepare_sft_example_matches_jax(sft_root, index):
    from open_o3_video_tpu.data import sft_dataset as JD

    data = os.path.join(sft_root, "data")
    ours = TD.prepare_sft_example(EXAMPLES[index], data)
    assert ours == JD.prepare_sft_example(EXAMPLES[index], data)
    assert ours["messages"][2]["content"][0]["text"].startswith("<think>")
    bad = {**EXAMPLES[index], "task": "dense captioning"}
    for fn in (TD.prepare_sft_example, JD.prepare_sft_example):
        with pytest.raises(ValueError, match="Unknown task"):
            fn(bad, data)


@pytest.mark.parametrize("index", range(4), ids=TASK_IDS[:4])
@pytest.mark.parametrize("backend", ["native", "cv2"])
def test_collate_sft_matches_jax(sft_root, backend, index, port_reader, jax_reader):
    from open_o3_video_tpu.data import sft_dataset as JD

    if backend == "cv2":
        pytest.importorskip("cv2")
    port_reader(backend)
    jax_reader(backend)
    tcfg, tproc, jcfg, jproc = _pair()
    data = os.path.join(sft_root, "data")
    prepared = TD.prepare_sft_example(EXAMPLES[index], data)
    ours = TD.collate_sft(prepared, tproc, tcfg, data, nframes=NFRAMES)
    _assert_same_single(ours, JD.collate_sft(prepared, jproc, jcfg, data, nframes=NFRAMES))
    n_images = {0: 1, 1: NFRAMES + 1}.get(index, NFRAMES)  # the keyframe interleaved
    assert len(ours["grid_thw"]) == n_images
    assert (ours["labels"] != TD.IGNORE_INDEX).sum() > 0


def test_collate_sft_batch_matches_jax(sft_root, port_reader, jax_reader):
    from open_o3_video_tpu.data import sft_dataset as JD

    port_reader("native")
    jax_reader("native")
    tcfg, tproc, jcfg, jproc = _pair()
    data = os.path.join(sft_root, "data")
    group = [TD.prepare_sft_example(ex, data) for ex in EXAMPLES[1:3]]
    ours = TD.collate_sft_batch(group, tproc, tcfg, data, nframes=NFRAMES, pad_multiple=16)
    theirs = JD.collate_sft_batch(group, jproc, jcfg, data, nframes=NFRAMES, pad_multiple=16)
    assert ours.keys() == theirs.keys()
    for key in ours:
        if key == "pixel_patches":
            np.testing.assert_allclose(ours[key], theirs[key], atol=PATCH_LSB, rtol=0)
        else:
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


@pytest.mark.parametrize("index", [2, 3, 4], ids=TASK_IDS[2:])
def test_video_qa_branches_are_collate_sft_frames(sft_root, index, port_reader):
    from open_o3_video_tpu_torch.data.video import fetch_video

    port_reader("native")
    tcfg, tproc, _, _ = _pair()
    data = os.path.join(sft_root, "data")
    prepared = TD.prepare_sft_example(EXAMPLES[index], data)
    got = TD.collate_sft(prepared, tproc, tcfg, data, nframes=NFRAMES)
    video, fps = fetch_video({**prepared["messages"][1]["content"][0], "nframes": NFRAMES})
    want = TD.collate_sft_frames(prepared["messages"], list(video), fps, tproc, tcfg)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
