"""The port's RL dataset (``data/rl_dataset.py``, ``data/media_roots.py``,
``data/video.py``'s image reading) against the JAX package's
``data/rl_dataset.py`` on the CPU: a tiny mp4, a JPEG keyframe and a PNG
image written with OpenCV under ``tmp_path`` in the reference's media layout.

- ``load_rl_dataset`` and ``_clean_none``: equal outputs.
- ``rl_sample_from_frames`` on the frames and keyframe JAX decoded: the same
  sample (ids, grids, patches, reward columns), exactly.
- ``prepare_rl_sample`` end to end (JAX reads with PIL, the port with cv2
  and its PIL-parity bicubic): the same ids, grids and reward columns, and
  patches within one uint8 step after normalization (1 / 255 / the smallest
  channel std), the resize's stated parity with PIL.
- ``read_image``/``fetch_image`` against PIL's ``convert("RGB")`` (gray,
  RGBA on white) and the default ``Image.resize`` (bicubic for RGB).
- Without cv2, ``prepare_rl_sample`` raises an ImportError that says so.
"""

import copy
import json
import os
import sys

import numpy as np
import pytest

from _torch_parity import rng

from open_o3_video_tpu_torch.data import rl_dataset as TD
from open_o3_video_tpu_torch.data import video as TV
from open_o3_video_tpu_torch.data.processor import O3VideoProcessor

cv2 = pytest.importorskip("cv2")

# 1 / 255 over the smallest channel std of the patch normalization
PATCH_LSB = (1 / 255) / 0.26130258 * 1.001

EXAMPLES = [
    {"task": "temporal-spatial free-form QA", "source": "STR_plm_rdcap",
     "video_path": "clip.mp4", "question": "What rolls toward the pins?",
     "answer": "the red ball", "key_frames": [{"time": 1.0, "idx": 0, "path": "kf0.jpg"}],
     "key_items": {"0": {"ball": [[0.1, 0.2, 0.5, 0.8]], "pin": None}, "1": None}},
    {"task": "temporal QA", "source": "TVG_r1", "video_path": "clip.mp4",
     "question": "When does the ball roll?", "answer": "[0.5, 1.5]"},
    {"task": "General video QA MCQ", "source": "videor1_mcq", "video_path": "clip.mp4",
     "question": "What rolls? A. a ball B. a cup", "answer": "A"},
    {"task": "visual QA", "source": "gqa", "image_path": "img.png",
     "question": "Where is the cat?", "answer": "<obj>cat</obj><box>[1,2,30,40]</box>",
     "image_size": [90, 70]},
    {"task": "General video QA Free-form", "source": "videor1_ff", "video_path": "clip.mp4",
     "question": "dropped by the multiple-of-4 cut", "answer": "x"},
]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """The reference's media layout with one 24-frame 96x160 mp4 (10 fps)
    under each video source used, a JPEG keyframe and an RGBA PNG image."""
    root = tmp_path_factory.mktemp("rl_data")
    r = rng(21)
    frames = [(r.integers(0, 256, (96, 160, 3)) // 3 + i * 7 % 120).astype(np.uint8)
              for i in range(24)]
    for sub in ("stgr/plm/videos", "tvg_r1", "videor1"):
        d = root / "videos" / sub
        d.mkdir(parents=True)
        out = cv2.VideoWriter(str(d / "clip.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (160, 96))
        for f in frames:
            out.write(f)
        out.release()
    (root / "videos/stgr/plm/kfs").mkdir(parents=True)
    cv2.imwrite(str(root / "videos/stgr/plm/kfs/kf0.jpg"),
                r.integers(0, 256, (120, 200, 3)).astype(np.uint8))
    (root / "videos/gqa").mkdir(parents=True)
    rgba = r.integers(0, 256, (70, 90, 4)).astype(np.uint8)
    cv2.imwrite(str(root / "videos/gqa/img.png"), rgba)
    path = root / "rl.json"
    path.write_text(json.dumps(EXAMPLES))
    return str(root)


@pytest.fixture
def jax_cv2(monkeypatch):
    """The JAX package's video reader set to OpenCV (its native decoder may
    be built here or not)."""
    from open_o3_video_tpu.data import video as JV

    monkeypatch.setattr(JV, "get_video_reader_backend", lambda: "cv2")
    return JV


def _proc():
    from open_o3_video_tpu.data.processor import O3VideoProcessor as JaxProcessor

    return O3VideoProcessor(), JaxProcessor()


def test_load_rl_dataset_matches_jax(data_root, capsys):
    from open_o3_video_tpu.data import rl_dataset as JD

    path = os.path.join(data_root, "rl.json")
    ours, theirs = TD.load_rl_dataset(path), JD.load_rl_dataset(path)
    assert ours == theirs and len(ours) == 4 and "prompt" in ours[0]
    jsonl = os.path.join(data_root, "rl.jsonl")
    with open(jsonl, "w") as f:
        f.write("\n".join(json.dumps(e) for e in EXAMPLES[:4]) + "\n\n")
    assert TD.load_rl_dataset(jsonl) == JD.load_rl_dataset(jsonl)


def test_clean_none_matches_jax():
    from open_o3_video_tpu.data import rl_dataset as JD
    from open_o3_video_tpu.grounding.prompts import make_conversation

    ex = make_conversation(copy.deepcopy(EXAMPLES[0]))
    ex["prompt"][1]["content"][0]["video"] = None
    assert TD._clean_none(copy.deepcopy(ex)) == JD._clean_none(copy.deepcopy(ex))
    assert TD._clean_none(copy.deepcopy(ex))["key_items"] == {"0": {"ball": [[0.1, 0.2, 0.5, 0.8]]}}


def _assert_same_sample(ours, theirs, patch_atol=0.0):
    assert ours.keys() == theirs.keys()
    assert ours["input_ids"] == theirs["input_ids"]
    np.testing.assert_array_equal(ours["grid_thw"], theirs["grid_thw"])
    assert ours["vision_token_id"] == theirs["vision_token_id"]
    assert ours["reward_kwargs"] == theirs["reward_kwargs"]
    np.testing.assert_allclose(ours["pixel_patches"], theirs["pixel_patches"], atol=patch_atol,
                               rtol=0)


@pytest.mark.parametrize("index", [0, 1, 2], ids=["temporal-spatial", "temporal", "mcq"])
def test_sample_from_jax_decoded_frames_is_jax_sample(data_root, jax_cv2, index):
    """The part after decoding, on the frames (and keyframe) JAX read."""
    from open_o3_video_tpu.data import rl_dataset as JD
    from open_o3_video_tpu.data.media_roots import resolve_media

    example = EXAMPLES[index]
    tproc, jproc = _proc()
    want = JD.prepare_rl_sample(example, jproc, data_root, nframes=4)
    _, path = resolve_media(example, data_root)
    video, fps = jax_cv2.fetch_video({"video": path, "nframes": 4}, return_video_sample_fps=True)
    keyframes = None
    if example.get("key_frames"):
        keyframes = JD._load_keyframes(JD._clean_none(copy.deepcopy(example)), data_root,
                                       (video.shape[3], video.shape[2]))
    got = TD.rl_sample_from_frames(example, tproc, list(video), fps, keyframes)
    _assert_same_sample(got, want)
    if index == 0:  # the keyframe is interleaved: 5 images
        assert len(got["grid_thw"]) == 5 and "Frame 5" in got["reward_kwargs"]["prompt_text_final"]


@pytest.mark.parametrize("index", [0, 1, 2, 3], ids=["temporal-spatial", "temporal", "mcq", "image"])
def test_prepare_rl_sample_matches_jax(data_root, jax_cv2, index):
    from open_o3_video_tpu.data import rl_dataset as JD

    tproc, jproc = _proc()
    want = JD.prepare_rl_sample(EXAMPLES[index], jproc, data_root, nframes=4)
    got = TD.prepare_rl_sample(EXAMPLES[index], tproc, data_root, nframes=4)
    _assert_same_sample(got, want, patch_atol=PATCH_LSB)
    if index == 3:
        assert got["reward_kwargs"]["image_size_refine"] == (84, 56)


def test_images_read_as_pil_reads_them(data_root, tmp_path):
    """read_image == PIL's to_rgb(Image.open(...)) for RGB (JPEG), gray and
    RGBA (flattened on white); fetch_image within one LSB of JAX's, whose
    Image.resize default for RGB is bicubic."""
    from PIL import Image

    from open_o3_video_tpu.data import video as JV

    gray = tmp_path / "gray.png"
    cv2.imwrite(str(gray), rng(5).integers(0, 256, (33, 47)).astype(np.uint8))
    for path in (os.path.join(data_root, "videos/stgr/plm/kfs/kf0.jpg"),
                 os.path.join(data_root, "videos/gqa/img.png"), str(gray)):
        want = np.asarray(JV.to_rgb(Image.open(path)))
        np.testing.assert_array_equal(TV.read_image(path), want, err_msg=path)
        img = Image.open(path).convert("RGB")
        assert np.array_equal(np.asarray(img.resize((61, 37))),
                              np.asarray(img.resize((61, 37), Image.Resampling.BICUBIC)))
        pil = np.asarray(JV.fetch_image({"image": path, "min_pixels": 28 * 28 * 8})).transpose(2, 0, 1)
        ours = TV.fetch_image({"image": path, "min_pixels": 28 * 28 * 8})
        assert ours.shape == pil.shape and ours.dtype == np.uint8
        assert np.abs(ours.astype(int) - pil.astype(int)).max() <= 1


def test_prepare_without_cv2_says_so(data_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    for example in (EXAMPLES[1], EXAMPLES[3]):
        with pytest.raises(ImportError, match="cv2"):
            TD.prepare_rl_sample(example, O3VideoProcessor(), data_root, nframes=4)
