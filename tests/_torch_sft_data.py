"""A tiny SFT dataset in the reference's media layout, for the SFT tests of
the port (``test_torch_sft_dataset.py``, ``test_torch_sft_main.py``): one
raw AVI (8 frames of 56x84 at 4 fps) under each video source, a PNG
keyframe and a PNG image, all written without an encoder
(``data/raw_media.py``), and one example of each task in the STGR-CoT
format."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from open_o3_video_tpu_torch.data.raw_media import write_png, write_raw_avi

EXAMPLES = [
    {"task": "visual QA", "source": "treevgr", "image_path": "img.png",
     "question": "Where is the cat?",
     "reasoning_process": "The <obj>cat</obj><box>[10,20,60,50]</box> sits on the left.",
     "answer": "left", "image_size": [90, 70]},
    {"task": "temporal-spatial free-form QA", "source": "STR_plm_rdcap", "video_path": "clip.avi",
     "question": "What rolls toward the pins?",
     "reasoning_process": "A <obj>ball</obj><box>[0.1,0.2,0.5,0.8]</box>at<t>1.0</t>s rolls.",
     "answer": "the red ball", "key_frames": [{"time": 1.0, "idx": 0, "path": "kf0.png"}]},
    {"task": "temporal QA", "source": "TVG_r1", "video_path": "clip.avi",
     "question": "When does the ball roll?", "reasoning_process": "It rolls from <t>0.5</t>s.",
     "answer": "[0.5, 1.5]"},
    {"task": "General video QA MCQ", "source": "videor1_mcq", "video_path": "clip.avi",
     "question": "What rolls? A. a ball B. a cup", "reasoning_process": "It is round.",
     "answer": "A"},
    {"task": "General video QA Free-form", "source": "videor1_ff", "video_path": "clip.avi",
     "question": "What happens?", "reasoning_process": "Something rolls.",
     "answer": "a ball rolls"},
]
TASK_IDS = ["visual", "temporal-spatial", "temporal", "mcq", "free-form"]


def write_sft_data(root, seed: int = 41) -> str:
    """The media under ``root/data`` and ``root/sft.json`` (EXAMPLES);
    returns the data root."""
    r = np.random.default_rng(seed)
    data = os.path.join(str(root), "data")
    frames = r.integers(0, 256, (8, 56, 84, 3), dtype=np.uint8)
    for sub in ("stgr/plm/videos", "tvg_r1", "videor1"):
        os.makedirs(os.path.join(data, "videos", sub))
        write_raw_avi(os.path.join(data, "videos", sub, "clip.avi"), frames, 4.0)
    kf_dir = os.path.join(data, "videos/stgr/plm/kfs")
    os.makedirs(kf_dir)
    write_png(os.path.join(kf_dir, "kf0.png"), r.integers(0, 256, (60, 100, 3), dtype=np.uint8))
    os.makedirs(os.path.join(data, "videos/treevgr"))
    write_png(os.path.join(data, "videos/treevgr/img.png"),
              r.integers(0, 256, (70, 90, 3), dtype=np.uint8))
    with open(os.path.join(str(root), "sft.json"), "w") as f:
        json.dump(EXAMPLES, f)
    return data


@pytest.fixture(scope="module")
def sft_root(tmp_path_factory):
    """A directory holding ``sft.json`` and ``data/`` (``write_sft_data``)."""
    root = tmp_path_factory.mktemp("sft")
    write_sft_data(root)
    return str(root)
