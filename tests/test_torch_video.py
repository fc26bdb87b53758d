"""Video ingestion of the port (open_o3_video_tpu_torch/data/video.py and
ops/resize.py) against the JAX package's data/video.py: the reading plan
(frame count, indices, trim window, sample fps, resized size), the decoded
frames, and the bicubic resize within one LSB of PIL's; and the inference
script's --video, which reads with the native decoder or OpenCV or exits
naming what is missing.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import REPO_ROOT, frames, no_video_reader, rng  # noqa: F401

from open_o3_video_tpu_torch.data import video as TV
from open_o3_video_tpu_torch.ops.resize import resize_frames

EXAMPLE_VIDEO = "/root/reference/eval/example_video.mp4"
ELEMENTS = [{"nframes": 16}, {"fps": 2.0}, {"nframes": 4, "video_start": 1.0, "video_end": 2.5}]


@pytest.fixture(scope="module")
def synthetic_video(tmp_path_factory):
    """37 frames of 96x160 at 10 fps, MJPG in AVI (OpenCV writes it)."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path_factory.mktemp("video") / "synthetic.avi")
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (160, 96))
    r = rng(11)
    for i in range(37):
        frame = r.integers(0, 256, (96, 160, 3), dtype=np.uint8) // 4 + (i * 5) % 128
        out.write(frame.astype(np.uint8))
    out.release()
    return path


def _video(which, synthetic_video):
    if which == "example":
        pytest.importorskip("cv2")
        if not os.path.exists(EXAMPLE_VIDEO):
            pytest.skip(f"{EXAMPLE_VIDEO} is not here")
        return EXAMPLE_VIDEO
    return synthetic_video


@pytest.mark.parametrize("ele", ELEMENTS, ids=["nframes", "fps", "trimmed"])
@pytest.mark.parametrize("which", ["synthetic", "example"])
def test_decode_plan_and_frames_match_jax(which, ele, synthetic_video):
    from open_o3_video_tpu.data import video as JV

    path = _video(which, synthetic_video)
    ours, our_fps = TV._read_video_cv2({"video": path, **ele})
    theirs, their_fps = JV._read_video_cv2({"video": path, **ele})
    assert our_fps == their_fps
    np.testing.assert_array_equal(ours, theirs)
    got, fps = TV.fetch_video({"video": path, **ele})
    t, _, h, w = theirs.shape
    want_h, want_w = JV.smart_resize(
        h, w, min_pixels=JV.VIDEO_MIN_PIXELS,
        max_pixels=max(min(JV.VIDEO_MAX_PIXELS, JV.VIDEO_TOTAL_PIXELS / t * JV.FRAME_FACTOR),
                       int(JV.VIDEO_MIN_PIXELS * 1.05)))
    assert fps == their_fps and got.shape == (t, 3, want_h, want_w) and got.dtype == np.float32
    pil = JV.resize_video_frames(theirs, want_h, want_w)
    assert np.abs(got - pil).max() <= 1.0


@pytest.mark.parametrize("total,video_fps", [(491, 22.29), (37, 10.0), (8, 30.0), (3000, 29.97)])
def test_planning_functions_match_jax(total, video_fps):
    from open_o3_video_tpu.data import video as JV

    for ele in ELEMENTS + [{"fps": 1.0, "min_frames": 6, "max_frames": 12}]:
        ele = {k: v for k, v in ele.items() if not k.startswith("video_")}
        try:
            want = JV.smart_nframes(ele, total, video_fps)
        except ValueError:
            with pytest.raises(ValueError):
                TV.smart_nframes(ele, total, video_fps)
            continue
        assert TV.smart_nframes(ele, total, video_fps) == want
        np.testing.assert_array_equal(TV.sample_indices(total, want), JV.sample_indices(total, want))
    seconds = total / video_fps
    window = {"video_start": 0.13 * seconds, "video_end": 0.61 * seconds}
    assert TV.trim_window(window, total, video_fps) == JV.trim_window(window, total, video_fps)
    for h, w in ((360, 640), (1080, 1920), (27, 3000), (100, 100)):
        assert TV.smart_resize(h, w) == JV.smart_resize(h, w)
        assert (TV.smart_resize(h, w, min_pixels=TV.VIDEO_MIN_PIXELS, max_pixels=TV.VIDEO_MAX_PIXELS)
                == JV.smart_resize(h, w, min_pixels=JV.VIDEO_MIN_PIXELS,
                                   max_pixels=JV.VIDEO_MAX_PIXELS))


@pytest.mark.parametrize("src,dst", [((360, 640), (252, 448)), ((96, 160), (56, 84)),
                                     ((50, 70), (84, 112))])
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_resize_within_one_lsb_of_pil(src, dst, kind):
    """Down- and upscaling, on noise and on smooth ramps (where PIL's sums
    land on rounding ties)."""
    from open_o3_video_tpu.data.video import resize_video_frames

    x = frames(rng(5), 2, *src)
    if kind == "smooth":
        ramp = np.add.outer(np.arange(src[0]), np.arange(src[1])) % 256
        x = np.broadcast_to(ramp, x.shape).astype(np.uint8)
    ours = resize_frames(torch.from_numpy(x), *dst).numpy()
    theirs = resize_video_frames(x, *dst)
    assert ours.shape == theirs.shape == (2, 3, *dst)
    assert np.abs(ours - theirs).max() <= 1.0


def test_fetch_video_names_a_missing_reader(no_video_reader):
    with pytest.raises(ImportError, match="cv2"):
        TV.fetch_video({"video": "any.mp4", "nframes": 4})


# Runs a script (argv[1]) with cv2 importable, blocked, or blocked with the
# native decoder reported as missing its libav too (argv[2]), then says
# whether the JAX package was imported.
RUN_SCRIPT = (
    "import runpy, sys\n"
    "script, mode = sys.argv.pop(1), sys.argv.pop(1)\n"
    "sys.argv[0] = script\n"
    "if mode in ('blocked', 'none'):\n"
    "    sys.modules['cv2'] = None\n"
    "if mode == 'none':\n"
    "    import open_o3_video_tpu_torch.native.video_decoder as vd\n"
    "    vd.missing = lambda: ['libavformat/avformat.h']\n"
    "runpy.run_path(script, run_name='__main__')\n"
    "print('JAX package imported:', any(m.split('.')[0] == 'open_o3_video_tpu' for m in sys.modules))\n"
)


@pytest.mark.parametrize("cv2", ["present", "blocked", "none"])
def test_inference_example_reads_a_video_with_the_port(cv2, synthetic_video):
    """cv2 present: OpenCV or the native decoder reads the video; cv2
    blocked: the native decoder does; neither reader: the script exits
    naming them."""
    from open_o3_video_tpu_torch.native import video_decoder

    if cv2 == "blocked" and video_decoder.missing():
        pytest.skip(f"the native decoder needs {video_decoder.missing()}")
    script = os.path.join(REPO_ROOT, "scripts", "inference_example_torch.py")
    proc = subprocess.run(
        [sys.executable, "-c", RUN_SCRIPT, script, cv2, "--tiny-demo", "--device", "cpu",
         "--nframes", "4", "--max_tokens", "2", "--questions", "What?", "--video", synthetic_video],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO_ROOT),
    )
    if cv2 != "none":
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "[tiny-demo on cpu: 2 tokens generated" in proc.stdout
        assert "JAX package imported: False" in proc.stdout
    else:
        assert proc.returncode == 2 and "cv2" in proc.stderr
        assert "tokens generated" not in proc.stdout
