"""The port's libav decoder (``native/video_decoder.py``, ``native/src``), its
reader selection in ``data/video.py`` and the lossless writers of
``data/raw_media.py``, against the JAX package's decoder and OpenCV on the
CPU. Tests that need cv2, the libav headers or the JAX package's built
decoder skip inside the test where these are missing.

- The C++ source is the JAX package's, byte for byte.
- ``probe``, ``decode_frames`` (indices unsorted and repeated) and
  ``decode_frames_scaled`` (bicubic and bilinear) equal JAX's decoder bit
  for bit on a cv2-written MJPG and on the raw AVI, and equal cv2's decode.
- The raw AVI and the PNGs (RGB, gray) read back exactly through cv2 and
  both decoders.
- ``fetch_video`` with the native reader equals JAX's ``fetch_video`` with
  its native reader: the same frames decoded, resized within the PIL bound
  of ``test_torch_video.py`` (1.0).
- ``FORCE_VIDEO_READER`` is honoured and the choice printed once; with cv2
  blocked a corrupt file raises IOError (the native error), not
  ImportError; with cv2 present the native failure is retried with cv2.
- ``available()`` names what is missing; a failed build raises with g++'s
  stderr; a 0 resize dimension raises ValueError before swscale sees it.
- ``read_image`` without cv2 reads through the decoder: PNG exact, JPEG
  within the gap ``scripts/measure_image_reader_gap.py`` measures.
"""

import os
import sys

import numpy as np
import pytest

from _torch_parity import REPO_ROOT, jax_reader, port_reader, rng  # noqa: F401

from open_o3_video_tpu_torch.data import video as TV
from open_o3_video_tpu_torch.data.raw_media import write_png, write_raw_avi
from open_o3_video_tpu_torch.native import video_decoder as TVD

ELEMENTS = [{"nframes": 8}, {"fps": 2.0}, {"nframes": 4, "video_start": 0.5, "video_end": 1.5}]


def _native():
    if TVD.missing():
        pytest.skip(f"the native decoder needs {TVD.missing()}")
    return TVD


def _jax_native():
    from open_o3_video_tpu.native import video_decoder as JVD

    if not JVD.available():
        pytest.skip("the JAX package's native decoder is not built and cannot be")
    return JVD


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """A raw AVI (12 frames of 56x84 noise at 6 fps), an RGB and a gray PNG,
    and, where cv2 is installed, an MJPG AVI of 12 low-contrast frames of
    64x96 (as ``test_torch_video.py``'s; cv2's FFmpeg and the system libav
    decode a JPEG whose width is not a multiple of 16 differently in its last
    columns: 4 of 84 at 56x84)."""
    d = tmp_path_factory.mktemp("media")
    r = rng(31)
    out = {"frames": r.integers(0, 256, (12, 56, 84, 3), dtype=np.uint8),
           "png": r.integers(0, 256, (50, 70, 3), dtype=np.uint8),
           "gray": r.integers(0, 256, (33, 47), dtype=np.uint8)}
    out["raw.avi"] = str(d / "raw.avi")
    write_raw_avi(out["raw.avi"], out["frames"], 6.0)
    for name in ("png", "gray"):
        out[f"{name}.png"] = str(d / f"{name}.png")
        write_png(out[f"{name}.png"], out[name])
    try:
        import cv2
    except ImportError:
        return out
    out["mjpg.avi"] = str(d / "mjpg.avi")
    writer = cv2.VideoWriter(out["mjpg.avi"], cv2.VideoWriter_fourcc(*"MJPG"), 6.0, (96, 64))
    for i in range(12):
        writer.write((r.integers(0, 256, (64, 96, 3)) // 4 + (i * 5) % 128).astype(np.uint8))
    writer.release()
    return out


def _cv2_frames(path):
    cv2 = pytest.importorskip("cv2")
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[:, :, ::-1])
    cap.release()
    return np.stack(frames)


def test_decoder_source_is_the_jax_package_source():
    ours = os.path.join(REPO_ROOT, "open_o3_video_tpu_torch/native/src/video_decoder.cc")
    theirs = os.path.join(REPO_ROOT, "open_o3_video_tpu/native/src/video_decoder.cc")
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", ["raw.avi", "mjpg.avi"])
def test_decoder_matches_jax_and_cv2(media, name):
    T, J = _native(), _jax_native()
    if name not in media:
        pytest.skip("writing an MJPG needs cv2")
    path = media[name]
    meta, theirs = T.probe(path), J.probe(path)
    assert vars(meta) == vars(theirs)
    assert meta.num_frames == 12 and meta.fps == 6.0
    idx = np.array([7, 0, 3, 3, 11, 5])
    ours = T.decode_frames(path, idx)
    np.testing.assert_array_equal(ours, J.decode_frames(path, idx))
    np.testing.assert_array_equal(ours, _cv2_frames(path)[idx])
    if name == "raw.avi":
        np.testing.assert_array_equal(ours, media["frames"][idx])
    for bicubic in (True, False):
        np.testing.assert_array_equal(T.decode_frames_scaled(path, idx, 40, 26, bicubic),
                                      J.decode_frames_scaled(path, idx, 40, 26, bicubic))


@pytest.mark.parametrize("reader", ["cv2", "native", "jax-native"])
@pytest.mark.parametrize("name", ["raw.avi", "png.png", "gray.png"])
def test_lossless_files_read_back_exactly(media, name, reader):
    path = media[name]
    want = media["frames"] if name == "raw.avi" else media[name.split(".")[0]]
    if want.ndim == 2:
        want = np.repeat(want[:, :, None], 3, axis=2)
    if reader == "cv2":
        if name == "raw.avi":
            got = _cv2_frames(path)
        else:
            pytest.importorskip("cv2")
            got = TV.read_image(path)
    else:
        dec = _native() if reader == "native" else _jax_native()
        meta = dec.probe(path)
        if name == "raw.avi":
            got = dec.decode_frames(path, np.arange(meta.num_frames))
        else:
            assert meta.num_frames == 0  # a PNG: one frame, counted as 0
            got = dec.decode_frames_scaled(path, [0], meta.width, meta.height, bicubic=False)[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ele", ELEMENTS, ids=["nframes", "fps", "trimmed"])
@pytest.mark.parametrize("name", ["raw.avi", "mjpg.avi"])
def test_fetch_video_native_matches_jax_native(media, name, ele, port_reader, jax_reader):
    if name not in media:
        pytest.skip("writing an MJPG needs cv2")
    port_reader("native")
    JV = jax_reader("native")
    ele = {"video": media[name], **ele}
    ours, fps = TV.fetch_video(dict(ele))
    theirs, their_fps = JV.fetch_video(dict(ele), return_video_sample_fps=True)
    raw, raw_fps = TV._read_video_native(dict(ele))
    np.testing.assert_array_equal(raw, JV._read_video_native(dict(ele))[0])
    assert fps == their_fps == raw_fps and ours.shape == theirs.shape
    assert np.abs(ours - theirs).max() <= 1.0


def test_force_video_reader_is_honoured(monkeypatch, capsys, port_reader):
    port_reader("cv2")
    assert TV.get_video_reader_backend() == "cv2"
    assert TV.get_video_reader_backend() == "cv2"
    err = capsys.readouterr().err
    assert err.count("using cv2 to read video (FORCE_VIDEO_READER)") == 1  # printed once
    port_reader("native")
    assert TV.get_video_reader_backend() == "native"
    monkeypatch.setattr(TV, "FORCE_VIDEO_READER", "decord")
    TV.get_video_reader_backend.cache_clear()
    with pytest.raises(RuntimeError, match="FORCE_VIDEO_READER='decord'"):
        TV.get_video_reader_backend()
    monkeypatch.setattr(TV, "FORCE_VIDEO_READER", None)
    TV.get_video_reader_backend.cache_clear()
    assert TV.get_video_reader_backend() == ("cv2" if TVD.missing() else "native")


def test_a_corrupt_file_raises_the_native_error_without_cv2(tmp_path, monkeypatch, capsys,
                                                             port_reader):
    port_reader("native")
    bad = tmp_path / "corrupt.mp4"
    bad.write_bytes(rng(2).integers(0, 256, 4096, dtype=np.uint8).tobytes())
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(IOError, match="o3v_probe failed"):
        TV.fetch_video({"video": str(bad), "nframes": 2})
    monkeypatch.delitem(sys.modules, "cv2")
    pytest.importorskip("cv2")
    with pytest.raises(IOError, match="cv2 failed to open video"):  # retried with cv2
        TV.fetch_video({"video": str(bad), "nframes": 2})


def test_a_zero_resize_dimension_is_refused_before_swscale(media):
    T = _native()
    for w, h in ((0, 10), (10, 0)):
        with pytest.raises(ValueError, match="invalid resize target"):
            T.decode_frames_scaled(media["raw.avi"], [0], w, h)


def test_available_names_what_is_missing(monkeypatch):
    found = {"g++": "/usr/bin/g++",
             "headers": {h: None if "swscale" in h else f"/inc/{h}" for h in TVD.LIBAV.values()},
             "libraries": {f"lib{n}.so": None if n == "avcodec" else f"/lib/lib{n}.so"
                           for n in TVD.LIBAV}}
    monkeypatch.setattr(TVD, "probe_libav", lambda: found)
    assert TVD.missing() == ["libswscale/swscale.h", "libavcodec.so"]
    assert TVD.available() is False


def test_a_failed_build_raises_with_the_compiler_error(tmp_path, monkeypatch):
    _native()
    src = tmp_path / "video_decoder.cc"
    src.write_text("int o3v_probe( {\n")
    monkeypatch.setattr(TVD, "SOURCE", src)
    monkeypatch.setattr(TVD, "BUILD_ROOT", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed .*\n.*error"):
        TVD.build()
    assert not (TVD.build_dir() / TVD.LIB_NAME).exists()


@pytest.mark.parametrize("name", ["png", "gray", "jpeg"])
def test_read_image_without_cv2_goes_through_the_decoder(media, name, tmp_path, monkeypatch):
    """PNG: the written pixels. JPEG (4:2:0, a smooth image with edges):
    PIL's pixels up to the chroma upsampling gap, under 100 levels at an edge
    and about 1 on average (scripts/measure_image_reader_gap.py: 88 and
    1.15 at 336x252)."""
    _native()
    if name == "jpeg":
        pytest.importorskip("cv2")
        from PIL import Image

        sys.path.insert(0, os.path.join(REPO_ROOT, "scripts"))
        from measure_image_reader_gap import smooth_image_with_edges

        import cv2

        path = str(tmp_path / "img.jpg")
        cv2.imwrite(path, smooth_image_with_edges(252, 336)[:, :, ::-1],
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        want = np.asarray(Image.open(path).convert("RGB"))
    else:
        path = media[f"{name}.png"]
        want = media[name] if name == "png" else np.repeat(media[name][:, :, None], 3, axis=2)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = TV.read_image(path)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    if name == "jpeg":
        assert diff.max() < 100 and diff.mean() < 2.0
    else:
        assert diff.max() == 0
