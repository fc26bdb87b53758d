"""The GIF visualizer (``eval/visualization.py``) against the JAX
package's.

- ``build_step_list`` equals JAX's over a corpus of traces, bad box and
  time values among them;
- the text panel's wrapped, windowed lines equal the lines JAX's
  ``_text_panel`` draws (read from PIL's ``ImageDraw.text`` calls);
- box outlines (PIL's ``rectangle(width=3)``, clipped at the frame's edges)
  and the progress bar equal JAX's pixels, the label glyphs left out (an
  empty label draws none in either package);
- the GIF of one trace over a tiny video, decoded with PIL, has JAX's
  frame count, per-frame delays and loop count; frames of at most 256
  colours decode exactly.
"""

import numpy as np
import pytest

from open_o3_video_tpu_torch.data.raw_media import write_raw_avi
from open_o3_video_tpu_torch.eval import visualization as TV

CORPUS = [
    "",
    "plain text only",
    "<obj>cat</obj><box>[10, 20, 30, 40]</box>at<t>1.5</t>s then more",
    "a<obj> dog </obj><box>[1,2,3,4]</box>at<t>0</t>sb<obj>x</obj><box>[5, 6, 7, 8]</box>at<t>2.25</t>s",
    "<obj>bad</obj><box>[1, two, 3, 4]</box>at<t>1</t>s",
    "<obj>bad t</obj><box>[1, 2, 3, 4]</box>at<t>soon</t>s tail",
    "<obj>empty</obj><box>[]</box>at<t>1</t>s",
    "multi\nline <obj>o</obj><box>[0.5, 1.5, 2.5, 3.5]</box>at<t>3.0</t>s\n\nend",
]


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_step_list_equals_jaxs(i):
    from open_o3_video_tpu.eval.visualization import VideoQAGIFGenerator as Jax

    assert TV.VideoQAGIFGenerator().build_step_list(CORPUS[i]) == Jax().build_step_list(CORPUS[i])


@pytest.mark.parametrize("text,height", [
    ("short", 240), ("x" * 200 + "\n" + "y" * 7, 240), ("\n".join(f"line {i}" for i in range(40)), 120),
    ("Q: what?\n\n" + "word " * 120, 300)])
def test_wrapped_lines_equal_the_lines_jax_draws(monkeypatch, text, height):
    from PIL import ImageDraw

    from open_o3_video_tpu.eval.visualization import VideoQAGIFGenerator as Jax

    drawn = []
    monkeypatch.setattr(ImageDraw.ImageDraw, "text", lambda self, xy, t, **kw: drawn.append(t))
    Jax()._text_panel(text, height)
    assert TV.wrap_lines(text, 480, 16, height) == drawn


@pytest.mark.parametrize("box", [[10, 12, 50, 40], [-5, -3, 30, 20], [60, 40, 120, 90],
                                 [3.7, 4.2, 20.9, 30.1], [10, 10, 13, 13], [0, 0, 79, 59]])
def test_box_and_progress_bar_pixels_equal_jaxs(box):
    from open_o3_video_tpu.eval.visualization import VideoQAGIFGenerator as Jax

    frame = np.random.default_rng(0).integers(0, 255, (60, 80, 3), dtype=np.uint8)
    ours, theirs = TV.VideoQAGIFGenerator(), Jax()
    np.testing.assert_array_equal(ours._draw_box(frame, box, ""), theirs._draw_box(frame, box, ""))
    labelled = ours._draw_box(frame, box, "cat")
    outline = theirs._draw_box(frame, box, "")
    glyphs = np.zeros(frame.shape[:2], bool)  # the label's band above the box
    y0 = max(0, int(box[1]) - 16 - 2)
    glyphs[y0:y0 + 16 + 4, max(0, int(box[0])):] = True
    np.testing.assert_array_equal(labelled[~glyphs], outline[~glyphs])
    for t, duration in ((0.0, 10.0), (3.0, 10.0), (12.0, 10.0), (1.0, 0.0)):
        np.testing.assert_array_equal(ours._progress_bar(frame, t, duration),
                                      theirs._progress_bar(frame, t, duration))


def _gif_info(path):
    from PIL import Image

    im = Image.open(path)
    delays = []
    for i in range(im.n_frames):
        im.seek(i)
        delays.append(im.info.get("duration"))
    return im.n_frames, delays, im.info.get("loop")


def test_gif_has_jaxs_frames_delays_and_loop(tmp_path):
    from PIL import Image

    from open_o3_video_tpu.eval.visualization import VideoQAGIFGenerator as Jax

    r = np.random.default_rng(1)
    video = tmp_path / "v.avi"
    write_raw_avi(str(video), r.integers(0, 255, (6, 48, 64, 3), dtype=np.uint8), fps=2.0)
    response = ("<think>The ball <obj>ball</obj><box>[4, 6, 30, 40]</box>at<t>1.0</t>s rolls "
                "right and stops.</think><answer>B</answer>")
    args = (str(video), "Where is the ball?", response)
    ours = TV.VideoQAGIFGenerator(panel_width=160).create_demo_gif(*args, str(tmp_path / "a.gif"))
    theirs = Jax(panel_width=160).create_demo_gif(*args, str(tmp_path / "b.gif"))
    n, delays, loop = _gif_info(ours)
    assert (n, delays, loop) == _gif_info(theirs)
    assert n > 5 and loop == 0 and delays[-1] > delays[0]  # the held final frame
    im = Image.open(ours)
    im.seek(1)
    rgb = np.asarray(im.convert("RGB")).astype(int)
    assert rgb.shape == (48, 64 + 160, 3)


def test_gif_writer_round_trips_few_colours(tmp_path):
    """Frames of at most 256 colours decode exactly; equal neighbours merge
    into one frame of their summed delay (whole centiseconds)."""
    from PIL import Image

    a = np.zeros((20, 30, 3), np.uint8)
    a[:, :10] = (1, 2, 3)
    a[5:, 10:] = (200, 100, 50)
    b = a.copy()
    b[0, 0] = (9, 9, 9)
    assert TV.write_gif(str(tmp_path / "c.gif"), [a, b, b, b], fps=8) == 2
    assert _gif_info(tmp_path / "c.gif") == (2, [120, 370], 0)
    im = Image.open(tmp_path / "c.gif")
    for i, want in enumerate((a, b)):
        im.seek(i)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), want)


def test_without_cv2_it_raises(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="OpenCV"):
        TV.VideoQAGIFGenerator()._text_panel("text", 100)
