"""Reasoning-trace visualization: an animated GIF of a grounded video answer
(counterpart of ``open_o3_video_tpu/eval/visualization.py``).

The trace is compiled into a step list (text, and evidence claims that seek
the video to their timestamp and overlay their box) by the shared tag
grammar; each step renders as typewriter frames: the video frame with a
progress bar beside a text panel of the question and the trace so far.

The JAX package draws with PIL and writes with imageio. The port imports
neither: the text goes through OpenCV (``cv2.putText``, its Hershey font,
so glyphs differ from PIL's), boxes and the progress bar are numpy writes
that equal PIL's pixels, and the GIF is written here (``write_gif``).
OpenCV also reads the video, so without it the visualizer raises
ImportError; it never renders without text.
"""

from __future__ import annotations

import struct
from typing import Any, Sequence

import numpy as np

from ..grounding.tags import EVIDENCE_RE, extract_answer, extract_think

PANEL_BG = (24, 24, 28)
TEXT_COLOR = (230, 230, 230)
BAR_BG = (60, 60, 60)
BAR_FILL = (80, 180, 255)
BOX_WIDTH = 3
MARGIN = 12


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the GIF visualizer needs OpenCV (cv2) to read the video and draw "
                          "its text") from e
    return cv2


def wrap_lines(text: str, panel_width: int, font_size: int, height: int) -> list[str]:
    """The lines a text panel of ``height`` shows: each paragraph cut every
    ``max_chars`` characters, then the last lines that fit (JAX's
    ``_text_panel``)."""
    line_height = font_size + 4
    max_chars = max(10, (panel_width - 2 * MARGIN) // (font_size // 2))
    lines: list[str] = []
    for paragraph in text.split("\n"):
        while len(paragraph) > max_chars:
            lines.append(paragraph[:max_chars])
            paragraph = paragraph[max_chars:]
        lines.append(paragraph)
    return lines[-((height - 2 * MARGIN) // line_height):]


def draw_rectangle(img: np.ndarray, box: Sequence[int], color, width: int) -> None:
    """PIL's ``ImageDraw.rectangle(outline=color, width=width)`` in place:
    bands of ``width`` pixels inside the inclusive box, clipped to the
    image."""
    x1, y1, x2, y2 = box
    h, w = img.shape[:2]

    def band(ya, yb, xa, xb):
        ya, yb, xa, xb = max(ya, 0), min(yb, h - 1), max(xa, 0), min(xb, w - 1)
        if ya <= yb and xa <= xb:
            img[ya:yb + 1, xa:xb + 1] = color

    for i in range(width):
        band(y1 + i, y1 + i, x1, x2)
        band(y2 - i, y2 - i, x1, x2)
        band(y1 + width, y2 - width, x1 + i, x1 + i)
        band(y1 + width, y2 - width, x2 - i, x2 - i)


def _gif_frame_bytes(frame: np.ndarray) -> tuple[bytes, bytes]:
    """A frame's local color table (256 entries) and its image data. The
    palette holds the frame's colors where there are at most 256, else a
    6 x 7 x 6 uniform grid. The data is LZW with 8-bit literals only and a
    clear code every 254 of them, so every code is 9 bits wide."""
    flat = frame.reshape(-1, 3)
    colors, index = np.unique(flat, axis=0, return_inverse=True)
    if len(colors) > 256:
        levels = np.array([6, 7, 6])
        q = (flat.astype(np.int32) * (levels - 1) + 127) // 255  # 0..levels-1
        index = (q[:, 0] * 7 + q[:, 1]) * 6 + q[:, 2]
        grid = np.stack(np.meshgrid(*(np.arange(n) for n in levels), indexing="ij"), -1)
        colors = (grid.reshape(-1, 3) * 255 // (levels - 1)).astype(np.uint8)
    palette = np.zeros((256, 3), np.uint8)
    palette[:len(colors)] = colors
    index = index.reshape(-1).astype(np.int64)
    clear, eoi = 256, 257
    n = len(index)
    n_clears = -(-n // 254)
    codes = np.empty(n + n_clears + 1, np.int64)
    pos = np.arange(n) + np.arange(n) // 254 + 1
    codes[pos] = index
    codes[np.arange(n_clears) * 255] = clear
    codes[-1] = eoi
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8).reshape(-1)
    data = np.packbits(bits, bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return palette.tobytes(), bytes([8]) + blocks + b"\0"


def write_gif(path: str, frames: Sequence[np.ndarray], fps: int, loop: int = 0) -> int:
    """(H, W, 3) uint8 RGB frames -> a GIF89a at ``fps``, looping ``loop``
    times (0: forever). As imageio's Pillow writer does, equal consecutive
    frames become one frame shown for their summed duration, in whole
    centiseconds rounded down. Returns the frames written."""
    frames = [np.ascontiguousarray(f, dtype=np.uint8) for f in frames]
    h, w = frames[0].shape[:2]
    runs: list[list] = []
    for f in frames:
        if f.shape != (h, w, 3):
            raise ValueError(f"frame of shape {f.shape}, expected {(h, w, 3)}")
        if runs and np.array_equal(runs[-1][0], f):
            runs[-1][1] += 1
        else:
            runs.append([f, 1])
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\0"]
    for f, count in runs:
        delay = int(count * 1000 / fps / 10)
        out.append(b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\0\0")
        palette, data = _gif_frame_bytes(f)
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87) + palette + data)
    out.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
    return len(runs)


class VideoQAGIFGenerator:
    def __init__(
        self,
        panel_width: int = 480,
        font_size: int = 16,
        chars_per_frame: int = 6,
        fps: int = 8,
        box_color: tuple[int, int, int] = (255, 64, 64),
    ):
        self.panel_width = panel_width
        self.font_size = font_size
        self.chars_per_frame = chars_per_frame
        self.fps = fps
        self.box_color = box_color

    # ------------------------------------------------------------ step list

    def build_step_list(self, reasoning: str) -> list[dict[str, Any]]:
        """Compile the trace into interleaved text/action steps: plain text
        renders with a typewriter effect; each evidence claim seeks the video
        to its timestamp and overlays its box."""
        steps: list[dict[str, Any]] = []
        cursor = 0
        for m in EVIDENCE_RE.finditer(reasoning):
            if m.start() > cursor:
                steps.append({"kind": "text", "text": reasoning[cursor : m.start()]})
            obj = m.group(1).strip()
            try:
                box = [float(v) for v in m.group(2).strip("[] ").split(",")]
                t_sec = float(m.group(3))
                steps.append({"kind": "evidence", "obj": obj, "box": box, "t": t_sec,
                              "text": f"[{obj} @ {t_sec:.1f}s]"})
            except ValueError:
                steps.append({"kind": "text", "text": m.group(0)})
            cursor = m.end()
        if cursor < len(reasoning):
            steps.append({"kind": "text", "text": reasoning[cursor:]})
        return steps

    # ------------------------------------------------------------ rendering

    def _put_text(self, img: np.ndarray, xy: tuple[int, int], text: str, color) -> None:
        """``text`` with its top left at ``xy``, in OpenCV's Hershey simplex
        font about ``font_size`` pixels high."""
        cv2 = _cv2()
        x, y = xy
        scale = self.font_size / 30.0
        cv2.putText(img, text, (x, y + int(self.font_size * 0.8)), cv2.FONT_HERSHEY_SIMPLEX,
                    scale, color, 1, cv2.LINE_AA)

    def _text_panel(self, text: str, height: int) -> np.ndarray:
        panel = np.empty((height, self.panel_width, 3), np.uint8)
        panel[:] = PANEL_BG
        y = MARGIN
        for line in wrap_lines(text, self.panel_width, self.font_size, height):
            self._put_text(panel, (MARGIN, y), line, TEXT_COLOR)
            y += self.font_size + 4
        return panel

    def _draw_box(self, frame: np.ndarray, box: Sequence[float], label: str) -> np.ndarray:
        img = np.array(frame, dtype=np.uint8)
        x1, y1, x2, y2 = [int(v) for v in box]
        draw_rectangle(img, (x1, y1, x2, y2), self.box_color, BOX_WIDTH)
        if label:
            self._put_text(img, (x1 + 2, max(0, y1 - self.font_size - 2)), label,
                           self.box_color)
        return img

    def _progress_bar(self, frame: np.ndarray, t: float, duration: float) -> np.ndarray:
        out = frame.copy()
        h, w = out.shape[:2]
        bar_y = h - 8
        out[bar_y : bar_y + 5, :, :] = BAR_BG
        fill = int(w * min(1.0, t / max(duration, 1e-6)))
        out[bar_y : bar_y + 5, :fill, :] = BAR_FILL
        return out

    # ------------------------------------------------------------------ API

    def create_demo_gif(
        self,
        video_path: str,
        question: str,
        response: str,
        output_path: str,
        *,
        max_frames_per_step: int = 10,
    ) -> str:
        """Render question + <think> trace + <answer> into an animated GIF."""
        cv2 = _cv2()
        cap = cv2.VideoCapture(video_path)
        if not cap.isOpened():
            raise ValueError(f"Could not open video: {video_path}")
        try:
            video_fps = cap.get(cv2.CAP_PROP_FPS) or 1.0
            total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            duration = total / video_fps

            def frame_at(t_sec: float) -> np.ndarray:
                idx = min(total - 1, max(0, int(round(t_sec * video_fps))))
                cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
                ok, frame = cap.read()
                if not ok:
                    frame = np.zeros((240, 320, 3), np.uint8)
                return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

            frames_out = self.render_frames(frame_at, duration, question, response,
                                            max_frames_per_step=max_frames_per_step)
        finally:
            cap.release()
        write_gif(output_path, frames_out, self.fps, loop=0)
        return output_path

    def render_frames(self, frame_at, duration: float, question: str, response: str, *,
                      max_frames_per_step: int = 10) -> list[np.ndarray]:
        """The GIF's frames: ``frame_at(t)`` gives the video's RGB frame at
        ``t`` seconds, ``duration`` its length."""
        think = extract_think(response) or response
        answer = extract_answer(response)
        steps = self.build_step_list(think)
        if answer:
            steps.append({"kind": "text", "text": f"\n\nAnswer: {answer}"})

        frames_out = []
        current_frame = frame_at(0.0)
        current_t = 0.0
        accumulated = f"Q: {question}\n\n"
        for step in steps:
            if step["kind"] == "evidence":
                current_t = step["t"]
                current_frame = self._draw_box(frame_at(current_t), step["box"], step["obj"])
            text_to_add = step["text"]
            for i in range(0, max(1, len(text_to_add)), self.chars_per_frame):
                accumulated_now = accumulated + text_to_add[: i + self.chars_per_frame]
                composite = self._compose(current_frame, accumulated_now, current_t, duration)
                frames_out.append(composite)
                if len(frames_out) % max_frames_per_step == 0 and step["kind"] == "text":
                    break
            accumulated += text_to_add

        # Hold the final frame.
        final = self._compose(current_frame, accumulated, current_t, duration)
        frames_out.extend([final] * self.fps)
        return frames_out

    def _compose(self, frame: np.ndarray, text: str, t: float, duration: float) -> np.ndarray:
        frame = self._progress_bar(frame, t, duration)
        h = frame.shape[0]
        panel = self._text_panel(text, h)
        return np.concatenate([frame, panel], axis=1)
