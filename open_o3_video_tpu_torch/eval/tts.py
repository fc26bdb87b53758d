"""Test-time scaling: crop the model's own claimed evidence and score it.

The model's reasoning trace claims evidence boxes at timestamps; this module
crops those regions from the sampled frames, and the scorer prompt asks the
*same* model to rate their relevance 0/1/2, which maps to a confidence weight
used for answer voting (reference: eval/tts.py).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from ..grounding.tags import parse_evidence_patterns  # noqa: F401  (re-export)

MAX_CROPS = 10

SCORER_SYSTEM = "You are a helpful assistant. Only reply with a single digit: 0, 1, or 2."
SCORER_USER_TMPL = (
    "You will be given a video question and a set of cropped images extracted from the video.\n"
    "Score how related these images are to answering the question.\n\n"
    "Scoring rules:\n"
    "2 = clearly relevant to answering the question\n"
    "1 = might be useful but uncertain\n"
    "0 = not relevant at all\n\n"
    "Only output one of: 0, 1, or 2. No other text.\n"
    "Question: {question}"
)


def relevance_mapping(score_0_1_2: int) -> float:
    """Judge rating -> confidence weight (reference: eval/tts.py:79-87)."""
    if score_0_1_2 == 2:
        return 1.0
    if score_0_1_2 == 1:
        return 0.6
    return 0.2


def read_frame_at_time(frames: Sequence[np.ndarray], fps: float, t_sec: float) -> Optional[np.ndarray]:
    """Frame at a claimed timestamp, or None when out of range
    (reference: eval/tts.py:47-52)."""
    idx = round(t_sec * fps)
    return frames[idx] if idx < len(frames) else None


def crop_box(frame: np.ndarray, box_xyxy: Sequence[float]) -> Optional[np.ndarray]:
    """Crop a CHW frame to the (clamped) box and resize back to full frame
    size with bilinear interpolation; None for empty crops
    (reference: eval/tts.py:54-75)."""
    import cv2

    frame_hwc = np.transpose(frame, (1, 2, 0))
    H, W, _ = frame_hwc.shape
    x1, y1, x2, y2 = map(int, box_xyxy)
    x1, y1 = max(0, x1), max(0, y1)
    x2, y2 = min(W, x2), min(H, y2)
    try:
        cropped = frame_hwc[y1:y2, x1:x2]
    except Exception:
        return None
    if cropped.size == 0:
        return None
    resized = cv2.resize(cropped.astype(np.float32), (W, H), interpolation=cv2.INTER_LINEAR)
    return np.transpose(resized.astype(np.uint8), (2, 0, 1))


def extract_and_crop(
    frames: Sequence[np.ndarray], fps: float, think_info: Sequence[dict[str, Any]]
) -> list[np.ndarray]:
    """All evidence crops for a trace; bail to [] when the model claimed more
    than MAX_CROPS pieces of evidence (reference: eval/tts.py:89-101)."""
    image_list = []
    for info in think_info:
        frame = read_frame_at_time(frames, fps, info["t_sec"])
        if frame is None:
            continue
        crop = crop_box(frame, info["box_xyxy"])
        if crop is None:
            continue
        image_list.append(crop)
    if len(image_list) > MAX_CROPS:
        return []
    return image_list


def build_image_scorer_msgs(images: Sequence[Any], question: str) -> list[dict[str, Any]]:
    """Chat messages asking the model to rate evidence relevance
    (reference: eval/tts.py:103-123)."""
    content: list[dict[str, Any]] = [
        {"type": "text", "text": SCORER_USER_TMPL.format(question=question)}
    ]
    for p in images:
        content.append({"type": "image", "image": p})
    return [
        {"role": "system", "content": SCORER_SYSTEM},
        {"role": "user", "content": content},
    ]
