"""IoU primitives shared by rewards and benchmark metrics (a copy of
``open_o3_video_tpu/grounding/iou.py``, held equal to it by
``tests/test_torch_rewards.py``)."""

from __future__ import annotations

from typing import Sequence


def box_iou(box_a: Sequence[float], box_b) -> float:
    """IoU of two pixel xyxy boxes. ``box_a`` is GT, ``box_b`` the prediction;
    returns 0.0 unless box_b is a 4-list. Degenerate unions yield 0.0.

    (reference: reward_func.py:356-386, ``calculate_iou``)
    """
    try:
        if not (isinstance(box_b, list) and len(box_b) == 4):
            return 0.0
        ax1, ay1, ax2, ay2 = (float(v) for v in box_a)
        bx1, by1, bx2, by2 = (float(v) for v in box_b)
    except (ValueError, TypeError, IndexError):
        return 0.0

    ix1, iy1 = max(ax1, bx1), max(ay1, by1)
    ix2, iy2 = min(ax2, bx2), min(ay2, by2)
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    area_a = (ax2 - ax1) * (ay2 - ay1)
    area_b = (bx2 - bx1) * (by2 - by1)
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def segment_iou(seg_a: Sequence[float], seg_b: Sequence[float]) -> float:
    """Temporal IoU of [start, end] segments; union is span min(start)..max(end).
    Zero-length unions yield 0. (reference: reward_func.py:136-143)
    """
    start1, end1 = seg_a
    start2, end2 = seg_b
    inter = max(0.0, min(end1, end2) - max(start1, start2))
    union = max(end1, end2) - min(start1, start2)
    return inter / union if union != 0 else 0.0
