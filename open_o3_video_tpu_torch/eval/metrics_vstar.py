"""V-STAR benchmark metrics: temporal IoU, spatial AP/mIoU, AM / LGM.

Reproduces the scorer semantics of the reference judge pipeline
(reference: eval/test/eval_vstar.py:75-198, 362-413):

- accuracy = fraction of items whose LLM-judge rating >= 2
- AM  = (acc + mean temporal IoU + mean spatial mIoU) / 3, per chain
- LGM = -(log(1-acc) + log(1-mtIoU) + log(1-mvIoU)) / 3, per chain
- mAM / mLGM = average of the two chains
- duration buckets: Short < 60s, Medium 60-180s, Long >= 180s
"""

from __future__ import annotations

import ast
import math
from typing import Any, Mapping, Sequence

import numpy as np

IOU_THRESHOLDS = (0.1, 0.3, 0.5, 0.7, 0.9)


def temporal_iou(gt_range: Sequence[float], pred_range) -> float:
    """Temporal IoU with defensive parsing: accepts a stringified list, rejects
    anything that is not a 2-list of numbers (reference: eval_vstar.py:90-109)."""
    if not pred_range:
        return 0.0
    if isinstance(pred_range, str):
        try:
            pred_range = ast.literal_eval(pred_range)
        except (ValueError, SyntaxError):
            return 0.0
    if (
        not isinstance(pred_range, (list, tuple))
        or len(pred_range) != 2
        or not all(isinstance(x, (int, float)) for x in pred_range)
    ):
        return 0.0
    gt_start, gt_end = gt_range
    pred_start, pred_end = pred_range
    intersection = max(0, min(gt_end, pred_end) - max(gt_start, pred_start))
    union = max(gt_end, pred_end) - min(gt_start, pred_start)
    return intersection / union if union > 0 else 0.0


def _iou_dict_gt(gt_bbox: Mapping[str, float], pred_bbox) -> float:
    """IoU against a dict-form GT box {xmin,ymin,xmax,ymax}
    (reference: eval_vstar.py:112-133)."""
    if not isinstance(pred_bbox, (list, tuple)) or len(pred_bbox) != 4:
        return 0.0
    gx1, gy1, gx2, gy2 = gt_bbox["xmin"], gt_bbox["ymin"], gt_bbox["xmax"], gt_bbox["ymax"]
    px1, py1, px2, py2 = pred_bbox
    x1, y1 = max(gx1, px1), max(gy1, py1)
    x2, y2 = min(gx2, px2), min(gy2, py2)
    intersection = max(0, x2 - x1) * max(0, y2 - y1)
    gt_area = (gx2 - gx1) * (gy2 - gy1)
    pred_area = (px2 - px1) * (py2 - py1)
    union = gt_area + pred_area - intersection
    return intersection / union if union > 0 else 0.0


def bbox_iou_max(gt_bbox: Mapping[str, float], pred_bboxes) -> float:
    """Max IoU over candidate prediction boxes; a flat 4-list is promoted to a
    singleton list (reference: eval_vstar.py:135-146)."""
    try:
        if not pred_bboxes:
            return 0.0
        if isinstance(pred_bboxes[0], (int, float)) and len(pred_bboxes) == 4:
            pred_bboxes = [pred_bboxes]
        return max(_iou_dict_gt(gt_bbox, p) for p in pred_bboxes)
    except Exception:
        return 0.0


def spatial_metrics(
    gt_bboxes: Sequence[Mapping[str, Any]], pred_bboxes
) -> tuple[list[float], float]:
    """Per-item AP@{0.1..0.9} and mIoU over GT keyframe boxes, matching
    predictions by stringified timestamp (reference: eval_vstar.py:148-178)."""
    if not pred_bboxes:
        return [0.0] * 5, 0.0
    ious = []
    for box in gt_bboxes:
        frame_id = str(box["timestamp"])
        if isinstance(pred_bboxes, dict) and frame_id in pred_bboxes:
            gt = {k: box[k] for k in ("xmin", "ymin", "xmax", "ymax")}
            ious.append(bbox_iou_max(gt, pred_bboxes[frame_id]))
        else:
            ious.append(0.0)
    miou = float(np.mean(ious)) if ious else 0.0
    aps = [float(np.mean([1 if iou >= t else 0 for iou in ious])) if ious else 0.0 for t in IOU_THRESHOLDS]
    return aps, miou


def spatial_random_baseline(
    gt_bboxes: Sequence[Mapping[str, Any]], width: float, height: float
) -> tuple[list[float], float]:
    """Full-frame prediction baseline (reference: eval_vstar.py:180-198)."""
    pred = [0, 0, width, height]
    ious = []
    for entry in gt_bboxes:
        for _frame_id, gt in entry.items():
            ious.append(bbox_iou_max(gt, pred))
    miou = float(np.mean(ious)) if ious else 0.0
    aps = [float(np.mean([1 if iou >= t else 0 for iou in ious])) if ious else 0.0 for t in IOU_THRESHOLDS]
    return aps, miou


def duration_bucket(video_length_sec: float) -> str:
    """Short/Medium/Long breakdown (reference: eval_vstar.py:224-229)."""
    if video_length_sec < 60:
        return "Short"
    if video_length_sec < 180:
        return "Medium"
    return "Long"


def am_lgm(acc: float, mt_iou: float, mv_iou: float) -> tuple[float, float]:
    """Arithmetic-mean and log-geometric-mean composites for one chain
    (reference: eval_vstar.py:404-409)."""
    am = (acc + mt_iou + mv_iou) / 3
    lgm = -(math.log(1 - acc) + math.log(1 - mt_iou) + math.log(1 - mv_iou)) / 3
    return am, lgm


def aggregate_chains(
    acc: float, mt_iou_1: float, mv_iou_1: float, mt_iou_2: float, mv_iou_2: float
) -> dict[str, float]:
    """mAM / mLGM across both chains (reference: eval_vstar.py:404-413)."""
    am1, lgm1 = am_lgm(acc, mt_iou_1, mv_iou_1)
    am2, lgm2 = am_lgm(acc, mt_iou_2, mv_iou_2)
    return {
        "AM1": am1,
        "AM2": am2,
        "mAM": (am1 + am2) / 2,
        "LGM1": lgm1,
        "LGM2": lgm2,
        "mLGM": (lgm1 + lgm2) / 2,
    }


def recall_at(ious: Sequence[float], threshold: float) -> float:
    """R1@IoU=threshold (reference: eval_vstar.py:367-375)."""
    return float(np.mean([1 if iou >= threshold else 0 for iou in ious])) if len(ious) else 0.0
