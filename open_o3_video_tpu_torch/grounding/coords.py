"""Bounding-box coordinate conventions.

Four conventions appear in the reference data mix; all converters mirror
the reference formulas (reference: src/r1-v/src/open_r1/reward_func.py:337-354,
src/r1-v/src/open_r1/sft_multi_task.py:207-279):

1. normalized xyxy in [0,1]  -> pixel xyxy           (``denormalize_box``)
2. GQA pixel xyxy at original size -> resized size   (``rescale_box_gqa``)
3. VideoEspresso cx,cy,w,h in 0..1000 -> pixel xyxy  (``espresso_center_to_xyxy``)
4. Gemini normalized xyxy -> pixel xyxy              (``gemini_normalized_to_xyxy``)

plus text-level rewriters that rescale every ``<box>[...]</box>`` span inside a
prompt/target string.

A copy of ``open_o3_video_tpu/grounding/coords.py`` (the port imports
nothing of the JAX package), held equal to it by
``tests/test_torch_rewards.py``.
"""

from __future__ import annotations

import re
from typing import Sequence

_BOX_TEXT_RE = re.compile(r"<box>(\[.*?\])</box>")
_BOX_INNER_RE = re.compile(r"<box>\[([^]]+)\]</box>")


def denormalize_box(bbox: Sequence[float], image_size: Sequence[float]) -> list[float]:
    """Normalized [0,1] xyxy -> pixel xyxy. image_size is (W, H).

    (reference: reward_func.py:337-346, ``convert_coord_format``)
    """
    nx_min, ny_min, nx_max, ny_max = bbox
    width, height = image_size
    return [nx_min * width, ny_min * height, nx_max * width, ny_max * height]


def rescale_box_gqa(
    bbox: list[float], image_size: Sequence[float], image_size_refine: Sequence[float]
) -> list[float]:
    """Rescale a pixel xyxy box from the original image size to the resized
    size. Mutates and returns ``bbox`` — callers in the reward path rely on
    single application per box. (reference: reward_func.py:349-354)
    """
    bbox[0] = bbox[0] * image_size_refine[0] / image_size[0]
    bbox[1] = bbox[1] * image_size_refine[1] / image_size[1]
    bbox[2] = bbox[2] * image_size_refine[0] / image_size[0]
    bbox[3] = bbox[3] * image_size_refine[1] / image_size[1]
    return bbox


def espresso_center_to_xyxy(bbox: Sequence[float], image_size: Sequence[float]) -> list[float]:
    """VideoEspresso (cx, cy, w, h) in 0..1000 -> clamped pixel xyxy.

    (reference: sft_multi_task.py:207-226)
    """
    nx, ny, nw, nh = [c / 1000.0 for c in bbox]
    x_center, y_center = nx * image_size[0], ny * image_size[1]
    width, height = nw * image_size[0], nh * image_size[1]
    x_min = max(0, x_center - width / 2)
    y_min = max(0, y_center - height / 2)
    x_max = min(image_size[0], x_center + width / 2)
    y_max = min(image_size[1], y_center + height / 2)
    return [x_min, y_min, x_max, y_max]


def gemini_normalized_to_xyxy(coords: Sequence[float], image_size: Sequence[float]) -> list[float]:
    """Gemini-annotated normalized xyxy -> pixel xyxy. (reference:
    sft_multi_task.py:228-236)"""
    nx_min, ny_min, nx_max, ny_max = coords
    width, height = image_size
    return [nx_min * width, ny_min * height, nx_max * width, ny_max * height]


def resize_boxes_in_text(text: str, old_image_size: Sequence[float], new_image_size: Sequence[float]) -> str:
    """Rescale every integer ``<box>[x1,y1,x2,y2]</box>`` in ``text`` from
    old to new image size (visual-QA SFT path).

    (reference: sft_multi_task.py:239-250)
    """
    old_w, old_h = old_image_size
    new_w, new_h = new_image_size
    ratios = (new_w / old_w, new_h / old_h, new_w / old_w, new_h / old_h)

    def resizer(m: re.Match) -> str:
        coords = [int(c) for c in m.group(1).strip("[]").split(",")]
        new_coords = [int(round(c * r)) for c, r in zip(coords, ratios)]
        return f"<box>[{','.join(map(str, new_coords))}]</box>"

    return _BOX_TEXT_RE.sub(resizer, text)


def _rewrite_boxes(text: str, convert) -> str:
    def replacer(m: re.Match) -> str:
        coords = list(map(float, m.group(1).split(",")))
        new_coords = str([round(c) for c in convert(coords)]).replace(" ", "")
        return "<box>" + new_coords + "</box>"

    return _BOX_INNER_RE.sub(replacer, text)


def rewrite_espresso_boxes_in_text(text: str, image_size: Sequence[float]) -> str:
    """Rewrite Espresso-convention boxes in a target string to pixel xyxy.
    (reference: sft_multi_task.py:252-264)"""
    return _rewrite_boxes(text, lambda c: espresso_center_to_xyxy(c, image_size))


def rewrite_gemini_boxes_in_text(text: str, image_size: Sequence[float]) -> str:
    """Rewrite Gemini-convention boxes in a target string to pixel xyxy.
    (reference: sft_multi_task.py:267-279)"""
    return _rewrite_boxes(text, lambda c: gemini_normalized_to_xyxy(c, image_size))
