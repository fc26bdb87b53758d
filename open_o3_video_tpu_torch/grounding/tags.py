"""Tag grammar for grounded reasoning traces.

The model emits reasoning of the form::

    <think> ... <obj>name</obj><box>[x1,y1,x2,y2]</box>at<t>12.5</t>s ... </think>
    <answer> ... </answer>

This module owns every parser for that grammar. Semantics mirror the
reference exactly (reference: src/r1-v/src/open_r1/reward_func.py:17-335,
eval/tts.py:12-45, eval/test/eval_vstar.py:75-88).

A copy of ``open_o3_video_tpu/grounding/tags.py``, held equal to it by
``tests/test_torch_rewards.py``.
"""

from __future__ import annotations

import json
import re
from typing import Any, Optional

# --- Core tag regexes -------------------------------------------------------

ANSWER_RE = re.compile(r"<answer>\s*(.*?)\s*</answer>", re.DOTALL)
ANSWER_RAW_RE = re.compile(r"<answer>.*?</answer>", re.DOTALL)
THINK_RE = re.compile(r"<think>(.*?)</think>", re.DOTALL)
BOX_RE = re.compile(r"<box>(\[.*?\])</box>")
TIME_POINT_RE = re.compile(r"<t>([\d.]+)</t>s")
TIME_SEGMENT_RE = re.compile(r"<t>(\d+\.?\d*)</t>s to <t>(\d+\.?\d*)</t>s")
OBJ_BOX_PAIR_RE = re.compile(r"<obj>(\w+)</obj><box>(\[.*?\])</box>")

# A grounded-evidence claim: one object, one-or-more boxes, one timestamp.
# (reference: reward_func.py:310)
CLAIM_RE = re.compile(
    r"<obj>(.*?)</obj>((?:<box>\[.*?\]</box>)+)at<t>(.*?)</t>s", re.DOTALL
)
# The single-box evidence pattern used by test-time scaling (reference: eval/tts.py:12)
EVIDENCE_RE = re.compile(r"<obj>(.*?)</obj><box>(\[.*?\])</box>at<t>(.*?)</t>s", re.DOTALL)


def extract_answer(text: str) -> str:
    """Contents of the first <answer> block, stripped; '' when absent."""
    m = ANSWER_RE.search(text)
    return m.group(1).strip() if m else ""


def extract_think(text: str) -> Optional[str]:
    """Contents of the first <think> block (unstripped); None when absent."""
    m = THINK_RE.search(text)
    return m.group(1) if m else None


def parse_time_segment(text: str) -> list[float]:
    """Parse '<t>a</t>s to <t>b</t>s' -> [a, b]; [] if absent or b < a.

    (reference: reward_func.py:119-133)
    """
    m = TIME_SEGMENT_RE.search(text)
    if not m:
        return []
    start, end = float(m.group(1)), float(m.group(2))
    if end < start:
        return []
    return [start, end]


def parse_time_points(text: str) -> list[float]:
    """All '<t>X</t>s' timestamps in order; [] on any float parse failure.

    (reference: reward_func.py:411-415 — a single bad match voids the list)
    """
    try:
        return [float(m) for m in TIME_POINT_RE.findall(text)]
    except (ValueError, TypeError):
        return []


def parse_claims(think_content: str) -> list[dict[str, Any]]:
    """Parse grounded claims '<obj>X</obj><box>..</box>+at<t>T</t>s' from a
    reasoning trace. Malformed claims (bad JSON box, bad float) are skipped.

    Returns dicts with keys id/object_name/timestamp/bboxes.
    (reference: reward_func.py:308-335)
    """
    claims: list[dict[str, Any]] = []
    count = 0
    for m in CLAIM_RE.finditer(think_content):
        try:
            name = m.group(1).strip()
            boxes_blob = m.group(2)
            timestamp = float(m.group(3).strip())
            box_strs = re.findall(r"\[.*?\]", boxes_blob)
            bboxes = [json.loads(b) for b in box_strs]
            claims.append(
                {"id": count, "object_name": name, "timestamp": timestamp, "bboxes": bboxes}
            )
            count += 1
        except (json.JSONDecodeError, ValueError, IndexError):
            continue
    return claims


def parse_box_str(box_str: str) -> Optional[list[float]]:
    """Parse '[x1, y1, x2, y2]' into floats; None unless exactly 4 values with
    x2>=x1 and y2>=y1. (reference: eval/tts.py:14-29)
    """
    clean = box_str.strip().replace(" ", "").replace("[", "").replace("]", "")
    try:
        vals = [float(p) for p in clean.split(",")]
    except Exception:
        return None
    if len(vals) != 4:
        return None
    x1, y1, x2, y2 = vals
    if x2 >= x1 and y2 >= y1:
        return vals
    return None


def parse_evidence_patterns(text: str) -> list[dict[str, Any]]:
    """Single-box evidence claims for test-time scaling.

    Returns dicts with keys obj/box_xyxy/t_sec (t rounded to 2 decimals);
    entries with malformed box or time are dropped. (reference: eval/tts.py:32-45)
    """
    out = []
    for m in EVIDENCE_RE.finditer(text):
        obj = m.group(1).strip()
        box = parse_box_str(m.group(2))
        try:
            t_sec = round(float(m.group(3).strip()), 2)
        except Exception:
            t_sec = None
        if t_sec is not None and box is not None:
            out.append({"obj": obj, "box_xyxy": box, "t_sec": t_sec})
    return out


def refined_timestamps(result: str) -> list[float]:
    """Salvage a [start, end] pair from free-form text: prefer the <answer>
    block, convert 'm:ss' clock stamps to seconds, then take the first two
    bare numbers. (reference: eval/test/eval_vstar.py:75-88)
    """
    m = ANSWER_RE.search(result)
    if m:
        result = m.group(1).strip()
    for ts in re.findall(r"(\d+:\d+)", result):
        minutes, seconds = map(int, ts.split(":"))
        result = result.replace(ts, f"<t>{minutes * 60 + seconds}</t>s")
    nums = re.findall(r"\b\d+(?:\.\d+)?\b", result)
    return [float(nums[0]), float(nums[1])] if len(nums) == 2 else []
