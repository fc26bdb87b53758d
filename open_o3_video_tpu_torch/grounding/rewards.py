"""The seven GSPO reward functions.

Signature contract (consumed by the RL trainer): each reward takes
``completions`` — a list of single-turn chats ``[{"role": "assistant",
"content": str}]`` — plus every dataset column repeated per generation in
``kwargs`` (``task``, ``answer``, ``key_frames``, ``key_items``,
``image_size``, ``image_size_refine``, ``step_percent``, ...), and returns
``list[float]`` of the same length as ``completions``.

Semantics are reproduced bit-for-bit from the reference
(src/r1-v/src/open_r1/reward_func.py), **including known quirks**:

- Task routing always reads ``kwargs['task'][0]`` (first generation's task),
  never per-completion (reference lines 37-44 etc.).
- In ``ans_acc`` / ``ans_tiou`` / ``ans_viou`` the ground-truth index ``idx``
  is only advanced inside the per-completion ``try`` block, so an exception
  desynchronizes subsequent completions from their answers (reference: 49-83).
- ``thk_spatial``'s temporal gate pre-check is the *signed* difference
  ``gt_time - pred_time < 1.0`` (not abs), so predictions arbitrarily later
  than a GT keyframe pass the gate (reference: 556).
- Total reward is the plain sum of all seven; group advantage normalization
  happens in the trainer.

A copy of ``open_o3_video_tpu/grounding/rewards.py`` (held equal to it,
float for float, by ``tests/test_torch_rewards.py``), except that ROUGE
comes from ``rouge.py`` instead of the ``rouge_score`` package, which the
card's machine does not have.
"""

from __future__ import annotations

import ast
import json
import re
from typing import Callable

import numpy as np

from .coords import denormalize_box, rescale_box_gqa
from .iou import box_iou, segment_iou
from .rouge import rouge_avg_f
from .tags import (
    ANSWER_RAW_RE,
    ANSWER_RE,
    BOX_RE,
    OBJ_BOX_PAIR_RE,
    THINK_RE,
    TIME_POINT_RE,
    TIME_SEGMENT_RE,
    extract_answer,
    parse_claims,
)


def _rouge_avg_f(reference: str, hypothesis: str) -> float:
    """Mean of ROUGE-1/2/L F-measures with stemming (reference: 28-32),
    from the port's own scorer (``rouge.py``), equal to rouge_score's
    ``RougeScorer(["rouge1", "rouge2", "rougeL"], use_stemmer=True)``."""
    return rouge_avg_f(reference, hypothesis)


def _contents(completions) -> list[str]:
    return [completion[0]["content"] for completion in completions]


def _mcq_letter_match(choice: str, gt: str) -> float:
    """Exact option-letter match against {X, X., (X), [X]} (reference: 59-60)."""
    gt = gt.strip()
    gt_list = [gt, gt + ".", "(" + gt + ")", "[" + gt + "]"]
    return 1.0 if choice.strip() in gt_list else 0.0


def ans_acc_reward(completions, answer, **kwargs) -> list[float]:
    """Answer accuracy (reference: reward_func.py:17-84).

    - temporal QA (MCQ): option letter after 'Correct Option:' vs line 1 of GT.
    - General video QA MCQ: whole answer as option letter.
    - free-form (temporal-spatial / general free-form): clamped mean ROUGE F.
    - visual QA / temporal QA: 0.
    """
    solution = [f"<answer>{ans}</answer>" for ans in answer]

    task = kwargs["task"][0]
    question_type = "free-form"
    if task == "temporal QA (MCQ)":
        question_type = "TG_MCQ"
    if task == "General video QA MCQ":
        question_type = "MCQ"
    if task in ("visual QA", "temporal QA"):
        question_type = "none"

    rewards = []
    idx = 0
    for content, sol in zip(_contents(completions), solution):
        try:
            output_ans = extract_answer(content)
            gt_ans = extract_answer(sol)
            if question_type == "TG_MCQ":
                gt_ans = answer[idx].split("\n")[0]
                try:
                    choice = output_ans.split("Correct Option:")[1]
                    reward = _mcq_letter_match(choice, gt_ans)
                except Exception:
                    reward = 0.0
            elif question_type == "free-form":
                reward = max(0.0, min(1.0, _rouge_avg_f(gt_ans, output_ans)))
            elif question_type == "MCQ":
                reward = _mcq_letter_match(output_ans, gt_ans)
            else:
                reward = 0.0
            idx += 1  # quirk: not advanced when the try block raises
        except Exception as e:  # pragma: no cover - defensive parity path
            print(f"Error in reward_fn for question_type '{question_type}': {e}")
            reward = 0.0
        rewards.append(reward)
    return rewards


def _segment_from_answer(output_ans: str) -> list[float]:
    m = TIME_SEGMENT_RE.search(output_ans)
    if not m:
        return []
    start, end = float(m.group(1)), float(m.group(2))
    return [] if end < start else [start, end]


def ans_tiou_reward(completions, answer, **kwargs) -> list[float]:
    """Temporal IoU of the answered segment vs GT (reference: 86-181).

    temporal QA: GT is the literal-eval of the answer string.
    temporal QA (MCQ): GT is line 2 of the answer string.
    All other tasks score 0.
    """
    solution = [f"<answer>{ans}</answer>" for ans in answer]
    task = kwargs["task"][0]
    question_type = {"temporal QA": "TG", "temporal QA (MCQ)": "TG_MCQ"}.get(task, "none")

    rewards = []
    idx = 0
    for content, _sol in zip(_contents(completions), solution):
        try:
            output_ans = extract_answer(content)
            if question_type in ("TG", "TG_MCQ"):
                gt_raw = answer[idx]
                if question_type == "TG_MCQ":
                    gt_raw = gt_raw.split("\n")[1]
                gt_seg = ast.literal_eval(gt_raw)
                times = _segment_from_answer(output_ans)
                reward = segment_iou(times, gt_seg) if len(times) == 2 else 0.0
            else:
                reward = 0.0
            idx += 1  # quirk: see module docstring
        except Exception as e:
            print(f"Error in reward_fn for question_type '{question_type}': {e}")
            reward = 0.0
        rewards.append(reward)
    return rewards


def ans_viou_reward(completions, answer, **kwargs) -> list[float]:
    """Box IoU of the answered box vs GQA-rescaled GT box, visual QA only
    (reference: 184-236). GT is parsed from the wrapped solution string and
    rescaled from original to resized image coordinates."""
    solution = [f"<answer>{ans}</answer>" for ans in answer]
    question_type = "VG" if kwargs["task"][0] == "visual QA" else "none"

    rewards = []
    idx = 0
    for content, sol in zip(_contents(completions), solution):
        try:
            output_ans = extract_answer(content)
            if question_type == "VG":
                reward = 0.0
                m_gt = BOX_RE.search(sol)
                bbox_gt = json.loads(m_gt.group(1)) if m_gt else None
                m_pred = BOX_RE.search(output_ans)
                if m_pred:
                    bbox_pred = json.loads(m_pred.group(1))
                    if bbox_gt is not None and bbox_pred is not None:
                        bbox_gt = rescale_box_gqa(
                            bbox_gt, kwargs["image_size"][idx], kwargs["image_size_refine"][idx]
                        )
                        reward = box_iou(bbox_gt, bbox_pred)
            else:
                reward = 0.0
            idx += 1  # quirk: see module docstring
        except Exception as e:
            print(f"Error in reward_fn for question_type '{question_type}': {e}")
            reward = 0.0
        rewards.append(reward)
    return rewards


def format_reward(completions, **kwargs) -> list[float]:
    """Structural format reward (reference: 239-305).

    0.0  — missing/unbalanced <think>/<answer>, or unbalanced grounding tags
           inside think.
    1.0  — balanced and fully spatio-temporally grounded (obj+t+box present;
           for temporal tasks: >=2 time tags; for visual QA: an
           <obj>word</obj><box>[..]</box> pair anywhere in the completion), or
           any 'General video QA' task.
    0.5  — balanced think+answer without full grounding.
    """
    task = kwargs["task"][0]
    rewards = []
    for content in _contents(completions):
        think_match = THINK_RE.search(content)
        answer_match = ANSWER_RAW_RE.search(content)
        if not (think_match and answer_match):
            rewards.append(0.0)
            continue
        if content.count("<think>") != content.count("</think>"):
            rewards.append(0.0)
            continue
        if content.count("<answer>") != content.count("</answer>"):
            rewards.append(0.0)
            continue

        think = think_match.group(1)
        counts = {
            tag: (think.count(f"<{tag}>"), think.count(f"</{tag}>"))
            for tag in ("obj", "t", "box")
        }
        if any(start != end for start, end in counts.values()):
            rewards.append(0.0)
            continue

        has_st = counts["obj"][0] > 0 and counts["t"][0] > 0 and counts["box"][0] > 0
        if task in ("temporal QA", "temporal QA (MCQ)"):
            has_st = counts["t"][0] >= 2
        if task == "visual QA" and OBJ_BOX_PAIR_RE.search(content):
            has_st = True

        rewards.append(1.0 if has_st or "General video QA" in task else 0.5)
    return rewards


def thk_temporal_segment_reward(completions, **kwargs) -> list[float]:
    """Fraction of <t> points in think that fall inside the GT segment;
    temporal QA (+MCQ) only (reference: 388-426)."""
    task = kwargs["task"][0]
    rewards = []
    idx = 0
    for content in _contents(completions):
        think_match = THINK_RE.search(content)
        if (
            not think_match
            or task == "visual QA"
            or task == "temporal-spatial free-form QA"
            or "General video QA" in task
        ):
            rewards.append(0.0)
            idx += 1
            continue

        think = think_match.group(1)
        reward = 0.0
        gt_raw = kwargs["answer"][idx]
        if task == "temporal QA (MCQ)":
            gt_raw = gt_raw.split("\n")[1]
        gt_seg = ast.literal_eval(gt_raw)

        try:
            times = [float(m) for m in TIME_POINT_RE.findall(think)]
        except Exception:
            times = []

        if times:
            reward = sum(1.0 for t in times if gt_seg[0] <= t <= gt_seg[1]) / len(times)
        rewards.append(reward)
        idx += 1
    return rewards


def thk_temporal_point_reward(completions, **kwargs) -> list[float]:
    """Gaussian proximity of each <t> point in think to the nearest GT
    keyframe time, averaged; temporal-spatial free-form only (reference:
    429-472). sigma anneals with training progress:
    sigma = 4*(1-step_percent) while step_percent < 3/4, else 1."""
    step_percent = kwargs["step_percent"][0]
    task = kwargs["task"][0]
    rewards = []
    idx = 0
    for content in _contents(completions):
        think_match = THINK_RE.search(content)
        if (
            not think_match
            or task in ("visual QA", "temporal QA", "temporal QA (MCQ)")
            or "General video QA" in task
        ):
            rewards.append(0.0)
            idx += 1
            continue

        think = think_match.group(1)
        try:
            pred_times = [float(m) for m in TIME_POINT_RE.findall(think)]
        except Exception:
            pred_times = []

        if pred_times:
            gt_times = [frame["time"] for frame in kwargs["key_frames"][idx]]
            sigma = 4 * (1 - step_percent) if step_percent < 3 / 4 else 1
            total = 0.0
            for t in pred_times:
                diff = min(abs(t - gt) for gt in gt_times)
                total += np.exp(-(diff**2) / (2 * sigma**2))
            rewards.append(total / len(pred_times))
        else:
            rewards.append(0.0)
        idx += 1
    return rewards


def thk_spatial_reward(completions, **kwargs) -> list[float]:
    """Spatial grounding of the reasoning trace (reference: 475-605).

    visual QA: max IoU of any think box vs the GQA-rescaled GT box.
    temporal-spatial free-form: per grounded claim, temporal-gate to the
    nearest GT keyframe (signed pre-check — see module docstring), then score
    the claim's boxes against that keyframe's annotated objects (normalized
    GT boxes converted to pixels), taking max over objects; mean over claims.
    """
    task = kwargs["task"][0]
    rewards = []
    idx = 0
    for content in _contents(completions):
        think_match = THINK_RE.search(content)
        answer_match = ANSWER_RE.search(content)
        if not think_match or not answer_match:
            rewards.append(0.0)
            idx += 1
            continue

        if task == "visual QA":
            m_gt = BOX_RE.search(kwargs["answer"][idx])
            bbox_gt = None
            if m_gt:
                try:
                    bbox_gt = json.loads(m_gt.group(1))
                except Exception:
                    bbox_gt = None
            bboxes_pred = []
            for raw in BOX_RE.findall(think_match.group(1)):
                try:
                    bboxes_pred.append(json.loads(raw))
                except Exception:
                    pass
            if bboxes_pred and bbox_gt is not None:
                bbox_gt = rescale_box_gqa(
                    bbox_gt, kwargs["image_size"][idx], kwargs["image_size_refine"][idx]
                )
                rewards.append(max(box_iou(bbox_gt, bp) for bp in bboxes_pred))
            else:
                rewards.append(0.0)
            idx += 1
            continue

        if task in ("temporal QA", "temporal QA (MCQ)") or "General video QA" in task:
            rewards.append(0.0)
            idx += 1
            continue

        # temporal-spatial free-form QA
        claims = parse_claims(think_match.group(1))
        if not claims:
            rewards.append(0.0)
            idx += 1
            continue

        gt_items = kwargs["key_items"][idx]
        key_frames = kwargs["key_frames"][idx]
        gt_times = [frame["time"] for frame in key_frames]

        total_iou = 0.0
        for claim in claims:
            pred_time = claim["timestamp"]
            closest_time = -1
            min_diff = float("inf")
            threshold = 1.0
            for gt_time in gt_times:
                # Quirk preserved: signed pre-check, abs used only for ranking.
                if gt_time - pred_time < threshold:
                    diff = abs(gt_time - pred_time)
                    if diff < min_diff:
                        min_diff = diff
                        closest_time = gt_time
            if closest_time == -1:
                continue

            key_frame = None
            for frame in key_frames:
                if frame["time"] == closest_time:
                    key_frame = frame
                    break

            if claim["bboxes"] is not None and isinstance(claim["bboxes"], list) and key_frame is not None:
                objects = gt_items[str(key_frame["idx"])]
                max_iou = 0.0
                for obj in objects.keys():
                    claim_boxes = claim["bboxes"]
                    gt_boxes = objects[obj]
                    try:
                        nested = isinstance(claim_boxes[0], list)
                    except Exception:
                        print("Error:", claim_boxes)
                        continue
                    if not nested:
                        claim_boxes = [claim_boxes]

                    per_gt_ious = []
                    for gt_box in gt_boxes:
                        gt_px = denormalize_box(gt_box, kwargs["image_size"][idx])
                        ious = [box_iou(gt_px, cb) for cb in claim_boxes]
                        per_gt_ious.append(max(ious) if ious else 0.0)
                    if per_gt_ious:
                        iou = sum(per_gt_ious) / len(per_gt_ious)
                        max_iou = max(max_iou, iou)
                total_iou += max_iou

        rewards.append(total_iou / len(claims))
        idx += 1
    return rewards


RewardFn = Callable[..., list[float]]

REWARD_REGISTRY: dict[str, RewardFn] = {
    "ans_acc": ans_acc_reward,
    "ans_tiou": ans_tiou_reward,
    "ans_viou": ans_viou_reward,
    "thk_temporal_point": thk_temporal_point_reward,
    "thk_temporal_segment": thk_temporal_segment_reward,
    "thk_spatial": thk_spatial_reward,
    "format": format_reward,
}

DEFAULT_REWARD_FUNCS = list(REWARD_REGISTRY)


def sum_rewards(
    completions, reward_funcs: list[RewardFn], **kwargs
) -> tuple[np.ndarray, np.ndarray]:
    """Run every reward over the group; returns (per_func [G, F], total [G]).

    Total reward is the plain sum across functions (reference:
    grpo_trainer.py:658)."""
    per_func = np.zeros((len(completions), len(reward_funcs)), dtype=np.float32)
    for i, fn in enumerate(reward_funcs):
        per_func[:, i] = np.asarray(fn(completions=completions, **kwargs), dtype=np.float32)
    return per_func, per_func.sum(axis=1)
