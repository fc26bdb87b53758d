"""Prompt templates the port needs (a copy of part of
``open_o3_video_tpu/grounding/prompts.py``, whose package imports JAX
elsewhere): the system prompts, the vision placeholders, the RL example's
conversation, and the SFT temporal and RL frame prompts with the keyframe
interleave. Video reaches the model as per-frame images with textual
timestamps; these strings are a behavioural contract with the released
checkpoints, copied verbatim.
"""

from __future__ import annotations

from typing import Any, Sequence

VISION_PLACEHOLDER = "<|vision_start|><|video_pad|><|vision_end|>"
IMAGE_PAD_BLOCK = "<|vision_start|><|image_pad|><|vision_end|>"

SYSTEM_PROMPT: dict[str, str] = {
    "visual QA": "A conversation between user and assistant. The user provides an image and asks a question, and the Assistant solves it. The assistant MUST first think about the reasoning process in the mind and then provide the user with the answer. The reasoning process and answer are enclosed within <think> </think> and <answer> </answer> tags, respectively. When referring to particular objects in the reasoning process, the assistant must localize the object with bounding box coordinates between <box> and </box>. The answer must strictly follow the following format:`<obj>object_name</obj><box>bounding_box</box>'.",
    "temporal-spatial free-form QA": "A conversation between user and assistant. The user provides a video and asks a question, and the Assistant solves it. The assistant MUST first think about the reasoning process in the mind and then provide the user with the answer. The reasoning process and answer are enclosed within <think> </think> and <answer> </answer> tags, respectively. All reasoning must be grounded in visual evidence from the video. When you mention any related object, person, or specific visual element in the reasoning process, you must strictly follow the following format: `<obj>object_name</obj><box>bounding_box</box>at<t>time_in_seconds</t>s`. The answer part only requires a text response; tags like <obj>, <box>, <t> are not needed.",
    "temporal QA": "A conversation between user and assistant. The user provides a video and asks a question, and the Assistant determines the precise time period that answers the question. The assistant MUST first think about the reasoning process in the mind and then provide the user with the answer. The reasoning process and answer are enclosed within <think> </think> and <answer> </answer> tags, respectively. When mentioning time during the reasoning process, the assistant must use the format: `<t>time_in_seconds</t>s'.The answer must strictly follow the following format: `From <t>start_time</t>s to <t>end_time</t>s'.",
    "temporal QA (MCQ)": "A conversation between user and assistant. The user provides a video and a multiple-choice question, and the Assistant determines the precise time period that answers the question and selects the correct option. The assistant MUST first think about the reasoning process in the mind and then provide the user with the answer. The reasoning process and answer are enclosed within <think> </think> and <answer> </answer> tags, respectively. When mentioning time during the reasoning process, the assistant must use the format: `<t>time_in_seconds</t>s'. The answer must strictly follow the following format: `From <t>start_time</t>s to <t>end_time</t>s.\nCorrect Option: [ONLY THE LETTER]'.",
    "General video QA MCQ": "A conversation between user and assistant. The user provides a video and asks a multiple-choice question, and the Assistant solves it. The assistant MUST first think about the reasoning process in the mind and then provide the user with the answer. The reasoning process and answer are enclosed within <think> </think> and <answer> </answer> tags, respectively. All reasoning must be grounded in visual evidence from the video. When you mention any related object, person, or specific visual element in the reasoning process, you must strictly follow the following format: `<obj>object_name</obj><box>bounding_box</box>at<t>time_in_seconds</t>s`. Only output the correct option in the <answer> </answer> section.",
    "General video QA Free-form": "A conversation between user and assistant. The user provides a video and asks a question, and the Assistant solves it. The assistant MUST first think about the reasoning process in the mind and then provide the user with the answer. The reasoning process and answer are enclosed within <think> </think> and <answer> </answer> tags, respectively. All reasoning must be grounded in visual evidence from the video. When you mention any related object, person, or specific visual element in the reasoning process, you must strictly follow the following format: `<obj>object_name</obj><box>bounding_box</box>at<t>time_in_seconds</t>s`. The answer part only requires a text response; tags like <obj>, <box>, <t> are not needed.",
}

# SFT system prompts differ subtly from the RL set (reference:
# sft_multi_task.py:60,89,120,148,176) — e.g. visual QA says "MUST localize"
# and omits the answer-format clause; temporal QA omits the think-time rule.
SFT_SYSTEM_PROMPT: dict[str, str] = {
    "visual QA": "A conversation between user and assistant. The user provides an image and asks a question, and the Assistant solves it. The assistant MUST first think about the reasoning process in the mind and then provide the user with the answer. The reasoning process and answer are enclosed within <think> </think> and <answer> </answer> tags, respectively. When referring to particular objects in the reasoning process, the assistant MUST localize the object with bounding box coordinates between <box> and </box>. You MUST strictly follow the format.",
    "temporal-spatial free-form QA": "A conversation between user and assistant. The user provides a video and asks a question, and the Assistant solves it. The assistant MUST first think about the reasoning process in the mind and then provide the user with the answer. The reasoning process and answer are enclosed within <think> </think> and <answer> </answer> tags, respectively. All reasoning must be grounded in visual evidence from the video. When you mention any related object, person, or specific visual element, you must strictly follow the following format: `<obj>object_name</obj><box>bounding_box</box>at<t>time_in_seconds</t>s`.",
    "temporal QA": "A conversation between user and assistant. The user provides a video and asks a question, and the Assistant determines the precise time period that answers the question. The assistant MUST first think about the reasoning process in the mind and then provide the user with the answer. The reasoning process and answer are enclosed within <think> </think> and <answer> </answer> tags, respectively. The answer must strictly follow the following format: `From <t>start_time</t>s to <t>end_time</t>s'",
    "General video QA MCQ": "A conversation between user and assistant. The user provides a video and asks a multiple-choice question, and the Assistant solves it. The assistant MUST first think about the reasoning process in the mind and then provide the user with the answer. The reasoning process and answer are enclosed within <think> </think> and <answer> </answer> tags, respectively. Only output the correct option in the <answer> </answer> section.",
    "General video QA Free-form": "A conversation between user and assistant. The user provides a video and asks a question, and the Assistant solves it. The assistant MUST first think about the reasoning process in the mind and then provide the user with the answer. The reasoning process and answer are enclosed within <think> </think> and <answer> </answer> tags, respectively.",
}


VIDEO_TASKS = (
    "temporal-spatial free-form QA",
    "temporal QA",
    "temporal QA (MCQ)",
    "General video QA MCQ",
    "General video QA Free-form",
)


def make_conversation(example: dict[str, Any]) -> dict[str, Any]:
    """Attach the per-task system prompt + user turn to an RL example
    (reference: data_loader.py:21-40). Mutates and returns ``example`` with a
    new 'prompt' key."""
    task = example.get("task")
    if task == "visual QA":
        system_message = SYSTEM_PROMPT["visual QA"]
        content_list = [{"type": "image"}, {"type": "text", "text": example["question"]}]
    elif task in VIDEO_TASKS:
        system_message = SYSTEM_PROMPT[task]
        content_list = [{"type": "video"}, {"type": "text", "text": example["question"]}]
    else:
        raise ValueError(f"Unknown task: {task}")

    example["prompt"] = [
        {"role": "system", "content": [{"type": "text", "text": system_message}]},
        {"role": "user", "content": content_list},
    ]
    return example


def total_seconds_line(num_frames: int, fps: float) -> str:
    return f"The video is in total {int(num_frames / fps)} seconds.\n"


def frame_prompt_rl(num_frames: int, fps: float) -> str:
    """RL non-interleaved frame prompt incl. total-duration line
    (reference: grpo_trainer.py:479-485)."""
    lines = ""
    for i in range(num_frames):
        lines += f"Frame {i + 1} at {round(i / fps, 1)}s: {IMAGE_PAD_BLOCK}\n"
    return lines + total_seconds_line(num_frames, fps)


def frame_prompt_sft_temporal(num_frames: int, fps: float) -> str:
    """SFT temporal/general-QA frame prompt — note the missing 's' after the
    timestamp, preserved from the reference (sft_multi_task.py:365-371)."""
    lines = ""
    for i in range(num_frames):
        lines += f"Frame {i + 1} at {round(i / fps, 1)}: {IMAGE_PAD_BLOCK}\n"
    return lines + total_seconds_line(num_frames, fps)


def interleave_keyframes(
    num_video_frames: int,
    fps: float,
    key_frame_times: Sequence[float],
    *,
    round_kf_display: bool = True,
    append_total_line: bool = True,
) -> tuple[list[tuple[str, int]], str]:
    """Merge GT keyframes into the uniformly sampled frame stream by
    timestamp, producing the interleave plan and the frame prompt.

    The plan is a list of ("video", ori_idx) / ("kf", kf_idx) entries in
    presentation order. A keyframe is inserted before video frame *i* when
    ``int(i / fps) >= its (pre-rounded) time``; keyframes later than the last
    video frame are dropped — both quirks preserved from the reference
    (grpo_trainer.py:515-533 for RL where kf times are pre-rounded to int and
    displayed with round(.,1); sft_multi_task.py:331-351 for SFT where raw kf
    times are compared and displayed, and no total line is appended).
    """
    kf_cmp_times = [round(t) if round_kf_display else t for t in key_frame_times]
    plan: list[tuple[str, int]] = []
    prompt = ""
    kf_idx = 0
    ori_idx = 0
    frame_idx = 1
    while ori_idx < num_video_frames:
        time_now = int(ori_idx / fps)
        if kf_idx < len(kf_cmp_times) and time_now >= kf_cmp_times[kf_idx]:
            plan.append(("kf", kf_idx))
            display = round(kf_cmp_times[kf_idx], 1) if round_kf_display else kf_cmp_times[kf_idx]
            prompt += f"Frame {frame_idx} at {display}s: {IMAGE_PAD_BLOCK}\n"
            kf_idx += 1
        else:
            plan.append(("video", ori_idx))
            prompt += f"Frame {frame_idx} at {round(ori_idx / fps, 1)}s: {IMAGE_PAD_BLOCK}\n"
            ori_idx += 1
        frame_idx += 1
    if append_total_line:
        prompt += total_seconds_line(num_video_frames, fps)
    return plan, prompt
