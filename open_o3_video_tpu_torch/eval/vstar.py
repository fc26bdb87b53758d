"""V-STAR benchmark harness: 5 queries per item (VQA + 2 grounding chains)
(counterpart of ``open_o3_video_tpu/eval/vstar.py``, a copy held equal to it
in the tests).

Rebuilds eval/test/test_vstar_multi_images.py: cv2 1-fps frame extraction
(<=16 frames), frame prompts with timestamps, the exact five prompt builders
(VQA, Chain-1 temporal->spatial, Chain-2 spatial->temporal with GT box count/
boxes given), JSON repair, bbox extraction with denormalization, and ordered
result aggregation. Parallelism: the reference forks one process per GPU;
here items are batched through the engine in-process.

Frames are HWC uint8 RGB arrays (cv2, no PIL); a frame's size for the box
denormalisation is ``(width, height)`` from its shape. An item whose video is
missing or unreadable (``DATA_ERRORS``) is recorded in ``*_errors.json`` and
skipped; any other error, on the device above all, propagates.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Optional, Sequence

import numpy as np

from ..data import DATA_ERRORS
from ..data.video import process_vision_info
from ..grounding.tags import refined_timestamps

extract_timestamps = refined_timestamps  # same salvage logic (reference: 132-145)


def extract_frames_from_video(video_path: str, fps: float = 1.0, max_frames: int = 16):
    """HWC uint8 RGB frames + times at ~1 fps, uniformly subsampled past
    max_frames (reference: 90-130)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise ValueError(f"Could not open video: {video_path}")
    video_fps = cap.get(cv2.CAP_PROP_FPS)
    total_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    duration = total_frames / video_fps
    frame_interval = int(video_fps / fps)
    expected = int(duration * fps)
    if expected > max_frames:
        frame_indices = np.linspace(0, total_frames - 1, max_frames, dtype=int)
    else:
        frame_indices = list(range(0, total_frames, frame_interval))[:max_frames]

    frames, frame_times = [], []
    for idx in frame_indices:
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
        ok, frame = cap.read()
        if not ok:
            continue
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        frame_times.append(idx / video_fps)
    cap.release()
    return frames, frame_times


def frame_wh(frame: np.ndarray) -> tuple[int, int]:
    """(width, height) of an HWC frame, as PIL's ``Image.size`` gives them."""
    return frame.shape[1], frame.shape[0]


def fix_incomplete_json(json_str: str) -> str:
    """Balance brackets of truncated model JSON (reference: 148-170)."""
    open_sq, close_sq = json_str.count("["), json_str.count("]")
    open_cu, close_cu = json_str.count("{"), json_str.count("}")
    if open_sq > close_sq:
        json_str += "]" * (open_sq - close_sq)
    elif close_sq > open_sq:
        json_str = "[" * (close_sq - open_sq) + json_str
    if open_cu > close_cu:
        json_str += "}" * (open_cu - close_cu)
    elif close_cu > open_cu:
        json_str = "{" * (close_cu - open_cu) + json_str
    return json_str


def create_frame_prompt(frame_times: Sequence[float]) -> str:
    out = ""
    for i, t in enumerate(frame_times):
        out += f"Frame {i + 1} at {round(t, 1)}s: <|vision_start|><|image_pad|><|vision_end|>\n"
    return out


def strip_stray_vision_tags(text: str) -> str:
    """Remove image-pad blocks that leaked into the question body
    (reference: remove_vision_tags, 222-240)."""
    start_marker = "the question about the video"
    end_marker = "<|im_start|>assistant"
    tag = "<|vision_start|><|image_pad|><|vision_end|>"
    start = text.find(start_marker)
    if start == -1:
        return text
    end = text.find(end_marker, start + len(start_marker))
    if end == -1:
        return text
    middle = text[start + len(start_marker) : end].replace(tag, "")
    return text[: start + len(start_marker)] + middle + text[end:]


VIDEO_PAD = "<|vision_start|><|video_pad|><|vision_end|>"


def build_query_input(prompt, frames, frame_times, model, image_inputs=None):
    """One query -> a vLLM-style raw input dict. ``image_inputs`` (the
    smart-resized frames) can be passed in to share the expensive resize
    across the 5 queries of one item — the reference re-processes frames per
    query (inference(), test_vstar_multi_images.py:186-263)."""
    frame_prompt = create_frame_prompt(frame_times)
    if VIDEO_PAD in prompt:
        prompt = prompt.replace(VIDEO_PAD, frame_prompt)
    else:
        prompt = frame_prompt + prompt

    messages = [
        {"role": "system", "content": "You are a helpful assistant."},
        {
            "role": "user",
            "content": [{"type": "text", "text": prompt}]
            + [{"type": "image", "image": frame} for frame in frames],
        },
    ]
    text = model.processor.apply_chat_template(messages, add_generation_prompt=True)
    text = strip_stray_vision_tags(text)

    if image_inputs is None:
        image_inputs, _, _ = process_vision_info([messages], return_video_kwargs=True)
    mm_data = {}
    if image_inputs is not None:
        mm_data["image"] = image_inputs
    return {"prompt": text, "multi_modal_data": mm_data}, image_inputs


def inference(video_path: str, prompt: str, model, fps: float = 1.0):
    """One V-STAR query: frames as images with timestamps (reference: 186-263)."""
    frames, frame_times = extract_frames_from_video(
        video_path, fps=fps, max_frames=model.video_max_frames
    )
    if not frames:
        raise ValueError(f"No frames extracted from video: {video_path}")
    inp, _ = build_query_input(prompt, frames, frame_times, model)
    generated = model.inference_wo_process([inp])
    return generated, len(frames), frame_wh(frames[0])


THINK_SUFFIX_VQA = (
    "You must first think about the reasoning process in the mind and then provide the user "
    "with the answer. The reasoning process and answer are enclosed within <think> </think> "
    "and <answer> </answer> tags, respectively. All reasoning must be grounded in visual "
    "evidence from the video. When you mention any related object, person, or specific visual "
    "element, you must strictly follow the following format: "
    "`<obj>object_name</obj><box>bounding_box</box>at<t>time_in_seconds</t>s`. "
    "Do not use <box>, <obj> and <t> in the answer part."
)


def vqa_prompt(data, think_mode=True) -> str:
    prompt = (
        f"Answer the question about the video: {data['question']} \n "
        "(If the answer is a person, you don't need to identify the person.)"
    )
    if think_mode:
        prompt += THINK_SUFFIX_VQA
    return prompt


def temporal_prompt(data, think_mode=True) -> str:
    video_length = round(data["frame_count"] / data["fps"], 2)
    q = data["temporal_question"]
    if think_mode:
        return (
            f"This video is {video_length} seconds long. "
            "<|vision_start|><|video_pad|><|vision_end|>\n"
            f"Answer the question about the video: {q} \n. You must first think about the "
            "reasoning process in the mind and then provide the user with the answer. The "
            "reasoning process and answer are enclosed within <think> </think> and "
            "<answer> </answer> tags, respectively. The answer must follow the following "
            "format: `From <t>start_time</t>s to <t>end_time</t>s'"
        )
    return (
        f"This video is {video_length} seconds long. "
        "<|vision_start|><|video_pad|><|vision_end|>\n"
        f"Answer the question about the video: {q} \nDirectly output the start and end "
        "moment timestamps. You must follow the following format: "
        "`From <t>start_time</t>s to <t>end_time</t>s'."
    )


def temporal_2_prompt(data, bboxes, think_mode=True) -> str:
    video_length = round(data["frame_count"] / data["fps"], 2)
    q = data["temporal_question"]
    w, h = data["width"], data["height"]
    head = (
        f"This video is {video_length} seconds long with a resolution of {w}x{h} "
        "(width x height). <|vision_start|><|video_pad|><|vision_end|>\n"
        f"Answer the question about the video: {q} \nThere are {len(bboxes)} bounding boxes "
        f"of the key object related to the question in the video without knowing the time, "
        f"which are:{bboxes}. "
    )
    if think_mode:
        return head + (
            "You must first think about the reasoning process in the mind and then provide "
            "the user with the answer. The reasoning process and answer are enclosed within "
            "<think> </think> and <answer> </answer> tags, respectively. The answer must "
            "follow the following format: `From <t>start_time</t>s to <t>end_time</t>s'"
        )
    return head + (
        "Directly output the start and end moment timestamps. You must follow the "
        "following format: `From <t>start_time</t>s to <t>end_time</t>s'."
    )


def get_answer_vqa(data, video_path, model, think_mode=True):
    answer, _, _ = inference(video_path, vqa_prompt(data, think_mode), model)
    return answer


def get_answer_temporal(data, video_path, model, think_mode=True):
    answer, _, _ = inference(video_path, temporal_prompt(data, think_mode), model)
    return answer


def get_answer_temporal_2(data, video_path, bboxes, model, think_mode=True):
    answer, _, _ = inference(video_path, temporal_2_prompt(data, bboxes, think_mode), model)
    return answer


def spatial_prompt(data, think_mode=True) -> str:
    st, et = math.ceil(data["timestamps"][0]), math.floor(data["timestamps"][1])
    time_range = list(range(st, et + 1))
    q = data["spatial_question"]
    if think_mode:
        prompt = f"""<|vision_start|><|video_pad|><|vision_end|>
Please answer the question about the video: {q} with a series of bounding boxes in [x1, y1, x2, y2] format.
You must first think about the reasoning process in the mind and then provide the user with the answer. The reasoning process and answer are enclosed within <think> </think> and <answer> </answer> tags, respectively.
In the answer part, for each whole second within the time range {time_range} provided (inclusive of the boundaries), output a series of bounding boxes of the object in JSON format. The keys should be the whole seconds (as strings), and the values should be the box in [x1, y1, x2, y2] format.
Example output of the answer part: {{"{time_range[0]}": [x1, y1, x2, y2],...}}
"""
    else:
        prompt = f"""<|vision_start|><|video_pad|><|vision_end|>
Please answer the question about the video: {q} with a series of bounding boxes in [x1, y1, x2, y2] format.
For each whole second within the time range {time_range} provided (inclusive of the boundaries), output a series of bounding boxes of the object in JSON format. The keys should be the whole seconds (as strings), and the values should be the box in [x1, y1, x2, y2] format.
Example output: {{"{time_range[0]}": [x1, y1, x2, y2],...}}
"""
    return prompt


def get_answer_spatial(data, video_path, model, think_mode=True):
    answer, _, frame_size = inference(video_path, spatial_prompt(data, think_mode), model)
    return answer, frame_size[0], frame_size[1]


def spatial_2_prompt(data, bboxes, think_mode=True) -> str:
    q = data["spatial_question_2"]
    n = len(bboxes)
    if think_mode:
        prompt = f"""<|vision_start|><|video_pad|><|vision_end|>
Please answer the question about the video: {q} with a series of bounding boxes in [x1, y1, x2, y2] format.
You must first think about the reasoning process in the mind and then provide the user with the answer. The reasoning process and answer are enclosed within <think> </think> and <answer> </answer> tags, respectively.
In the answer part, for each whole second that may related to the question, output a series of bounding boxes of the object in JSON format. You only need to output {n} bbox(es). You need to determine which frame is related to the question, and you don't need to output the bbox for the frames not related to the question.
The keys should be the whole seconds (as strings), and the values should be the bounding box in [x0,y0,x1,y1] format.

Example output of the answer part:
{{"0": [x0,y0,x1,y1], "1":..., ..., "{n}":...}} (if the frames at 0~{n} second are related to the questions)
"""
    else:
        prompt = f"""<|vision_start|><|video_pad|><|vision_end|>
Please answer the question about the video: {q} with a series of bounding boxes in [x1, y1, x2, y2] format.
For each whole second that may related to the question, output a series of bounding boxes of the object in JSON format. You only need to output {n} bbox(es). You need to determine which frame is related to the question, and you don't need to output the bbox for the frames not related to the question.
The keys should be the whole seconds (as strings), and the values should be the bounding box in [x0,y0,x1,y1] format.

Example output:
{{"0": [x0,y0,x1,y1], "1":..., ..., "{n}":...}} (if the frames at 0~{n} second are related to the questions)
"""
    return prompt


def get_answer_spatial_2(data, video_path, bboxes, model, think_mode=True):
    answer, _, frame_size = inference(video_path, spatial_2_prompt(data, bboxes, think_mode), model)
    return answer, frame_size[0], frame_size[1]


def extract_bounding_boxes(answer_spatial: str, data: dict, input_width: int, input_height: int):
    """Parse the per-second box JSON and denormalize from model-frame to
    original video resolution (reference: 375-449)."""
    m = re.search(r"<answer>(.*?)</answer>", answer_spatial, re.DOTALL)
    if m:
        answer_spatial = m.group(1).strip()
    w, h = data["width"], data["height"]

    def denorm(bbox):
        try:
            if len(bbox) == 1:
                bbox = bbox[0]
            if len(bbox) == 2:
                bbox = bbox[1]
            return [
                int(bbox[0] / input_width * w),
                int(bbox[1] / input_height * h),
                int(bbox[2] / input_width * w),
                int(bbox[3] / input_height * h),
            ]
        except Exception as e:
            print(f"Processing {bbox} occurs Error {e}")
            return bbox

    markdown = re.search(r"```json\s*\n(\[.*?\]|\{.*?\})\s*\n```", answer_spatial, re.DOTALL)
    m = markdown or re.search(r"(\[[\s\S]*\]|\{[\s\S]*\})", answer_spatial, re.DOTALL)
    if not m:
        print("No match found for the bounding box JSON.")
        return None
    raw = m.group(1).strip().replace("'", '"')
    try:
        boxes = json.loads(raw)
    except Exception:
        fixed = fix_incomplete_json(raw)
        try:
            boxes = json.loads(fixed)
        except Exception as e:
            print(f"Failed after fixing: {e}\nExtracted JSON: {fixed}")
            return None
        if isinstance(boxes, list):
            return [b for b in boxes]
        if isinstance(boxes, dict):
            return {k: denorm(v) for k, v in boxes.items()}
        return None
    if isinstance(boxes, list) and all(isinstance(item, dict) for item in boxes):
        combined = {}
        for item in boxes:
            combined.update(item)
        boxes = combined
    if isinstance(boxes, list):
        return {str(b[0]): denorm(b[1]) for b in boxes}
    if isinstance(boxes, dict):
        return {k: denorm(v) for k, v in boxes.items()}
    return None


def find_video(video_folder: str, vid: str) -> Optional[str]:
    target = f"{vid}.mp4"
    for root, _, files in os.walk(video_folder):
        if target in files:
            return os.path.join(root, target)
    return None


# The 5 independent queries per item: the chains' "dependencies" are GT
# inputs (spatial uses GT timestamps, chain 2 uses GT boxes), so all five
# can run as ONE engine batch — the reference issues them sequentially
# (worker body, test_vstar_multi_images.py:473-571).
QUERY_KEYS = ("vqa", "temporal", "spatial", "spatial_2", "temporal_2")


def prepare_item_inputs(data: dict, video_path: str, model, think_mode: bool = True):
    """Decode frames ONCE, build all 5 query inputs.

    Returns (inputs dict key->raw input, frame_size (w, h))."""
    frames, frame_times = extract_frames_from_video(
        video_path, fps=1.0, max_frames=model.video_max_frames
    )
    if not frames:
        raise ValueError(f"No frames extracted from video: {video_path}")
    gt_boxes = [
        {k: box[k] for k in ("xmin", "ymin", "xmax", "ymax")} for box in data.get("bboxes", [])
    ]
    prompts = {
        "vqa": vqa_prompt(data, think_mode),
        "temporal": temporal_prompt(data, think_mode),
        "spatial": spatial_prompt(data, think_mode),
        "spatial_2": spatial_2_prompt(data, gt_boxes, think_mode),
        "temporal_2": temporal_2_prompt(data, gt_boxes, think_mode),
    }
    inputs = {}
    image_inputs = None
    for key in QUERY_KEYS:
        inputs[key], image_inputs = build_query_input(
            prompts[key], frames, frame_times, model, image_inputs
        )
    return inputs, frame_wh(frames[0])


def _parse_item_result(data: dict, texts: dict, frame_size) -> dict:
    iw, ih = frame_size
    result = dict(data)
    result["answer_vqa"] = texts["vqa"]
    result["answer_temporal_pre"] = texts["temporal"]
    result["answer_temporal"] = extract_timestamps(texts["temporal"])
    result["answer_spatial_pre"] = texts["spatial"]
    result["answer_spatial"] = extract_bounding_boxes(texts["spatial"], data, iw, ih)
    result["answer_spatial_pre_2"] = texts["spatial_2"]
    result["answer_spatial_2"] = extract_bounding_boxes(texts["spatial_2"], data, iw, ih)
    result["answer_temporal_pre_2"] = texts["temporal_2"]
    result["answer_temporal_2"] = extract_timestamps(texts["temporal_2"])
    return result


def prep_items_host(
    items: Sequence[dict],
    video_folder: str,
    model,
    think_mode: bool = True,
    errors: Optional[list] = None,
) -> list[tuple]:
    """Host phase of ``process_items_batched``: decode + resize + prompt
    build for a slice of items, in a thread pool (the cv2/native decoders
    release the GIL). Split out so ``evaluate`` can prefetch the next
    slice's host work while the engine runs the current one."""
    from concurrent.futures import ThreadPoolExecutor

    def prep(data):
        vid = data.get("vid") or data.get("video_id")
        video_path = data.get("video_path") or find_video(video_folder, vid)
        if video_path is None or not os.path.exists(video_path):
            return (data, None, None, {"vid": vid, "error": "video not found"})
        try:
            inputs, size = prepare_item_inputs(data, video_path, model, think_mode)
        except DATA_ERRORS as e:
            return (data, None, None, {"vid": vid, "error": repr(e)})
        if hasattr(model, "prestage_raw_inputs"):
            # Pre-upload the item's (shared) frames from this prefetch
            # thread so the transfer overlaps the engine's device phase
            # of the previous slice.
            model.prestage_raw_inputs(list(inputs.values()))
        return (data, inputs, size, None)

    prepared = []
    with ThreadPoolExecutor(max_workers=min(4, max(1, len(items)))) as pool:
        for data, inputs, frame_size, err in pool.map(prep, items):
            if err is not None:
                print(f"Warning: {err['vid']}: {err['error']}, skipping")
                if errors is not None:
                    errors.append(err)
                continue
            prepared.append((data, inputs, frame_size))
    return prepared


def process_items_batched(
    items: Sequence[dict],
    video_folder: str,
    model,
    think_mode: bool = True,
    errors: Optional[list] = None,
    prepared: Optional[list] = None,
) -> list[dict]:
    """Run a slice of items with every query batched through the engine.

    Replaces the reference's 8-process fleet (test_vstar_multi_images.py:
    621-693) with in-process engine batching; failed items are recorded in
    ``errors`` and skipped instead of terminating the run (the reference
    kills the whole fleet on first error, :644-674). ``prepared`` (the
    output of ``prep_items_host``) skips the host phase when the caller
    already ran it — e.g. prefetched on a background thread."""
    if prepared is None:
        prepared = prep_items_host(items, video_folder, model, think_mode, errors)

    if not prepared:
        return []

    flat_inputs = [inputs[k] for _, inputs, _ in prepared for k in QUERY_KEYS]
    if hasattr(model, "inference_wo_process_batch"):
        flat_texts = model.inference_wo_process_batch(flat_inputs)
    else:
        flat_texts = [model.inference_wo_process([inp]) for inp in flat_inputs]

    results = []
    nq = len(QUERY_KEYS)
    for i, (data, _, frame_size) in enumerate(prepared):
        texts = dict(zip(QUERY_KEYS, flat_texts[i * nq : (i + 1) * nq]))
        results.append(_parse_item_result(data, texts, frame_size))
    return results


def process_item(data: dict, video_folder: str, model, think_mode: bool = True) -> Optional[dict]:
    """Run all 5 queries for one item (reference worker body: 473-571)."""
    out = process_items_batched([data], video_folder, model, think_mode)
    return out[0] if out else None


def evaluate(
    anno_file: str,
    video_folder: str,
    model,
    output_file: str,
    *,
    think_mode: bool = True,
    limit: Optional[int] = None,
    item_batch: int = 4,
) -> list[dict]:
    """Full benchmark pass; results restored to annotation order
    (reference main: 575-693). ``item_batch`` items run together, so each
    engine step sees up to 5*item_batch concurrent requests."""
    with open(anno_file) as f:
        annotations = json.load(f)
    for i, item in enumerate(annotations):
        item["original_index"] = i
    if limit:
        annotations = annotations[:limit]

    results, errors = [], []
    item_batch = max(1, item_batch)
    chunks = [annotations[s : s + item_batch]
              for s in range(0, len(annotations), item_batch)]
    # Chunk k+1's host phase (video decode + resize + prompt build) runs on
    # a background thread while the engine executes chunk k's 5*item_batch
    # requests — steady state is max(host, device), the same overlap the
    # reference's process fleet gets from OS scheduling.
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as prep_pool:
        fut = prep_pool.submit(
            prep_items_host, chunks[0], video_folder, model, think_mode, errors
        ) if chunks else None
        for ci, chunk in enumerate(chunks):
            try:
                prepared = fut.result()
            except DATA_ERRORS as e:  # re-prep inline
                print(f"[warn] chunk prefetch failed ({e!r}); inline prep")
                prepared = None
            if ci + 1 < len(chunks):
                fut = prep_pool.submit(
                    prep_items_host, chunks[ci + 1], video_folder, model,
                    think_mode, errors,
                )
            results.extend(
                process_items_batched(
                    chunk, video_folder, model, think_mode,
                    errors=errors, prepared=prepared,
                )
            )
    results.sort(key=lambda r: r["original_index"])
    with open(output_file, "w") as f:
        json.dump(results, f, indent=2)
    if errors:
        err_file = output_file.replace(".json", "") + "_errors.json"
        with open(err_file, "w") as f:
            json.dump(errors, f, indent=2)
        print(f"{len(errors)} items failed -> {err_file}")
    print(f"V-STAR inference complete: {len(results)} items -> {output_file}")
    return results
