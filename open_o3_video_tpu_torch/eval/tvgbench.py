"""TVGBench: temporal video grounding evaluation (counterpart of
``open_o3_video_tpu/eval/tvgbench.py``, a copy held equal to it in the
tests).

EXTENSION: the reference repo mentions TVGBench in its README/results but
ships no harness (SURVEY.md §6 — "no TVGBench harness in the repo");
temporal grounding is otherwise exercised only through V-STAR's temporal
chain. This harness completes the benchmark suite: items are
{video path, query, GT [start, end] (+ optional duration)}, the model is
prompted with the V-STAR temporal-chain prompt dialect, and scores are
R1@{0.3, 0.5, 0.7} + mean tIoU.

An item without a ``duration`` is probed with the video reader the port
picked (``data/video.py:get_video_reader_backend``): the native decoder's
probe, or cv2's frame count and fps. A missing or unreadable video
(``DATA_ERRORS``) is recorded and skipped, and only such an error makes a
failed batch fall back item by item; anything else, on the device above
all, propagates.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

import numpy as np

from ..data import DATA_ERRORS
from ..grounding.tags import refined_timestamps
from .metrics_vstar import recall_at, temporal_iou


def build_prompt(video_length: float, query: str, think_mode: bool = True) -> str:
    """Same dialect as the V-STAR temporal chain (eval/vstar.py)."""
    if think_mode:
        return (
            f"This video is {video_length} seconds long. "
            "<|vision_start|><|video_pad|><|vision_end|>\n"
            f"Answer the question about the video: {query} \n. You must first think about the "
            "reasoning process in the mind and then provide the user with the answer. The "
            "reasoning process and answer are enclosed within <think> </think> and "
            "<answer> </answer> tags, respectively. The answer must follow the following "
            "format: `From <t>start_time</t>s to <t>end_time</t>s'"
        )
    return (
        f"This video is {video_length} seconds long. "
        "<|vision_start|><|video_pad|><|vision_end|>\n"
        f"Answer the question about the video: {query} \nDirectly output the start and end "
        "moment timestamps. You must follow the following format: "
        "`From <t>start_time</t>s to <t>end_time</t>s'."
    )


def probe_duration(video_path: str) -> float:
    """Seconds of a video, read by the reader the port picked: the native
    decoder's probe, or cv2's frame count over its fps."""
    from ..data.video import get_video_reader_backend

    if get_video_reader_backend() == "native":
        from ..native import video_decoder

        meta = video_decoder.probe(video_path)
        return meta.num_frames / meta.fps
    import cv2

    cap = cv2.VideoCapture(video_path)
    try:
        if not cap.isOpened():
            raise IOError(f"cv2 failed to open video: {video_path}")
        frames, fps = cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FPS)
    finally:
        cap.release()
    if not fps > 0:
        raise ValueError(f"{video_path}: no frame rate")
    return frames / fps


def _prepare_tvg_item(item, video_folder, model, think_mode):
    """Host prep for one item -> raw engine input, or None to skip."""
    from .vstar import build_query_input, extract_frames_from_video

    rel = item.get("video_path") or item.get("video")
    video_path = rel if os.path.isabs(rel) else os.path.join(video_folder, rel)
    if not os.path.exists(video_path):
        print(f"Warning: video not found: {video_path}, skipping")
        return None
    query = item.get("query") or item.get("question")
    duration = item.get("duration")
    if duration is None:
        try:
            duration = probe_duration(video_path)
        except DATA_ERRORS:
            duration = 0.0
    prompt = build_prompt(round(float(duration), 2), query, think_mode)
    frames, frame_times = extract_frames_from_video(
        video_path, fps=1.0, max_frames=model.video_max_frames
    )
    if not frames:
        print(f"Warning: no frames extracted: {video_path}, skipping")
        return None
    inp, _ = build_query_input(prompt, frames, frame_times, model)
    return inp


def evaluate(
    anno_file: str,
    video_folder: str,
    model,
    output_file: str,
    *,
    think_mode: bool = True,
    limit: Optional[int] = None,
    item_batch: int = 4,
) -> dict[str, float]:
    """anno_file: JSON list of {video|video_path, query|question,
    timestamps: [s, e], duration?}. Returns the score block.

    ``item_batch`` items prepare on host threads and run through the engine
    as one batch (same treatment as the other harnesses)."""
    with open(anno_file) as f:
        items = json.load(f)
    if limit:
        items = items[:limit]

    t0 = time.time()
    ious: list[float] = []
    results = []
    done = 0
    item_batch = max(1, item_batch)
    from concurrent.futures import ThreadPoolExecutor

    chunks = [items[s : s + item_batch] for s in range(0, len(items), item_batch)]

    def prep_chunk(chunk):
        # Host-only (decode + resize + prompt build); runs one chunk ahead
        # on a background thread while the engine executes the current one.
        with ThreadPoolExecutor(max_workers=min(4, len(chunk))) as pool:
            inputs = list(pool.map(
                lambda it: _prepare_tvg_item(it, video_folder, model, think_mode),
                chunk,
            ))
        if hasattr(model, "prestage_raw_inputs"):
            # Pre-upload from the prefetch thread (overlaps device compute
            # of the previous chunk).
            model.prestage_raw_inputs([i for i in inputs if i is not None])
        return inputs

    prefetch = ThreadPoolExecutor(max_workers=1)
    errors: list = []
    try:
        fut = prefetch.submit(prep_chunk, chunks[0]) if chunks else None
        for ci, chunk in enumerate(chunks):
            try:
                inputs = fut.result()
            except DATA_ERRORS as e:  # re-prep inline
                print(f"[warn] chunk prefetch failed ({e!r}); inline prep")
                inputs = prep_chunk(chunk)
            if ci + 1 < len(chunks):
                fut = prefetch.submit(prep_chunk, chunks[ci + 1])
            live = [(it, inp) for it, inp in zip(chunk, inputs) if inp is not None]
            if not live:
                done += len(chunk)
                continue
            # Skip-and-record (same contract as the other harnesses): one
            # bad item falls back per-item, not a benchmark abort.
            try:
                if hasattr(model, "inference_wo_process_batch"):
                    raws = model.inference_wo_process_batch(
                        [inp for _, inp in live]
                    )
                else:
                    raws = [model.inference_wo_process([inp]) for _, inp in live]
            except DATA_ERRORS as batch_err:
                print(f"[warn] batched chunk failed ({batch_err!r}); "
                      "per-item fallback")
                raws = []
                for it, inp in live:
                    try:
                        raws.append(model.inference_wo_process([inp]))
                    except DATA_ERRORS as e:
                        vid = it.get("video") or it.get("video_path")
                        print(f"[warn] item {vid} failed ({e!r}); skipping")
                        errors.append({"video": vid, "error": repr(e)})
                        raws.append(None)
            done += len(chunk)
            for (item, _), raw in zip(live, raws):
                if raw is None:
                    continue
                pred = refined_timestamps(raw)
                iou = temporal_iou(item["timestamps"], pred) if pred else 0.0
                ious.append(iou)
                results.append({**item, "prediction_raw": raw, "prediction": pred, "tIoU": iou})
                print(f"{done}/{len(items)} tIoU={iou:.3f}")
    finally:
        prefetch.shutdown(wait=False)

    scores = {
        "R1@0.3": recall_at(ious, 0.3),
        "R1@0.5": recall_at(ious, 0.5),
        "R1@0.7": recall_at(ious, 0.7),
        "mIoU": float(np.mean(ious)) if ious else 0.0,
        "num_items": len(ious),
    }
    with open(output_file, "w") as f:
        json.dump({"scores": scores, "results": results, "errors": errors},
                  f, indent=2)
    print(f"TVGBench done in {time.time() - t0:.1f}s: {scores}")
    return scores
