"""VideoMME benchmark dataloader + metrics (counterpart of
``open_o3_video_tpu/eval/dataloaders/videomme.py``, a copy held equal to it
in the tests).

Rebuilds eval/dataloader/videomme.py: parquet ingestion (pandas, imported
when the data loads), optional ASR subtitle prepending, the think-mode MCQ
prompt (with the '100 words' cap), and accuracy aggregation over duration x
category x sub-category x task-type.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Optional

from ..mcq import get_multi_choice_info, parse_multi_choice_response

VIDEO_TYPE = ["short", "medium", "long"]
CATEGORIES = [
    "Knowledge",
    "Film & Television",
    "Sports Competition",
    "Artistic Performance",
    "Life Record",
    "Multilingual",
]
SUB_CATEGORIES = [
    "Humanity & History", "Literature & Art", "Biology & Medicine",
    "Finance & Commerce", "Astronomy", "Geography", "Law", "Life Tip",
    "Technology", "Animation", "Movie & TV Show", "Documentary",
    "News Report", "Esports", "Basketball", "Football", "Athletics",
    "Other Sports", "Stage Play", "Magic Show", "Variety Show",
    "Acrobatics", "Handicraft", "Food", "Fashion", "Daily Life",
    "Travel", "Pet & Animal", "Exercise", "Multilingual",
]
TASK_CATEGORIES = [
    "Temporal Perception", "Spatial Perception", "Attribute Perception",
    "Action Recognition", "Object Recognition", "OCR Problems",
    "Counting Problem", "Temporal Reasoning", "Spatial Reasoning",
    "Action Reasoning", "Object Reasoning", "Information Synopsis",
]

THINK_OPTION_PROMPT = (
    "Select the best answer to the multiple-choice question based on the video. You must "
    "first think about the reasoning process in the mind and then provide the user with the "
    "answer. The reasoning process and answer are enclosed within <think> </think> and "
    "<answer> </answer> tags, respectively. All reasoning must be grounded in visual evidence "
    "from the video. When you mention any related object, person, or specific visual element, "
    "you must strictly follow the following format: "
    "`<obj>object_name</obj><box>bounding_box</box>at<t>time_in_seconds</t>s`. The reasoning "
    "process MUST NOT be longer than 100 words. In the answer part, respond with only the "
    "letter (A, B, C, or D) of the correct option."
)
PLAIN_OPTION_PROMPT = (
    "Select the best answer to the multiple-choice question based on the video. Respond with "
    "only the letter (A, B, C, or D) of the correct option."
)


def doc_to_text(doc: dict, think_mode: bool = False) -> list[str]:
    """(reference: videomme_doc_to_text, 201-212)"""
    question = doc["question"] + "\n" + "\n".join(f"{opt}" for opt in doc["options"])
    if think_mode:
        return ["Question:" + question + "\n" + THINK_OPTION_PROMPT]
    return [PLAIN_OPTION_PROMPT + "\n" + question + "\n"]


def doc_to_visual(doc: dict, cache_dir: str) -> tuple[list[str], list[None]]:
    """Resolve the video file, tolerating .MP4/.mkv variants
    (reference: 187-198)."""
    video_path = os.path.join(cache_dir, "data", doc["videoID"] + ".mp4")
    for candidate in (video_path, video_path.replace("mp4", "MP4"), video_path.replace("mp4", "mkv")):
        if os.path.exists(candidate):
            return [candidate], [None]
    sys.exit(f"video path:{video_path} does not exist, please check")


class VideoMMEBench:
    """Parquet -> (video_paths, image_input, text_input, docs)
    (reference: VideoMME_Bench, 12-68)."""

    def __init__(self, data_dir: str, add_asr: bool = False, asr_dir: Optional[str] = None,
                 think_mode: bool = False):
        self.data_dir = data_dir
        self.add_asr = add_asr
        self.asr_dir = asr_dir
        self.think_mode = think_mode
        print("think mode:", self.think_mode)

    def get_data(self):
        import pandas as pd

        print("Loading data...")
        filename = os.path.join(self.data_dir, "videomme/test-00000-of-00001.parquet")
        df = pd.read_parquet(filename)
        video_paths, image_input, text_input, all_docs = [], [], [], []
        for _, row in df.iterrows():
            doc = row.to_dict()
            all_docs.append(doc)
            vp, img = doc_to_visual(doc, self.data_dir)
            text = doc_to_text(doc, self.think_mode)
            if self.add_asr:
                asr_path = os.path.join(self.asr_dir, doc["videoID"] + ".mp4.txt")
                asr = ""
                if os.path.exists(asr_path):
                    with open(asr_path, encoding="utf-8") as f:
                        asr = f.read()
                if asr == "":
                    text = [
                        "Audio transcripts of the video:\n"
                        + "This video does not have audio transcripts.\nQuestion:" + text[0]
                    ]
                else:
                    text = ["Audio transcripts of the video:\n" + asr + "\nQuestion:" + text[0]]
            video_paths.extend(vp)
            image_input.extend(img)
            text_input.extend(text)
        print(f"Data loaded: {len(all_docs)}/{len(df)}")
        return video_paths, image_input, text_input, all_docs


def process_results(doc: dict, pred: str, think=None, frame_shape=None) -> dict[str, Any]:
    """(reference: videomme_process_results_new, 247-275)"""
    index2ans, all_choices = get_multi_choice_info(doc["options"])
    pred_ans = parse_multi_choice_response(pred, all_choices, index2ans)
    return {
        "question_id": doc["question_id"],
        "duration": doc["duration"],
        "category": doc["domain"],
        "sub_category": doc["sub_category"],
        "task_category": doc["task_type"],
        "pred_answer": pred_ans,
        "answer": doc["answer"],
        "response": pred,
        "reasoning_process": think,
        "frame_shape": frame_shape,
        "video_id": doc["videoID"],
    }


def aggregate_results(results: list[dict], log=print) -> float:
    """Accuracy over every (duration, category, sub, task) cell + overall
    (reference: videomme_aggregate_results, 278-355)."""
    category2score: dict[str, dict[str, int]] = {}
    for vt in VIDEO_TYPE:
        for c in CATEGORIES:
            for sc in SUB_CATEGORIES:
                for tc in TASK_CATEGORIES:
                    category2score[f"{vt}_{c}_{sc}_{tc}"] = {"correct": 0, "answered": 0}

    for r in results:
        key = f"{r['duration']}_{r['category']}_{r['sub_category']}_{r['task_category']}"
        category2score[key]["answered"] += 1
        category2score[key]["correct"] += r["pred_answer"] == r["answer"]

    def report(groups, label):
        for g in groups:
            correct = sum(v["correct"] for k, v in category2score.items() if g in k)
            answered = sum(v["answered"] for k, v in category2score.items() if g in k)
            log(f"Evaluation on {label}: {g}: {100 * correct / answered if answered > 0 else 0 : .1f}%")

    report(VIDEO_TYPE, "video Type")
    report(CATEGORIES, "Categories")
    report(SUB_CATEGORIES, "Video Sub Categories")
    report(TASK_CATEGORIES, "Task Categories")

    correct = sum(v["correct"] for v in category2score.values())
    answered = sum(v["answered"] for v in category2score.values())
    overall = 100 * correct / answered if answered > 0 else 0
    log(f"Overall Performance: {overall : .1f}%")
    return overall
