"""WorldSense benchmark dataloader + metrics (counterpart of
``open_o3_video_tpu/eval/dataloaders/worldsense.py``, a copy held equal to
it in the tests).

Rebuilds eval/dataloader/worldsense.py: TSV ingestion (pandas, imported when
the data loads), ASR (.wav.txt) transcript prepending, the think/plain MCQ
prompt templates, the MCQ parser variant with the seeded random fallback,
and the duration x domain x sub-category x task-domain x task-type x
audio-class rating table.

The TSV's python-list literals (``candidates``, ``audio_class``) are read
with ``literal_value`` (``ast.literal_eval``) where the JAX package calls
``eval``: the same value for every literal, and a ValueError, a data error,
for anything else.
"""

from __future__ import annotations

import ast
import json
import os
import os.path as osp
import random
from typing import Any

import numpy as np

from ..mcq import parse_multi_choice_response as _parse_base

BASE_SYS = "Carefully watch this video and pay attention to every detail. "
SYS = BASE_SYS + "Based on your observations, select the best option that accurately addresses the question."

FRAMES_TMPL_NOSUB = """
These are the frames of a video. \
Audio transcripts of the video:\nThis video does not have audio transcripts. \
"""

REQUIREMENTS = """
Select the best answer to the multiple-choice question based on the video. \
Respond with only the letter (A, B, C, or D) of the correct option. \
"""

REQUIREMENTS_THK = """
Select the best answer to the multiple-choice question based on the video. \
You must first think about the reasoning process in the mind and then provide the user with the answer. The reasoning process and answer are enclosed within <think> </think> and <answer> </answer> tags, respectively. All reasoning must be grounded in visual evidence from the video. When you mention any related object, person, or specific visual element, you must strictly follow the following format: `<obj>object_name</obj><box>bounding_box</box>at<t>time_in_seconds</t>s`. The reasoning process MUST NOT be longer than 100 words.\
In the answer part, respond with only the letter (A, B, C, or D) of the correct option. \
"""

FRAMES_TMPL_SUB = """
These are the frames of a video. \
Audio transcripts of the video:\n
{}
"""

FAIL_MSG = "Failed to obtain answer via API."

DURATIONS = ["<1min", "1-2min", "2-4min", "4-6min", "6-8min", ">8min"]
DOMAINS = [
    "Tech & Science", "Culture & Politics", "Daily Life", "Film & TV",
    "Performance", "Games", "Sports", "Music",
]
SUB_CATEGORIES = [
    "Academic Lectures", "Auto", "Software", "Physics", "Climate Change",
    "Space Missions", "Chemistry", "Engineering Projects", "Biology",
    "Science Explainers", "Artificial Intelligence", "Astronomy",
    "Tech Reviews", "Editorials", "Politics", "Historical Analysis",
    "Social Commentary", "Book Reviews", "Cultural Explainers",
    "Drawing Tutorials", "Celebrity Interviews", "Art Exhibitions",
    "Fashion", "Travel", "Daily Vlogs", "Cooking", "Pranks", "Camping",
    "Nutrition & Health", "Home Improvement", "Painting & Photography",
    "Unboxing Videos", "Family Vlogs", "DIY & Crafts", "Skincare & Makeup",
    "Documentaries", "Film Trailers", "Event Livestreams", "Short Films",
    "Documentary Profiles", "Movie Reviews", "World News", "Talks",
    "Parodies", "Storytime", "Stand-up", "Sketches", "FPS Game",
    "Casual Game", "Role Playing Game", "Sports Game", "Basketball",
    "Racing", "Football", "Bowling Ball", "Soccer", "Motorsport",
    "swimming", "Boxing", "Other Sports", "Fitness", "Fishing", "Hiking",
    "Covers", "Music Videos", "Remixes", "Walkthroughs",
]
TASK_DOMAINS = ["Recognition", "Understanding", "Reasoning"]
TASK_CATEGORIES = [
    "Anomaly Recognition", "Event Recognition", "Attribute Recognition",
    "Human Interaction", "Temporal Localization", "Video Emotions",
    "Event Sorting", "Hallucination", "Text and Diagram Understanding",
    "Attribute Reasoning", "Causal Reasoning", "Object Counting",
    "Action Counting", "Temporal Prediction", "Emotion Change",
    "Audio Counting", "Scene Recognition", "Human-object Interaction",
    "Human Emotions", "Object State Change", "Relation Reasoning",
    "Spatial Relation", "Audio Source Localization", "Audio Recognition",
    "Object Existence Recognition", "Audio Change",
]
AUDIO_CLASSES = ["Speech", "Event", "Music"]


def literal_value(text: str):
    """A python literal stored as text in the TSV (a list of strings), read
    with ``ast.literal_eval``: what ``eval`` gives for every literal; any
    other text raises ValueError."""
    try:
        return ast.literal_eval(text)
    except (SyntaxError, TypeError) as e:
        raise ValueError(f"not a python literal: {text!r}") from e


def parse_multi_choice_response(response, all_choices=("A", "B", "C", "D"), index2ans=True):
    """WorldSense MCQ parser: same cascade as VideoMME but falls back to a
    seed-42 random choice instead of 'No Answer Found'
    (reference: worldsense.py:122-249)."""
    if response == "API Error" or response == "":
        return "API Error"
    all_choices = list(all_choices)
    pred = _parse_base(response, all_choices, index2ans if isinstance(index2ans, dict) else {})
    if pred not in all_choices:
        random.seed(42)
        pred = random.choice(all_choices)
    return pred


class WorldSenseBench:
    """TSV -> (video_paths, image_input, text_input, docs)
    (reference: WorldSense_Bench, 48-104)."""

    def __init__(self, data_dir=None, add_asr: bool = True, asr_dir=None, think_mode: bool = False):
        self.data_dir = data_dir
        self.add_asr = add_asr
        self.asr_dir = asr_dir
        self.think_mode = think_mode
        print("think mode:", self.think_mode)

    def get_data(self):
        import pandas as pd

        print("Loading data...")
        df = pd.read_csv(os.path.join(self.data_dir, "WorldSense.tsv"), sep="\t")
        video_paths, image_input, text_input, all_docs = [], [], [], []
        for _, row in df.iterrows():
            doc = row.to_dict()
            all_docs.append(doc)
            vp, img, txt = self.process_data(doc)
            video_paths.extend(vp)
            image_input.extend(img)
            text_input.extend(txt)
        print(f"Data loaded: {len(all_docs)}/{len(df)}")
        return video_paths, image_input, text_input, all_docs

    def process_data(self, line: dict):
        asr_path = osp.join(self.asr_dir, line["video"] + ".wav.txt") if self.asr_dir else ""
        subtitles = ""
        if self.add_asr and asr_path and osp.exists(asr_path):
            with open(asr_path) as f:
                subtitles = f.read()
        video_path = osp.join(self.data_dir, line["video"] + ".mp4")
        text = SYS + (FRAMES_TMPL_SUB.format(subtitles) if subtitles != "" else FRAMES_TMPL_NOSUB)
        candidates = line["candidates"]
        if isinstance(candidates, str):
            candidates = literal_value(candidates)  # TSV stores a python-list literal
        question_str = line["question"] + "\n" + "\n".join(candidates)
        text += f"Question: {question_str}\n"
        text += REQUIREMENTS_THK if self.think_mode else REQUIREMENTS
        return [video_path], [None], [text]


def get_dimension_rating(records: list[dict[str, Any]]) -> dict[str, Any]:
    """Per-duration rating table over every taxonomy axis
    (reference: worldsense.py:462-521). ``records`` need keys: domain,
    sub_category, task_domain, task_type, audio_class (list), duration,
    score."""
    rating = {
        duration: {
            "overall": "",
            "domain": {k: [] for k in DOMAINS},
            "sub_category": {k: [] for k in SUB_CATEGORIES},
            "task_domain": {k: [] for k in TASK_DOMAINS},
            "task_type": {k: [] for k in TASK_CATEGORIES},
            "audio_class": {k: [] for k in AUDIO_CLASSES},
        }
        for duration in DURATIONS + ["overall"]
    }

    for rec in records:
        audio_ctg = rec["audio_class"]
        if isinstance(audio_ctg, str):
            audio_ctg = literal_value(audio_ctg)
        score = float(rec["score"])
        for duration in ("overall", rec["duration"]):
            block = rating[duration]
            block["domain"][rec["domain"]].append(score)
            block["sub_category"][rec["sub_category"]].append(score)
            block["task_domain"][rec["task_domain"]].append(score)
            block["task_type"][rec["task_type"]].append(score)
            for a in audio_ctg:
                block["audio_class"][a].append(score)

    for duration in ["overall"] + DURATIONS:
        block = rating[duration]
        valid = [x for x in sum(block["domain"].values(), []) if x >= 0]
        block["overall"] = f"{np.mean(valid):.3f}" if valid else "nan"
        for axis in ("domain", "sub_category", "task_domain", "task_type", "audio_class"):
            for key, scores in block[axis].items():
                kept = [x for x in scores if x >= 0]
                block[axis][key] = f"{np.mean(kept):.3f}" if kept else "nan"
    return rating


def dump(data: list[dict[str, Any]], f: str) -> None:
    """Multi-format row-table dump, dispatched on suffix (reference:
    worldsense.py:405-429). Rows are list-of-dicts (the reference passes
    pandas frames; the formats on disk are identical). xlsx goes through
    utils.xlsx (stdlib zip+xml — no xlsxwriter in this environment)."""
    suffix = f.rsplit(".", 1)[-1]
    if suffix == "xlsx":
        from ...utils.xlsx import write_xlsx

        write_xlsx(f, data)
    elif suffix == "json":
        with open(f, "w", encoding="utf-8") as fo:
            json.dump(data, fo, indent=4, ensure_ascii=False, default=str)
    elif suffix == "jsonl":
        with open(f, "w", encoding="utf-8") as fo:
            fo.write("\n".join(
                json.dumps(x, ensure_ascii=False, default=str) for x in data
            ))
    elif suffix == "pkl":
        import pickle

        with open(f, "wb") as fo:
            pickle.dump(data, fo)
    elif suffix in ("csv", "tsv"):
        import csv

        cols = list(data[0].keys()) if data else []
        with open(f, "w", encoding="utf-8", newline="") as fo:
            w = csv.DictWriter(fo, fieldnames=cols, quoting=csv.QUOTE_ALL,
                               delimiter="," if suffix == "csv" else "\t")
            w.writeheader()
            w.writerows(data)
    else:
        raise KeyError(suffix)


def load(f: str, fmt: str | None = None):
    """Suffix-dispatched loader, inverse of dump (reference: 431-460)."""
    suffix = fmt or f.rsplit(".", 1)[-1]
    if suffix == "xlsx":
        from ...utils.xlsx import read_xlsx

        return read_xlsx(f)
    if suffix == "json":
        with open(f, encoding="utf-8") as fo:
            return json.load(fo)
    if suffix == "jsonl":
        with open(f, encoding="utf-8") as fo:
            return [json.loads(x) for x in fo.read().splitlines() if x.strip()]
    if suffix == "pkl":
        import pickle

        with open(f, "rb") as fo:
            return pickle.load(fo)
    if suffix in ("csv", "tsv"):
        import csv

        with open(f, encoding="utf-8", newline="") as fo:
            return list(csv.DictReader(
                fo, delimiter="," if suffix == "csv" else "\t"))
    raise KeyError(suffix)


def _score_records(records: list[dict[str, Any]]) -> list[dict[str, Any]]:
    for rec in records:
        pred = parse_multi_choice_response(str(rec["prediction"]))
        rec["score"] = int(pred == rec["answer"])
    return records


def process_result(records: list[dict[str, Any]], out_prefix: str) -> dict[str, Any]:
    """Score raw predictions and dump <prefix>_score.{xlsx,json} +
    <prefix>_rating.json (reference: worldsense_process_result, 523-563;
    the xlsx table comes from utils.xlsx, the JSON copy is kept for
    greppability)."""
    records = _score_records(records)
    dump(records, out_prefix + "_score.xlsx")
    with open(out_prefix + "_score.json", "w") as f:
        json.dump(records, f, indent=2, default=str)
    rating = get_dimension_rating(records)
    with open(out_prefix + "_rating.json", "w") as f:
        json.dump(rating, f, indent=2)
    return rating


def worldsense_process_result(eval_file: str) -> dict[str, Any]:
    """The reference's exact entry contract (worldsense.py:529-565): takes a
    predictions ``.xlsx``, writes ``_score.xlsx`` + ``_rating.json`` beside
    it, returns the rating."""
    assert eval_file.endswith(".xlsx"), "data file should be an xlsx file"
    records = _score_records(load(eval_file))
    dump(records, eval_file.replace(".xlsx", "_score.xlsx"))
    rating = get_dimension_rating(records)
    with open(eval_file.replace(".xlsx", "_rating.json"), "w") as f:
        json.dump(rating, f, indent=2)
    return rating
