"""VideoMMMU benchmark dataloader + MMMU metrics (counterpart of
``open_o3_video_tpu/eval/dataloaders/videommmu.py``, a copy held equal to it
in the tests).

Rebuilds eval/dataloader/videommmu.py: the three parquet splits
(Perception/Comprehension/Adaptation; pandas, imported when the data loads),
subject -> domain routing, MCQ + open-ended answer parsing (MMMU-official
semantics), and per-subdomain / per-domain instruction-level accuracy.

An Adaptation item's query image (the ``image`` struct's PNG or JPEG bytes)
is decoded to an HWC uint8 RGB array by ``data.video.decode_image``, as PIL's
``to_rgb`` makes it, where the JAX package opens it with PIL.
"""

from __future__ import annotations

import os
import re
import sys
from collections import defaultdict
from typing import Any

from ...data.video import decode_image
from ..mcq import get_multi_choice_info, parse_multi_choice_response

CATEGORIES = ["Perception", "Comprehension", "Adaptation"]

THINK_PROMPT = (
    "You must first think about the reasoning process in the mind and then provide the user "
    "with the answer. The reasoning process and answer are enclosed within <think> </think> "
    "and <answer> </answer> tags, respectively. All reasoning must be grounded in visual "
    "evidence from the video. When you mention any related object, person, or specific visual "
    "element, you must strictly follow the following format: "
    "`<obj>object_name</obj><box>bounding_box</box>at<t>time_in_seconds</t>s`. The reasoning "
    "process MUST NOT be longer than 100 words. In the answer part, respond with only the "
    "letter of the correct option."
)

DOMAIN_CAT2SUB_CAT = {
    "Art and Design": ["Art", "Art_Theory", "Design", "Music"],
    "Business": ["Accounting", "Economics", "Finance", "Manage", "Marketing"],
    "Science": ["Biology", "Chemistry", "Geography", "Math", "Physics"],
    "Health and Medicine": [
        "Basic_Medical_Science", "Clinical_Medicine",
        "Diagnostics_and_Laboratory_Medicine", "Pharmacy", "Public_Health",
    ],
    "Humanities and Social Science": ["History", "Literature", "Sociology", "Psychology"],
    "Tech and Engineering": [
        "Agriculture", "Architecture_and_Engineering", "Computer_Science",
        "Electronics", "Energy_and_Power", "Materials", "Mechanical_Engineering",
    ],
}


def get_cache_dir(subject: str) -> str:
    """Subject -> storage domain directory (reference: 98-126)."""
    for domain, subjects in {
        "Art": ["Art", "Art_Theory", "Design", "Music"],
        "Science": ["Biology", "Chemistry", "Geography", "Math", "Physics"],
        "Humanities": ["History", "Literature", "Sociology", "Psychology"],
        "Engineering": [
            "Agriculture", "Architecture_and_Engineering", "Computer_Science",
            "Electronics", "Energy_and_Power", "Materials", "Mechanical_Engineering",
        ],
        "Medicine": [
            "Basic_Medical_Science", "Clinical_Medicine",
            "Diagnostics_and_Laboratory_Medicine", "Pharmacy", "Public_Health",
        ],
        "Business": ["Accounting", "Economics", "Finance", "Manage", "Marketing"],
    }.items():
        if subject in subjects:
            return domain
    raise ValueError(f"Subject {subject} not recognized.")


def parse_options(options) -> str:
    letters = [chr(ord("A") + i) for i in range(len(options))]
    if all(opt.startswith(f"{letter}.") for opt, letter in zip(options, letters)):
        return "\n".join(options)
    return "\n".join(f"{letter}. {opt}" for letter, opt in zip(letters, options))


def doc_to_visual(doc: dict, data_dir: str):
    """(reference: videoperception_doc_to_visual, 129-152)"""
    subject = "_".join(doc["id"].split("_")[1:-1])
    video_path = os.path.join(data_dir, get_cache_dir(subject), doc["id"] + ".mp4")
    if not os.path.exists(video_path):
        sys.exit(f"video path:{video_path} does not exist, please check")
    image = None
    if "image" in doc and doc["image"] is not None:
        image = decode_image(doc["image"]["bytes"])
    return [video_path], [image]


def doc_to_text(doc: dict, think_mode: bool = False) -> list[str]:
    """(reference: videommmu_doc_to_text, 74-95)"""
    question = doc["question"] + "\n" + parse_options(doc["options"])
    text = question + "\nQuestion Category:" + doc["category"]
    if doc["category"] in ("Perception", "Comprehension"):
        text += "\nPlease ignore the Quiz question in last frame of the video."
    elif doc["category"] == "Adaptation":
        text += (
            "\nYou should watch and learn the video content. Then apply what you learned to "
            "the question. Some key information of the question is in the input image."
        )
    if think_mode:
        text += "\n" + THINK_PROMPT
    return [text]


class VideoMMMUBench:
    """Three parquet splits -> (video_paths, image_input, text_input, docs)
    (reference: VideoMMMU_Bench, 12-67)."""

    def __init__(self, data_dir: str, add_asr: bool = False, asr_dir=None, think_mode: bool = False):
        self.data_dir = data_dir
        self.category = list(CATEGORIES)
        self.think_mode = think_mode
        print("think mode:", self.think_mode)

    def get_data(self):
        import pandas as pd

        print("Loading data...")
        video_paths, image_input, text_input, all_docs = [], [], [], []
        for category in self.category:
            path = os.path.join(self.data_dir, category, "test-00000-of-00001.parquet")
            df = pd.read_parquet(path)
            for _, row in df.iterrows():
                doc = row.to_dict()
                doc["category"] = category
                all_docs.append(doc)
                vp, img = doc_to_visual(doc, self.data_dir)
                txt = doc_to_text(doc, think_mode=self.think_mode)
                video_paths.extend(vp)
                image_input.extend(img)
                text_input.extend(txt)
        print(f"Data loaded: {len(all_docs)}")
        return video_paths, image_input, text_input, all_docs

    def cal_category_acc(self, metrics):
        for name in self.category:
            chunk = [m for m in metrics if m["category"] == name]
            print(f"{name} Number:", len(chunk))
            print(f"{name} Acc:", aggregate_results(chunk))


# ---------------------------------------------------------------------------
# MMMU-official answer evaluation (reference: 392-693)
# ---------------------------------------------------------------------------


def extract_subset_name(input_string: str) -> str:
    split = input_string.split("_")[0]
    match = re.compile(rf"^{split}_(.+?)_\d+$").search(input_string)
    if match:
        return match.group(1)
    raise ValueError(f'No match found in "{input_string}"')


def extract_numbers(string: str) -> list[str]:
    pattern_commas = r"-?\b\d{1,3}(?:,\d{3})+\b"
    pattern_scientific = r"-?\d+(?:\.\d+)?[eE][+-]?\d+"
    pattern_simple = r"-?(?:\d+\.\d+|\.\d+|\d+\b)(?![eE][+-]?\d+)(?![,\d])"
    return (
        re.findall(pattern_commas, string)
        + re.findall(pattern_scientific, string)
        + re.findall(pattern_simple, string)
    )


def check_is_number(string: str) -> bool:
    try:
        float(string.replace(",", ""))
        return True
    except ValueError:
        return False


def normalize_str(string: str):
    string = string.strip()
    if check_is_number(string):
        return [round(float(string.replace(",", "")), 2)]
    string = string.lower()
    if len(string) == 1:
        return [" " + string, string + " "]
    return [string]


INDICATORS_OF_KEYS = [
    "could be ", "so ", "is ", "thus ", "therefore ", "final ", "answer ",
    "result ", "are ", "in total ", "total ", "identify ", "recognize ",
    "calculated as ", "counted as ", "measured as ", "observed as ",
    "concluded as ", "found to be ", "equals ", "determined to be ",
    "number of ", "value is ", "adds up to ", "have ", "has ",
]


def parse_open_response(response: str):
    """Extract candidate answers from free-form text (reference: 583-676)."""
    if response == "API Error" or response == "":
        return "API Error"

    def get_key_subresponses(response):
        response = response.strip().strip(".").lower()
        sub_responses = re.split(r"\.\s(?=[A-Z])|\n", response)
        key_responses = []
        for index, resp in enumerate(sub_responses):
            indicators = list(INDICATORS_OF_KEYS)
            if index == len(sub_responses) - 1:
                indicators.append("=")
            shortest = None
            for indicator in indicators:
                if indicator in resp:
                    tail = resp.split(indicator)[-1].strip()
                    if shortest is None or len(tail) < len(shortest):
                        shortest = tail
            if shortest and shortest.strip() not in [":", ",", ".", "!", "?", ";", "'"]:
                key_responses.append(shortest)
        return key_responses or [response]

    key_responses = get_key_subresponses(response)
    pred_list = key_responses.copy()
    for resp in key_responses:
        pred_list.extend(extract_numbers(resp))
    out = []
    for p in pred_list:
        out.extend(normalize_str(p))
    return list(set(out))


def eval_multi_choice(gold, pred) -> bool:
    if isinstance(gold, list):
        return any(answer == pred for answer in gold)
    return gold == pred


def eval_open(gold, pred_list) -> bool:
    if isinstance(gold, list):
        norm_answers = []
        for answer in gold:
            norm_answers.extend(normalize_str(answer))
    else:
        norm_answers = normalize_str(gold)
    for pred in pred_list:
        if isinstance(pred, str):
            for norm_ans in norm_answers:
                if isinstance(norm_ans, str) and norm_ans in pred:
                    return True
        elif pred in norm_answers:
            return True
    return False


def evaluate_mmmu(samples):
    pred_correct = 0
    judge_dict = {}
    for sample in samples:
        gold, pred = sample["answer"], sample["parsed_pred"]
        if sample["question_type"] in ("multiple-choice", "perception"):
            correct = eval_multi_choice(gold, pred)
        else:
            correct = eval_open(gold, pred)
        judge_dict[sample["id"]] = "Correct" if correct else "Wrong"
        pred_correct += correct
    if len(samples) == 0:
        return {"acc": 0}
    return judge_dict, {"acc": pred_correct / len(samples)}


def process_results(doc: dict, pred: str) -> dict[str, Any]:
    question_type = doc.get("question_type", "None")
    if question_type == "multiple-choice":
        index2ans, all_choices = get_multi_choice_info(doc["options"])
        parsed_pred = parse_multi_choice_response(pred, all_choices, index2ans)
    else:
        parsed_pred = parse_open_response(pred)
    return {
        "id": doc["id"],
        "category": doc["category"],
        "subdomain": extract_subset_name(doc["id"]),
        "question_type": question_type,
        "answer": doc["answer"],
        "parsed_pred": parsed_pred,
    }


def calculate_ins_level_acc(results) -> float:
    acc, n = 0.0, 0
    for cat in results.values():
        acc += cat["acc"] * cat["num_example"]
        n += cat["num_example"]
    return acc / n if n else 0


def aggregate_results(results: list[dict]) -> float:
    """Per-subdomain then per-domain instruction-level accuracy
    (reference: videoperception_aggregate_results, 238-286)."""
    evaluation_result = {}
    subset_to_samples = defaultdict(list)
    for r in results:
        if r["parsed_pred"] != "API Error":
            subset_to_samples[r["subdomain"]].append(r)
    for subset, samples in subset_to_samples.items():
        _, metric = evaluate_mmmu(samples)
        metric["num_example"] = len(samples)
        evaluation_result[subset] = metric

    printable = {}
    for domain, sub_cats in DOMAIN_CAT2SUB_CAT.items():
        in_domain = {c: evaluation_result[c] for c in sub_cats if c in evaluation_result}
        printable["Overall-" + domain] = {
            "num": int(sum(c["num_example"] for c in in_domain.values())),
            "acc": round(calculate_ins_level_acc(in_domain), 5),
        }
        for cat_name, cat_results in in_domain.items():
            printable[cat_name] = {
                "num": int(cat_results["num_example"]),
                "acc": round(cat_results["acc"], 5),
            }
    printable["Overall"] = {
        "num": sum(c["num_example"] for c in evaluation_result.values()),
        "acc": round(calculate_ins_level_acc(evaluation_result), 5),
    }
    print(printable)
    return printable["Overall"]["acc"]
