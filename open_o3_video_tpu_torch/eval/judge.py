"""LLM judge and V-STAR scoring (counterpart of
``open_o3_video_tpu/eval/judge.py``; the reference's eval/test/eval_vstar.py):
a text-only decoder rates a candidate answer 0-3 against the ground truth,
and ``evaluate_json`` scores a V-STAR results file: tIoU, AP and mIoU of both
chains and the AM/LGM/mAM/mLGM composites, overall and by duration and
domain (``print_stats``).

The reference spreads Qwen2.5-72B-Instruct over 4 GPUs. Here the judge runs
on the port's engine on one card: with ``load_in_int4`` its decoder is
group-128 int4 (about 40 GB at 72B) and every decoder matmul is K7.
Greedy decoding, repetition penalty 1.0. With ``mesh`` the judge is
sharded over a tensor-parallel mesh of cards, as the reference's 4 GPUs.
"""

from __future__ import annotations

import json
import math
from typing import Any, Callable

import numpy as np
import torch

from ..data.processor import O3VideoProcessor
from ..engine import InferenceEngine, Request, SamplingParams
from ..grounding.tags import refined_timestamps
from ..models.qwen25vl import params as P
from .metrics_vstar import duration_bucket, spatial_metrics, spatial_random_baseline, temporal_iou

JUDGE_SYSTEM_PROMPT = """
As an AI assistant, your task is to evaluate a candidate answer in comparison to a given correct answer.
The question itself, the correct 'groundtruth' answer, and the candidate answer will be provided to you.
Your assessment should range from 0 to 3, \
based solely on the semantic similarity between the groundtruth and the candidate answer, \
disregarding any grammatical differences.
A rating of 0 suggests no similarity, implying the candidate answer is entirely incorrect.
A rating of 1 suggests low similarity, meaning the candidate answer is largely incorrect.
A rating of 2 suggests high similarity, meaning the candidate answer is largely correct.
Lastly, a rating of 3 indicates complete similarity, which means the candidate answer is entirely correct.
Your response should be a single integer from 0, 1, 2, or 3.
"""

JUDGE_TEMPLATE = "Question: {}\nGroundtruth answer: {}\nCandidate answer: {}\nYour response: "

# The reference judge's published config.json (Qwen/Qwen2.5-72B-Instruct), as
# Qwen25VLConfig.from_hf_dict reads it: a text-only "qwen2" decoder.
QWEN25_72B_INSTRUCT_CONFIG = {
    "architectures": ["Qwen2ForCausalLM"],
    "attention_dropout": 0.0,
    "bos_token_id": 151643,
    "eos_token_id": 151645,
    "hidden_act": "silu",
    "hidden_size": 8192,
    "initializer_range": 0.02,
    "intermediate_size": 29568,
    "max_position_embeddings": 32768,
    "max_window_layers": 70,
    "model_type": "qwen2",
    "num_attention_heads": 64,
    "num_hidden_layers": 80,
    "num_key_value_heads": 8,
    "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0,
    "sliding_window": 131072,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
    "use_cache": True,
    "use_sliding_window": False,
    "vocab_size": 152064,
}


class EngineJudge:
    """Text-only judge backed by the inference engine (greedy, 512 tokens).
    ``batch`` makes one engine call, which streams its jobs through the
    engine's decode slots (8), so a whole results file does not become one
    batch."""

    def __init__(self, model_dir_or_params, mesh=None, max_new_tokens: int = 512, *, cfg=None,
                 processor=None, load_in_int8: bool = False, load_in_int4: bool = False,
                 device=None):
        """A model directory loads with its tokenizer onto ``device`` (default
        ``cuda``), its decoder quantized as it streams in when
        ``load_in_int4`` (group-128 int4) or ``load_in_int8`` is set; a
        param dict needs its ``cfg`` and is served where it lies; on a
        ``mesh`` each rank keeps its shard (the reference's 72B judge on 4
        GPUs: ``make_mesh(tensor=4)``)."""
        if isinstance(model_dir_or_params, str):
            params, cfg = P.load_pretrained(
                model_dir_or_params, torch.device(device or "cuda"),
                quantize_text="int4" if load_in_int4 else load_in_int8,
            )
            processor = processor or O3VideoProcessor.from_pretrained(model_dir_or_params)
        else:
            params = model_dir_or_params
            if cfg is None:
                raise ValueError("cfg is required when passing a param dict")
            processor = processor or O3VideoProcessor()
        self.cfg = cfg
        self.processor = processor
        self.engine = InferenceEngine(params, cfg, mesh=mesh)
        self.sampling = SamplingParams(temperature=0.0, repetition_penalty=1.0,
                                       max_tokens=max_new_tokens)

    def _request(self, question: str, gt: str, candidate: str) -> Request:
        messages = [
            {"role": "system", "content": JUDGE_SYSTEM_PROMPT},
            {"role": "user", "content": JUDGE_TEMPLATE.format(question, gt, candidate)},
        ]
        text = self.processor.apply_chat_template(messages, add_generation_prompt=True)
        return Request(input_ids=self.processor.tokenizer.encode(text))

    @staticmethod
    def _parse(response: str) -> int:
        try:
            return int(response)
        except (ValueError, TypeError):
            return -1

    def __call__(self, question: str, gt: str, candidate: str) -> int:
        out = self.engine.generate([self._request(question, gt, candidate)], self.sampling)[0]
        return self._parse(self.processor.decode(out["token_ids"], skip_special_tokens=True))

    def batch(self, jobs: list[tuple[str, str, str]]) -> list[int]:
        """Rate many (question, gt, candidate) triplets in one engine call."""
        outs = self.engine.generate([self._request(*job) for job in jobs], self.sampling)
        return [
            self._parse(self.processor.decode(o["token_ids"], skip_special_tokens=True))
            for o in outs
        ]


def _empty_stats() -> dict[str, Any]:
    return {
        "all_rating": [], "valid_rating": [], "correct_num": 0,
        "temporal_ious": [], "temporal_ious_2": [],
        "spatial_aps": [[] for _ in range(5)], "spatial_aps_2": [[] for _ in range(5)],
        "spatial_mious": [], "spatial_mious_2": [],
        "random_tious": [], "random_aps": [[] for _ in range(5)], "random_vious": [],
        "combined": {key: [] for key in (
            "vqa_temporal_idx", "vqa_spatial_idx", "temporal_spatial_idx", "vqa_temp_spatial_idx",
            "vqa_temporal_idx_2", "vqa_spatial_idx_2", "temporal_spatial_idx_2", "vqa_temp_spatial_idx_2",
        )},
    }


def evaluate_json(
    file_path: str,
    judge: Callable[[str, str, str], int],
    *,
    log=print,
) -> dict[str, Any]:
    """Score a V-STAR inference dump (reference: evaluate_json, 201-429).

    Returns the overall stats block; per-duration and per-domain blocks are
    printed via ``log`` and included under 'durations'/'domains'.
    """
    with open(file_path) as f:
        data = json.load(f)

    # Pass 1: batch-score every VQA answer when the judge supports it.
    vqa_scores: dict[int, int] = {}
    if hasattr(judge, "batch"):
        jobs, job_idx = [], []
        for idx, item in enumerate(data):
            if item.get("answer_vqa"):
                jobs.append((item["question"], item["answer"], item["answer_vqa"]))
                job_idx.append(idx)
        for idx, score in zip(job_idx, judge.batch(jobs)):
            vqa_scores[idx] = score

    overall = _empty_stats()
    durations: dict[str, dict] = {}
    domains: dict[str, dict] = {}

    for idx, item in enumerate(data):
        video_length = round(item["frame_count"] / item["fps"], 2)
        w, h = item["width"], item["height"]
        domain = item.get("domain", "unknown")
        domains.setdefault(domain, _empty_stats())
        bucket = duration_bucket(video_length)
        durations.setdefault(bucket, _empty_stats())
        groups = (overall, domains[domain], durations[bucket])

        if not item.get("answer_vqa"):
            continue
        score = (
            vqa_scores[idx]
            if idx in vqa_scores
            else judge(item["question"], item["answer"], item["answer_vqa"])
        )
        for g in groups:
            g["all_rating"].append(score if score != -1 else 0)
            if score != -1:
                g["valid_rating"].append(score)
            if score >= 2:
                g["correct_num"] += 1
        item["VQA_score"] = score

        # Chain 1 temporal
        if item["answer_temporal"] == []:
            item["answer_temporal"] = refined_timestamps(item["answer_temporal_pre"])
        t_iou = temporal_iou(item["timestamps"], item["answer_temporal"]) if item.get("answer_temporal") else 0.0
        for g in groups:
            g["temporal_ious"].append(t_iou)
        item["temporal_IoU"] = t_iou

        # Chain 2 temporal
        if item["answer_temporal_2"] == []:
            item["answer_temporal_2"] = refined_timestamps(item["answer_temporal_pre_2"])
        t_iou2 = temporal_iou(item["timestamps"], item["answer_temporal_2"]) if item.get("answer_temporal_2") else 0.0
        for g in groups:
            g["temporal_ious_2"].append(t_iou2)
        item["temporal_IoU_2"] = t_iou2

        random_iou = temporal_iou(item["timestamps"], [0, video_length])
        for g in groups:
            g["random_tious"].append(random_iou)

        # Chain 1 spatial
        aps, miou = (
            spatial_metrics(item["bboxes"], item["answer_spatial"])
            if item.get("answer_spatial")
            else ([0.0] * 5, 0.0)
        )
        for g in groups:
            for i, ap in enumerate(aps):
                g["spatial_aps"][i].append(ap)
            g["spatial_mious"].append(miou)
        item["AP1@0.1:0.9"] = aps
        item["spatial_mIoU"] = miou

        # Chain 2 spatial
        aps2, miou2 = (
            spatial_metrics(item["bboxes"], item["answer_spatial_2"])
            if item.get("answer_spatial_2")
            else ([0.0] * 5, 0.0)
        )
        for g in groups:
            for i, ap in enumerate(aps2):
                g["spatial_aps_2"][i].append(ap)
            g["spatial_mious_2"].append(miou2)
        item["AP2@0.1:0.9"] = aps2
        item["spatial_mIoU_2"] = miou2

        random_aps, random_miou = spatial_random_baseline(
            [{str(b["timestamp"]): {k: b[k] for k in ("xmin", "ymin", "xmax", "ymax")}} for b in item["bboxes"]],
            w, h,
        )
        for g in groups:
            for i, ap in enumerate(random_aps):
                g["random_aps"][i].append(ap)
            g["random_vious"].append(random_miou)

        # combined-success index lists (reference: 329-360)
        combos = [
            ("vqa_temporal_idx", score >= 2 and t_iou >= 0.3),
            ("vqa_temporal_idx_2", score >= 2 and t_iou2 >= 0.3),
            ("vqa_spatial_idx", score >= 2 and miou >= 0.1),
            ("vqa_spatial_idx_2", score >= 2 and miou2 >= 0.1),
            ("temporal_spatial_idx", t_iou >= 0.3 and miou >= 0.1),
            ("temporal_spatial_idx_2", t_iou2 >= 0.3 and miou2 >= 0.1),
            ("vqa_temp_spatial_idx", score >= 2 and t_iou >= 0.3 and miou >= 0.1),
            ("vqa_temp_spatial_idx_2", score >= 2 and t_iou2 >= 0.3 and miou2 >= 0.1),
        ]
        for key, hit in combos:
            if hit:
                for g in groups:
                    g["combined"][key].append(idx)

    summary = print_stats("Overall Statistics", overall, len(data), log=log)
    duration_summaries = {
        k: print_stats(f"Video Length: {k}", stats, len(stats["all_rating"]), log=log)
        for k, stats in durations.items()
    }
    domain_summaries = {
        k: print_stats(f"Domain: {k}", stats, len(stats["all_rating"]), log=log)
        for k, stats in domains.items()
    }
    return {"overall": summary, "durations": duration_summaries, "domains": domain_summaries,
            "scored_items": data}


def print_stats(label: str, stats: dict, total_samples: int, log=print) -> dict[str, float]:
    """Headline numbers for one stats block (reference: print_stats, 362-423)."""
    if total_samples == 0:
        return {}
    avg_all = float(np.mean(stats["all_rating"])) if stats["all_rating"] else 0.0
    avg_valid = float(np.mean(stats["valid_rating"])) if stats["valid_rating"] else 0.0
    acc = stats["correct_num"] / total_samples

    def r1(ious, t):
        return float(np.mean([1 if x >= t else 0 for x in ious])) if ious else 0.0

    mt = float(np.mean(stats["temporal_ious"])) if stats["temporal_ious"] else 0.0
    mt2 = float(np.mean(stats["temporal_ious_2"])) if stats["temporal_ious_2"] else 0.0
    maps = [float(np.mean(x)) if x else 0.0 for x in stats["spatial_aps"]]
    maps2 = [float(np.mean(x)) if x else 0.0 for x in stats["spatial_aps_2"]]
    mv = float(np.mean(stats["spatial_mious"])) if stats["spatial_mious"] else 0.0
    mv2 = float(np.mean(stats["spatial_mious_2"])) if stats["spatial_mious_2"] else 0.0

    log(f"{label}:")
    log(f"VQA: Avg All Score: {avg_all:.4f}, Avg Valid Score: {avg_valid:.4f}, Accuracy: {acc:.4f}")
    log("Chain 1:")
    log(
        f"Temporal Answer: R1@IoU=0.3: {r1(stats['temporal_ious'], 0.3):.4f}, "
        f"R1@IoU=0.5: {r1(stats['temporal_ious'], 0.5):.4f}, "
        f"R1@IoU=0.7: {r1(stats['temporal_ious'], 0.7):.4f}, Mean IoU: {mt:.4f}"
    )
    log(
        f"Spatial Answer: mAP@0.1: {maps[0]:.4f}, mAP@0.3: {maps[1]:.4f}, mAP@0.5: {maps[2]:.4f}, "
        f"mAP@0.7: {maps[3]:.4f}, mAP@0.9: {maps[4]:.4f}, Mean mIoU: {mv:.4f}"
    )
    log("Chain 2:")
    log(
        f"Temporal Answer: R1@IoU=0.3: {r1(stats['temporal_ious_2'], 0.3):.4f}, "
        f"R1@IoU=0.5: {r1(stats['temporal_ious_2'], 0.5):.4f}, "
        f"R1@IoU=0.7: {r1(stats['temporal_ious_2'], 0.7):.4f}, Mean IoU: {mt2:.4f}"
    )
    log(
        f"Spatial Answer: mAP@0.1: {maps2[0]:.4f}, mAP@0.3: {maps2[1]:.4f}, mAP@0.5: {maps2[2]:.4f}, "
        f"mAP@0.7: {maps2[3]:.4f}, mAP@0.9: {maps2[4]:.4f}, Mean mIoU: {mv2:.4f}"
    )

    am1 = (acc + mt + mv) / 3
    am2 = (acc + mt2 + mv2) / 3
    mam = (am1 + am2) / 2

    def log1m(x):
        # Divergence from the reference (flagged): the reference's
        # math.log(1 - x) raises on a perfect sub-metric (possible for
        # single-item domain blocks); we clamp so LGM saturates instead.
        return math.log(max(1 - x, 1e-12))

    lgm1 = -(log1m(acc) + log1m(mt) + log1m(mv)) / 3
    lgm2 = -(log1m(acc) + log1m(mt2) + log1m(mv2)) / 3
    mlgm = (lgm1 + lgm2) / 2
    log(f"AM1:{am1:.4f}, AM2:{am2:.4f}, mAM:{mam:.4f}")
    log(f"LGM1:{lgm1:.4f}, LGM2:{lgm2:.4f}, mLGM:{mlgm:.4f}\n")

    c = stats["combined"]
    log("Combined resutls:")
    log(f"VQA & Temp:  Chain 1: {len(c['vqa_temporal_idx']) / total_samples:.4f}, Chain 2: {len(c['vqa_temporal_idx_2']) / total_samples:.4f}")
    log(f"VQA & Spat: Chain 1: {len(c['vqa_spatial_idx']) / total_samples:.4f} Chain 2: {len(c['vqa_spatial_idx_2']) / total_samples:.4f}")
    log(f"Temp & Spat:  Chain 1: {len(c['temporal_spatial_idx']) / total_samples:.4f} Chain 2: {len(c['temporal_spatial_idx_2']) / total_samples:.4f}")
    log(f"VQA & Temp & Spat:  Chain 1:{len(c['vqa_temp_spatial_idx']) / total_samples:.4f} Chain 2: {len(c['vqa_temp_spatial_idx_2']) / total_samples:.4f}")

    return {
        "acc": acc, "avg_all_rating": avg_all, "avg_valid_rating": avg_valid,
        "mtIoU_1": mt, "mtIoU_2": mt2, "mvIoU_1": mv, "mvIoU_2": mv2,
        "mAP_1": maps, "mAP_2": maps2,
        "AM1": am1, "AM2": am2, "mAM": mam,
        "LGM1": lgm1, "LGM2": lgm2, "mLGM": mlgm,
    }
