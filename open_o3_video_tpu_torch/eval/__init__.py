"""Evaluation on the port: the V-STAR, TVGBench, VideoMME, WorldSense and
VideoMMMU harnesses (the last three over ``dataloaders/``), the N-path MCQ
core with test-time-scaling votes, the engine-backed model wrapper, the LLM
judge and V-STAR scoring, behind ``python -m open_o3_video_tpu_torch.eval.cli``."""

from .judge import JUDGE_SYSTEM_PROMPT, JUDGE_TEMPLATE, EngineJudge, evaluate_json, print_stats
from .mcq_harness import evaluate_mcq_items_batched, iter_mcq_item_batches
from .model_engine import QwenVLEngine

__all__ = [
    "EngineJudge",
    "JUDGE_SYSTEM_PROMPT",
    "JUDGE_TEMPLATE",
    "QwenVLEngine",
    "evaluate_json",
    "evaluate_mcq_items_batched",
    "iter_mcq_item_batches",
    "print_stats",
]
