"""Evaluation on the port: the LLM judge."""

from .judge import JUDGE_SYSTEM_PROMPT, JUDGE_TEMPLATE, EngineJudge

__all__ = ["EngineJudge", "JUDGE_SYSTEM_PROMPT", "JUDGE_TEMPLATE"]
