"""Batched inference engine of the port."""

from .engine import InferenceEngine, Request, SamplingParams

__all__ = ["InferenceEngine", "Request", "SamplingParams"]
