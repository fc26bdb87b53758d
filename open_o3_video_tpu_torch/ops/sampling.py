"""Token sampling: greedy / temperature / top-p, repetition penalty
(counterpart of ``open_o3_video_tpu/ops/sampling.py``).

Semantics match the JAX package exactly: the penalty divides positive and
multiplies negative logits of seen tokens (vLLM convention); top-p keeps the
smallest prefix of the sorted vocabulary whose mass reaches top_p, by value,
so ties with the threshold logit survive. The full sort is cheap on the
card; the JAX package's top-512 shortcut exists for the TPU.
"""

from __future__ import annotations

from typing import Optional

import torch


def apply_repetition_penalty(logits: torch.Tensor, seen_mask: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """logits (B, V); seen_mask (B, V) bool: token appeared in prompt/output."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen_mask, penalized, logits)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Set logits outside the nucleus to -inf (the top token always stays)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cumprobs = torch.cumsum(sorted_probs, dim=-1)
    keep = (cumprobs - sorted_probs) < top_p  # mass before this position
    kept = torch.where(keep, sorted_logits, float("inf"))
    threshold = kept.amin(dim=-1, keepdim=True)
    return torch.where(logits >= threshold, logits, float("-inf"))


def sample_token(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,  # (B, V) float32
    *,
    temperature: float = 1.0,
    top_p: float = 1.0,
    seen_mask: Optional[torch.Tensor] = None,
    repetition_penalty: float = 1.0,
) -> torch.Tensor:
    """Next token ids (B,). temperature == 0 is greedy argmax (first index
    among ties); otherwise a categorical draw from ``generator``: the
    exponential race argmax(p / q), q ~ Exp(1), which is the one-sample path
    of ``torch.multinomial`` (the same draws at the same generator state).
    Its check of the probabilities (no inf, NaN or negative value) is made
    on the device, so no value is read back to the host and a CUDA graph
    can hold the draw: a failed check raises on the CPU and is a
    device-side assert on the card."""
    if seen_mask is not None and repetition_penalty != 1.0:
        logits = apply_repetition_penalty(logits, seen_mask, repetition_penalty)
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_p < 1.0:
        logits = top_p_filter(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    torch._assert_async((probs.max() < float("inf")) & (probs.min() >= 0))
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1)
