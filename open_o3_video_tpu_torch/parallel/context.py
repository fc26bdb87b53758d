"""Context (sequence) parallelism for long-context forwards (counterpart of
``open_o3_video_tpu/parallel/context.py``).

The sequence is cut over a ``context`` axis (``make_mesh(context=n)``), so
activations and attention work scale 1/n per rank, with exact ring
attention (``ops/ring_attention.py``) rotating the KV blocks. One process
per rank: every rank passes the whole batch's inputs and computes its own
contiguous block of S / n positions; everything in a decoder layer but
attention is position-local, so only the ring communicates. The params
keep their ``fsdp``/``tensor`` placement (``shard_params`` output) or are
whole; either way they are the same on every rank of the axis.

Use cases: scoring and prefill of 16k+ token sequences (GSPO's logps, long
VideoMME prompts), where one card's activations would not fit or the
quadratic attention dominates.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.qwen25vl.text import logits_from_hidden, text_forward
from ..ops.ring_attention import RingImpl


def _block(x: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    per = x.shape[dim] // n
    return x.narrow(dim, r * per, per)


def cp_text_forward(
    text_params: dict,
    text_cfg,
    inputs_embeds: torch.Tensor,  # (B, S, D), the whole sequence
    position_ids: torch.Tensor,  # (3, B, S) M-RoPE positions
    mesh,
    *,
    attn_valid: Optional[torch.Tensor] = None,  # (B, S) validity (left padding)
    remat: bool = False,
    axis: str = "context",
    impl: str = "auto",
) -> torch.Tensor:
    """Sequence-sharded decoder forward: this rank's block (B, S / n, D) of
    the final hidden states. ``text_forward`` runs on the block with a ring
    ``attn_impl`` and the block's GLOBAL sequence positions (the default
    ``arange`` would restart per block). ``impl`` picks every kernel's
    version ("auto" or "torch", the ring's included)."""
    B, S, _ = inputs_embeds.shape
    n, r = mesh.shape[axis], mesh.rank(axis)
    assert S % n == 0, f"sequence length {S} must divide context={n}"
    seq = torch.arange(S, device=inputs_embeds.device).expand(B, S)
    if attn_valid is None:
        attn_valid = torch.ones((B, S), dtype=torch.bool, device=inputs_embeds.device)
    hidden, _ = text_forward(
        text_params, text_cfg, _block(inputs_embeds, 1, n, r), _block(position_ids, 2, n, r),
        seq_positions=_block(seq, 1, n, r), attn_valid=_block(attn_valid, 1, n, r),
        remat=remat, attn_impl=RingImpl(mesh.groups[axis], impl))
    return hidden


def cp_per_token_logps(
    text_params: dict,
    text_cfg,
    inputs_embeds: torch.Tensor,  # (B, S, D)
    position_ids: torch.Tensor,  # (3, B, S)
    target_ids: torch.Tensor,  # (B, S) the token at each position
    mesh,
    *,
    attn_valid: Optional[torch.Tensor] = None,
    axis: str = "context",
    impl: str = "auto",
) -> torch.Tensor:
    """log p(target_ids[t] | tokens <= t), (B, S) float32, with the compute
    sequence-sharded: the (B, S, vocab) logits exist only as each rank's
    (B, S / n, vocab) block; the (B, S / n) log-probabilities are gathered
    over the axis (under autograd each rank keeps its block's gradient). As
    the reference's ``_get_per_token_logps``, position t scores the token AT
    t; callers shift by one."""
    n, r = mesh.shape[axis], mesh.rank(axis)
    hidden = cp_text_forward(text_params, text_cfg, inputs_embeds, position_ids, mesh,
                             attn_valid=attn_valid, axis=axis, impl=impl)
    logp = torch.log_softmax(logits_from_hidden(text_params, hidden, impl), dim=-1)
    mine = torch.gather(logp, -1, _block(target_ids, 1, n, r)[..., None])[..., 0]
    return mesh.all_gather(mine, axis, dim=1)
