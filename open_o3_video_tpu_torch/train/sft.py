"""SFT trainer: next-token cross-entropy on the <think>/<answer> targets
(counterpart of ``open_o3_video_tpu/train/sft.py``).

A full fine-tune of every weight with the reference recipe: AdamW at lr 1e-6
after a global-norm clip at 1.0, bf16 weights, gradient checkpointing, one
sample per step (``make_train_step``); or PEFT, LoRA adapters over the frozen
base (``make_lora_train_step``). The optimizer reproduces the JAX package's
``optax.chain(clip_by_global_norm, adamw)``: the clip leaves the gradients
as they are when their global norm is below the maximum, else divides them
by the norm and multiplies by the maximum (not ``clip_grad_norm_``'s
``max / (norm + 1e-6)``); AdamW's state (m and v) is kept in the param
dtype, as optax keeps it, and its update equals optax's (eps outside the
square root, decay applied as lr * wd * p). Everything updates in place:
at 8.3B parameters a temporary copy of the gradients is 16 GB.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from ..models.qwen25vl import params as P
from ..models.qwen25vl.config import Qwen25VLConfig
from ..models.qwen25vl.model import forward
from ..models.qwen25vl.text import per_token_logps_from_hidden

IGNORE_INDEX = -100


@dataclasses.dataclass
class SFTConfig:
    """Defaults mirror the reference's run_sft_video.sh (as the JAX
    package's SFTConfig does)."""

    learning_rate: float = 1e-6
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    max_grad_norm: float = 1.0
    warmup_steps: int = 0
    total_steps: int = 10000
    lr_schedule: str = "constant"  # the reference uses a constant lr for SFT
    gradient_checkpointing: bool = True
    save_steps: int = 500
    logging_steps: int = 1
    # Bound live logits to (B, logp_chunk, vocab) by a chunked, checkpointed
    # lm_head (text.per_token_logps_from_hidden). None = dense.
    logp_chunk: Optional[int] = 512


def learning_rate(cfg: SFTConfig, count: int) -> float:
    """The learning rate of update number ``count`` (0 for the first), as
    the JAX package's optax schedules give it."""
    peak, warm = cfg.learning_rate, cfg.warmup_steps
    if warm and count < warm:
        return peak * count / warm
    if cfg.lr_schedule == "cosine":
        decay = max(cfg.total_steps - warm, 1)
        frac = min(max(count - warm, 0), decay) / decay
        return 0.5 * peak * (1.0 + math.cos(math.pi * frac))
    return peak


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in float32 (a 0-d
    tensor on the gradients' device)."""
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32) ** 2 for g in grads]
    return torch.stack(sq).sum().sqrt()


class ClipAdamW:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(lr, b1, b2,
    eps=1e-8, weight_decay))`` over a list of trainable tensors, or over the
    trainable leaves of a param dict, in place. The hyperparameters are the
    config's fields (``SFTConfig``'s; GSPO gives its own: a clip at 5.0 and
    optax's default weight decay of 1e-4). AdamW is ``torch.optim.AdamW``,
    fused on the card (optax is plain XLA, not a kernel of the JAX
    package)."""

    def __init__(self, cfg: SFTConfig):
        self.cfg = cfg

    def init(self, params) -> dict:
        """State over ``params``: a list of tensors (each trained), or a
        param dict (its leaves with ``requires_grad``)."""
        if isinstance(params, (list, tuple)):
            leaves = list(params)
        else:
            leaves = [x for x in P.leaves(params) if x.requires_grad]
        fused = all(x.is_cuda for x in leaves)
        adamw = torch.optim.AdamW(
            leaves, lr=learning_rate(self.cfg, 0), betas=(self.cfg.adam_b1, self.cfg.adam_b2),
            eps=1e-8, weight_decay=self.cfg.weight_decay,
            **({"fused": True} if fused else {"foreach": False}),
        )
        return {"adamw": adamw, "count": 0}

    def update(self, opt_state: dict, norm: torch.Tensor) -> None:
        """Clip the leaves' gradients, whose global norm is ``norm``, and take
        one AdamW step. The gradients are freed afterwards."""
        adamw = opt_state["adamw"]
        grads = [x.grad for x in adamw.param_groups[0]["params"]]
        keep = norm < self.cfg.max_grad_norm
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * self.cfg.max_grad_norm))
        adamw.param_groups[0]["lr"] = learning_rate(self.cfg, opt_state["count"])
        adamw.step()
        adamw.zero_grad(set_to_none=True)
        opt_state["count"] += 1


def make_optimizer(cfg: SFTConfig) -> ClipAdamW:
    return ClipAdamW(cfg)


def _tensor(x, device):
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else x.to(device)
    return torch.from_numpy(np.asarray(x)).to(device)


def sft_loss(
    params: dict,
    model_cfg: Qwen25VLConfig,
    batch: dict[str, Any],
    *,
    remat: bool = True,
    logp_chunk: Optional[int] = None,
    attn_impl: str = "auto",
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Next-token CE over positions whose label != IGNORE_INDEX. ``batch``
    holds numpy arrays or tensors (``pack_sft_batch``'s keys); ``grid_thw``
    and ``vision_token_id`` are host metadata."""
    dev = params["text"]["embed_tokens"].device
    hidden, _ = forward(
        params, model_cfg, _tensor(batch["input_ids"], dev), _tensor(batch["position_ids"], dev),
        pixel_patches=_tensor(batch.get("pixel_patches"), dev),
        grid_thw=batch.get("grid_thw"),
        vision_token_id=batch.get("vision_token_id"),
        vision_row_index=_tensor(batch.get("vision_row_index"), dev),
        attn_valid=_tensor(batch.get("attn_valid"), dev),
        attn_impl=attn_impl, remat=remat, return_hidden=True,
    )
    shift_labels = _tensor(batch["labels"], dev)[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe_labels = torch.where(valid, shift_labels, 0)
    token_logps = per_token_logps_from_hidden(params["text"], hidden[:, :-1], safe_labels,
                                              logp_chunk)
    count = valid.sum()
    loss = torch.where(valid, -token_logps, 0.0).sum() / count.clamp(min=1)
    return loss, {"loss": loss.detach(), "num_target_tokens": count}


def loss_and_grads(params: dict, model_cfg: Qwen25VLConfig, train_cfg: SFTConfig,
                   batch: dict[str, Any], attn_impl: str = "auto") -> dict[str, torch.Tensor]:
    """Forward and backward of one batch: the leaves' ``.grad`` hold the
    gradients afterwards (set, not accumulated). Returns {loss,
    num_target_tokens, grad_norm}."""
    leaves = [x for x in P.leaves(params) if x.requires_grad]
    for x in leaves:
        x.grad = None
    loss, aux = sft_loss(params, model_cfg, batch, remat=train_cfg.gradient_checkpointing,
                         logp_chunk=train_cfg.logp_chunk, attn_impl=attn_impl)
    loss.backward()
    return {**aux, "grad_norm": global_norm([x.grad for x in leaves])}


def make_train_step(model_cfg: Qwen25VLConfig, train_cfg: SFTConfig, optimizer: ClipAdamW,
                    attn_impl: str = "auto"):
    """(params, opt_state, batch) -> (params, opt_state, metrics), params and
    state updated in place; metrics {loss, num_target_tokens, grad_norm}
    (the norm before the clip), as the JAX package's step returns them."""

    def train_step(params, opt_state, batch):
        metrics = loss_and_grads(params, model_cfg, train_cfg, batch, attn_impl)
        with torch.no_grad():
            optimizer.update(opt_state, metrics["grad_norm"])
        return params, opt_state, metrics

    return train_step


def make_lora_train_step(model_cfg: Qwen25VLConfig, train_cfg: SFTConfig,
                         optimizer: ClipAdamW, lora_scale: float, attn_impl: str = "auto"):
    """(adapters, opt_state, batch, base_params) -> (adapters, opt_state,
    metrics), the PEFT step (the reference's peft_config,
    sft_multi_task.py:479): the base is frozen (``requires_grad`` off on
    every leaf, so no base-sized gradient or optimizer state exists), the
    loss is taken through the base with the adapters grafted on
    (``lora.apply_adapters``), and ``optimizer`` updates the adapters only.
    ``opt_state`` is ``optimizer.init(lora.adapter_leaves(adapters))``.
    Adapters and state are updated in place."""
    from .lora import adapter_leaves, apply_adapters

    def train_step(adapters, opt_state, batch, base_params):
        for x in P.leaves(base_params):
            x.requires_grad_(False)
        leaves = adapter_leaves(adapters)
        for x in leaves:
            x.grad = None
        loss, aux = sft_loss(apply_adapters(base_params, adapters, lora_scale), model_cfg, batch,
                             remat=train_cfg.gradient_checkpointing,
                             logp_chunk=train_cfg.logp_chunk, attn_impl=attn_impl)
        loss.backward()
        metrics = {**aux, "grad_norm": global_norm([x.grad for x in leaves])}
        with torch.no_grad():
            optimizer.update(opt_state, metrics["grad_norm"])
        return adapters, opt_state, metrics

    return train_step


def mask_labels(input_ids: np.ndarray, pad_token_id: int,
                visual_token_ids: tuple[int, ...]) -> np.ndarray:
    """labels = input_ids with pad and visual tokens set to IGNORE_INDEX
    (pass ``data.sft_dataset.visual_mask_ids(cfg)`` for the reference's
    set)."""
    labels = input_ids.copy()
    labels[labels == pad_token_id] = IGNORE_INDEX
    for tok in visual_token_ids:
        labels[labels == tok] = IGNORE_INDEX
    return labels
