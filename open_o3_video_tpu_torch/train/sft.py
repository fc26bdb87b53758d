"""SFT trainer: next-token cross-entropy on the <think>/<answer> targets
(counterpart of ``open_o3_video_tpu/train/sft.py``).

A full fine-tune of every weight with the reference recipe: AdamW at lr 1e-6
after a global-norm clip at 1.0, bf16 weights, gradient checkpointing, one
sample per step (``make_train_step``); or PEFT, LoRA adapters over the frozen
base (``make_lora_train_step``). Every family trains through
``models.family_forward``: Qwen2.5-VL, Qwen2-VL, Qwen3-VL and Qwen3-VL-MoE on
``pixel_patches``, Aria on ``pixel_values``. The optimizer reproduces the JAX package's
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

from ..models import family_forward
from ..models.qwen25vl import params as P
from ..models.qwen25vl.text import per_token_logps_from_hidden

IGNORE_INDEX = -100


# The model types a family module reads: the Qwen families'
# (``models/qwen25vl``, Qwen3-VL-MoE's routed experts among them) and Aria's
# (``models/aria``). Every one of them trains.
TRAINED_FAMILIES = ("qwen2_5_vl", "qwen2_vl", "qwen3_vl", "qwen3_vl_moe", "aria")


def require_trainable(cfg) -> None:
    """Raise NotImplementedError on a ``model_type`` that no family module
    reads, ValueError on Kimi-VL, which is served only; every other family
    the port serves trains."""
    model_type = getattr(cfg, "model_type", None)
    if model_type == "kimi_vl":
        raise ValueError("Kimi-VL is served only: the port does not train it")
    if model_type not in TRAINED_FAMILIES:
        raise NotImplementedError(
            f"training model_type {model_type!r}: no model family of the port reads it; "
            "it trains " + ", ".join(TRAINED_FAMILIES))


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


def global_norm(grads: list[torch.Tensor], mesh=None, owned=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in float32 (a 0-d
    tensor on the gradients' device). On a mesh the gradients are this
    rank's shards: only those it ``owned`` (``parallel.mesh.owns``: each
    distinct shard once) are summed, then the sums over the model replica,
    so the norm is the whole tree's, as optax's ``clip_by_global_norm``
    takes it."""
    device = grads[0].device
    if owned is not None:
        grads = [g for g, own in zip(grads, owned) if own]
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32) ** 2 for g in grads]
    # on the gradients' device also where this rank owns none: the clip
    # divides by the norm, and a CUDA tensor divided by a host scalar is
    # multiplied by its reciprocal instead, an ulp off the other ranks
    total = torch.stack(sq).sum() if sq else torch.zeros((), dtype=torch.float32, device=device)
    if mesh is not None:
        total = mesh.replica_sum(total)
    return total.sqrt()


class MeshGrads:
    """What a step on a mesh does after its backward: ``parallel.mesh.
    sync_grads`` over the trained leaves, then their global norm. ``params``
    is the sharded tree (``shard_params``' output)."""

    def __init__(self, mesh, model_cfg, params):
        from ..parallel.mesh import owns, placements

        self.mesh, self.cfg = mesh, model_cfg
        self.where = placements(params)
        self._owns = owns

    def __call__(self, leaves: list[torch.Tensor]) -> torch.Tensor:
        from ..parallel.mesh import sync_grads

        sync_grads(leaves, self.mesh, self.cfg, self.where)
        owned = [self._owns(self.where.get(id(x), ((), ""))[0], self.mesh, self.cfg)
                 for x in leaves]
        return global_norm([x.grad for x in leaves], self.mesh, owned)


def data_total(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the mesh's ``data`` axis (no autograd): the global
    batch's count or metric from this rank's rows."""
    if mesh is None or mesh.shape.get("data", 1) == 1:
        return x
    return mesh._reduce(x.clone(), "data")


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
    model_cfg,
    batch: dict[str, Any],
    *,
    remat: bool = True,
    logp_chunk: Optional[int] = None,
    attn_impl: str = "auto",
    mesh=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Next-token CE over positions whose label != IGNORE_INDEX, through
    ``models.family_forward``. ``batch`` holds numpy arrays or tensors
    (``pack_sft_batch``'s keys; Aria's vision is ``pixel_values``, the Qwen
    families' ``pixel_patches``); ``grid_thw`` and ``vision_token_id`` are
    host metadata.

    JAX's loss is the mean over the global batch's target tokens. On a mesh
    whose ``data`` axis splits the rows, this rank's loss is its rows' sum
    over the global count (summed over ``data`` by ``data_total``), so the
    gradients summed over ``data`` are the global loss's; the returned
    ``loss`` and ``num_target_tokens`` are the global batch's."""
    dev = params["text"]["embed_tokens"].device
    hidden, _ = family_forward(
        params, model_cfg, _tensor(batch["input_ids"], dev), _tensor(batch["position_ids"], dev),
        pixel_patches=_tensor(batch.get("pixel_patches"), dev),
        grid_thw=batch.get("grid_thw"),
        vision_token_id=batch.get("vision_token_id"),
        pixel_values=_tensor(batch.get("pixel_values"), dev),
        vision_row_index=_tensor(batch.get("vision_row_index"), dev),
        attn_valid=_tensor(batch.get("attn_valid"), dev),
        attn_impl=attn_impl, remat=remat, return_hidden=True,
    )
    shift_labels = _tensor(batch["labels"], dev)[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe_labels = torch.where(valid, shift_labels, 0)
    token_logps = per_token_logps_from_hidden(params["text"], hidden[:, :-1], safe_labels,
                                              logp_chunk)
    count = data_total(valid.sum(), mesh)
    loss = torch.where(valid, -token_logps, 0.0).sum() / count.clamp(min=1)
    return loss, {"loss": data_total(loss.detach(), mesh), "num_target_tokens": count}


def loss_and_grads(params: dict, model_cfg, train_cfg: SFTConfig,
                   batch: dict[str, Any], attn_impl: str = "auto",
                   mesh=None) -> dict[str, torch.Tensor]:
    """Forward and backward of one batch: the leaves' ``.grad`` hold the
    gradients afterwards (set, not accumulated). Returns {loss,
    num_target_tokens, grad_norm}. On a mesh ``params`` is
    ``shard_params``' output, ``batch`` this ``data`` rank's rows, and the
    gradients are synchronized (``MeshGrads``)."""
    leaves = [x for x in P.leaves(params) if x.requires_grad]
    for x in leaves:
        x.grad = None
    loss, aux = sft_loss(params, model_cfg, batch, remat=train_cfg.gradient_checkpointing,
                         logp_chunk=train_cfg.logp_chunk, attn_impl=attn_impl, mesh=mesh)
    loss.backward()
    with torch.no_grad():
        for x in leaves:  # a leaf the batch does not reach (a text-only batch's tower)
            if x.grad is None:
                x.grad = torch.zeros_like(x)
    if mesh is None:
        return {**aux, "grad_norm": global_norm([x.grad for x in leaves])}
    return {**aux, "grad_norm": MeshGrads(mesh, model_cfg, params)(leaves)}


def make_train_step(model_cfg, train_cfg: SFTConfig, optimizer: ClipAdamW,
                    attn_impl: str = "auto", mesh=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics), params and
    state updated in place; metrics {loss, num_target_tokens, grad_norm}
    (the norm before the clip), as the JAX package's step returns them.
    With ``mesh`` (JAX's step under a mesh, where GSPMD inserts what this
    writes out): ``params`` are ``shard_params``' local shards, trained in
    place, and ``batch`` is this rank's rows (``sft_main.shard_batch``)."""
    require_trainable(model_cfg)

    def train_step(params, opt_state, batch):
        metrics = loss_and_grads(params, model_cfg, train_cfg, batch, attn_impl, mesh)
        with torch.no_grad():
            optimizer.update(opt_state, metrics["grad_norm"])
        return params, opt_state, metrics

    return train_step


def make_lora_train_step(model_cfg, train_cfg: SFTConfig,
                         optimizer: ClipAdamW, lora_scale: float, attn_impl: str = "auto",
                         mesh=None):
    """(adapters, opt_state, batch, base_params) -> (adapters, opt_state,
    metrics), the PEFT step (the reference's peft_config,
    sft_multi_task.py:479): the base is frozen (``requires_grad`` off on
    every leaf, so no base-sized gradient or optimizer state exists), the
    loss is taken through the base with the adapters grafted on
    (``lora.apply_adapters``), and ``optimizer`` updates the adapters only.
    ``opt_state`` is ``optimizer.init(lora.adapter_leaves(adapters))``.
    Adapters and state are updated in place. With ``mesh`` the base is
    ``shard_params``' output and the adapters whole on every rank (JAX
    replicates them); their gradients are summed where the base product is
    split, and over ``data``."""
    from .lora import adapter_leaves, apply_adapters

    require_trainable(model_cfg)

    def train_step(adapters, opt_state, batch, base_params):
        for x in P.leaves(base_params):
            x.requires_grad_(False)
        leaves = adapter_leaves(adapters)
        for x in leaves:
            x.grad = None
        loss, aux = sft_loss(apply_adapters(base_params, adapters, lora_scale), model_cfg, batch,
                             remat=train_cfg.gradient_checkpointing,
                             logp_chunk=train_cfg.logp_chunk, attn_impl=attn_impl, mesh=mesh)
        loss.backward()
        norm = (global_norm([x.grad for x in leaves]) if mesh is None
                else MeshGrads(mesh, model_cfg, base_params)(leaves))
        metrics = {**aux, "grad_norm": norm}
        with torch.no_grad():
            optimizer.update(opt_state, metrics["grad_norm"])
        return adapters, opt_state, metrics

    return train_step


def shard_batch(batch: dict[str, Any], mesh) -> dict[str, Any]:
    """This ``data`` rank's rows of a host batch (JAX ``sft_main``'s
    ``shard_batch``, which places the global batch over ``data``): every
    row-major array sliced to the rank's block, ``position_ids`` on its
    second axis; ``pixel_patches``/``pixel_values`` stay whole (ragged over
    the rows; ``vision_row_index`` maps each row into them), and the host
    metadata (``grid_thw``, ``vision_token_id``) passes through."""
    n = 1 if mesh is None else mesh.shape.get("data", 1)
    if n == 1:
        return batch
    r = mesh.rank("data")
    out = {}
    for k, v in batch.items():
        if k in ("grid_thw", "vision_token_id", "pixel_patches", "pixel_values") or v is None:
            out[k] = v
        elif k == "position_ids":
            rows = v.shape[1] // n
            out[k] = v[:, r * rows:(r + 1) * rows]
        else:
            rows = v.shape[0] // n
            out[k] = v[r * rows:(r + 1) * rows]
    return out


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
