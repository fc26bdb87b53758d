"""Training: the SFT step (full fine-tune) of the JAX package's
``train/sft.py``; GSPO (``gspo``), LoRA (``lora``), checkpoints
(``checkpoint``) and the GSPO entry point (``grpo_main``) are modules of
their own."""

from .sft import (
    IGNORE_INDEX,
    ClipAdamW,
    SFTConfig,
    loss_and_grads,
    make_optimizer,
    make_train_step,
    mask_labels,
    sft_loss,
)

__all__ = [
    "IGNORE_INDEX",
    "ClipAdamW",
    "SFTConfig",
    "loss_and_grads",
    "make_optimizer",
    "make_train_step",
    "mask_labels",
    "sft_loss",
]
