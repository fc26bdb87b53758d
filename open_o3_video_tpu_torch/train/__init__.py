"""Training: the SFT step (full fine-tune) of the JAX package's
``train/sft.py``."""

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
