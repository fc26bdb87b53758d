"""What the training entry points (``sft_main``, ``grpo_main``) refuse
before they load anything: a mesh or a multi-process launch (the port
trains on one device; ROADMAP M8), the CPU unless asked for it, and a
checkpoint whose patch their processor cannot cut (Qwen3-VL)."""

from __future__ import annotations

import torch


def check_one_device(args, prog: str) -> None:
    """Refuse a mesh or a multi-process launch. A fsdp of -1 (all devices)
    is one device here."""
    if args.mesh_data != 1 or args.mesh_tensor != 1 or args.mesh_fsdp not in (-1, 1):
        raise SystemExit(f"{prog}: a mesh (data={args.mesh_data}, fsdp={args.mesh_fsdp}, "
                         f"tensor={args.mesh_tensor}) is not ported yet; run on one device")
    if args.coordinator_address or (args.num_processes or 1) > 1 or (args.process_id or 0) != 0:
        raise SystemExit(f"{prog}: multi-process training is not ported yet; run one process")


def train_device(args, prog: str) -> torch.device:
    """``--device``: the card by default; the CPU only when asked for."""
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device; pass --device cpu to train on the CPU")
    return torch.device(args.device)


# The apps build their processor as the JAX package's apps do,
# ``O3VideoProcessor.from_pretrained`` at its default patch of 14, and read
# media at multiples of 28 (``data/video.py``).
APP_PATCH_SIZE = 14


def check_app_patch(cfg, prog: str) -> None:
    """Refuse a checkpoint whose vision patch is not the apps' processor's
    (Qwen3-VL's 16: a frame read at a multiple of 28 has no whole grid of
    16-pixel patches). ``train.make_train_step``, ``make_lora_train_step``
    and ``GSPOTrainer`` train Qwen3-VL on batches patchified at 16."""
    patch = cfg.vision.patch_size
    if patch != APP_PATCH_SIZE:
        raise NotImplementedError(
            f"{prog}: {cfg.model_type} has a vision patch of {patch}, and this app's processor "
            f"and video reader cut frames for patch {APP_PATCH_SIZE} (multiples of 28), as the "
            "JAX package's do (ROADMAP Queue 3); train it through train.make_train_step, "
            "make_lora_train_step or gspo.GSPOTrainer on inputs patchified at its patch")
