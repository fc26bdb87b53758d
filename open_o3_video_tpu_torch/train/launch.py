"""What the training entry points (``sft_main``, ``grpo_main``) refuse
before they load anything: a mesh or a multi-process launch (the port
trains on one device; ROADMAP M8), and the CPU unless asked for it."""

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
