"""What the training entry points (``sft_main``, ``grpo_main``) decide
before they load anything: the device (the CPU only when asked for), the
mesh, and a checkpoint whose patch their processor cannot cut (Qwen3-VL)."""

from __future__ import annotations

import torch


def train_mesh(args, prog: str):
    """The apps' mesh, as JAX's: none for an explicit 1 x 1 x 1 (unsharded
    even beside other processes); on several processes, or with
    ``--mesh_tensor``/``--mesh_fsdp`` above 1, ``make_hybrid_mesh`` over the
    initialized process group; else none. A launch whose processes did not
    start (``--num_processes`` without a coordinator) or whose mesh does not
    match the world size raises SystemExit."""
    from ..parallel import distributed as D

    world = D.process_count()
    if world == 1 and ((args.num_processes or 1) > 1 or (args.coordinator_address
                                                          and args.num_processes is None)):
        raise SystemExit(f"{prog}: multi-process training did not start: give "
                         "--coordinator_address with --num_processes and --process_id, or "
                         "launch with torchrun")
    if args.mesh_data == 1 and args.mesh_fsdp == 1 and args.mesh_tensor == 1:
        return None
    ranks = args.mesh_data * args.mesh_tensor * max(args.mesh_fsdp, 1)
    if (world % ranks) if args.mesh_fsdp == -1 else ranks != world:
        raise SystemExit(f"{prog}: a mesh of data={args.mesh_data}, fsdp={args.mesh_fsdp}, "
                         f"tensor={args.mesh_tensor} needs {ranks} processes; the world size is "
                         f"{world} (torchrun --nproc_per_node)")
    if world > 1 or args.mesh_tensor > 1 or args.mesh_fsdp > 1:
        return D.make_hybrid_mesh(data=args.mesh_data, fsdp=args.mesh_fsdp,
                                  tensor=args.mesh_tensor)
    return None


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
