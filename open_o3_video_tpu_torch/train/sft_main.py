"""SFT entry point (counterpart of ``open_o3_video_tpu/train/sft_main.py``:
the reference's sft_multi_task.py __main__ + run_sft_video.sh flags).

Usage:
  python -m open_o3_video_tpu_torch.train.sft_main \
      --model_name_or_path /path/Qwen2.5-VL-7B-Instruct \
      --dataset_name /path/STGR-CoT-30k.json \
      --data_root /path/data \
      --output_dir ./checkpoints/sft \
      --learning_rate 1e-6 --num_train_epochs 1 --save_steps 500

The same flags and loop as the JAX entry point: ``--per_device_train_batch_size``
examples a step, packed by ``collate_sft_batch``; a full fine-tune, or LoRA
adapters over the frozen base with ``--use_peft``; a checkpoint every
``--save_steps`` and at the end; ``--resume_from_checkpoint`` continues the
sequential pass where it stopped; then the export (under PEFT, the base with
the adapters merged) and the model card. ``--bf16`` (the default) trains in
bfloat16; ``--bf16 false`` keeps the checkpoint's stored dtype.

A batch whose collate fails on its data (a missing or corrupt file, a bad
example: OSError, ValueError, KeyError) is skipped, and an epoch that skips
every batch raises. Anything else propagates: a missing media reader
(ImportError), a failed decoder build, an error on the device. ``--device``
(default ``cuda``) picks the card; the CPU runs only when asked for
(``--device cpu``).

On several processes (torchrun's environment, or JAX's
``--coordinator_address``/``--num_processes``/``--process_id``; NCCL on the
cards, gloo with ``--device cpu``) or with ``--mesh_tensor``/``--mesh_fsdp``
above 1, the run is on a (data, fsdp, tensor) mesh
(``parallel.distributed.make_hybrid_mesh``), as JAX's: the params are
sharded (``shard_params``; PEFT's adapters whole on every rank), each
``data`` rank trains on its rows of the global batch of ``data`` x
``--per_device_train_batch_size`` examples (``sft.shard_batch``), every
process agrees on a skipped batch (``all_hosts_ok``), checkpoints hold the
whole tree and restore into the live shards, and the first process writes
the export. An explicit ``--mesh_data 1 --mesh_fsdp 1 --mesh_tensor 1``
runs unsharded.

  torchrun --nproc_per_node 8 -m open_o3_video_tpu_torch.train.sft_main ... --mesh_fsdp 8
"""

from __future__ import annotations

import argparse
import os

from ..data import DATA_ERRORS
from .launch import check_app_patch, train_device, train_mesh

# safetensors dtype names -> torch dtype names
_STORED_DTYPES = {"F32": "float32", "BF16": "bfloat16", "F16": "float16", "F64": "float64"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SFT cold-start training (PyTorch)")
    p.add_argument("--model_name_or_path", required=True)
    p.add_argument("--dataset_name", required=True, help="STGR-CoT json/jsonl")
    p.add_argument("--data_root", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--learning_rate", type=float, default=1e-6)
    p.add_argument("--num_train_epochs", type=float, default=1.0)
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--save_steps", type=int, default=500)
    p.add_argument("--logging_steps", type=int, default=1)

    def _bool(s):
        return str(s).lower() not in ("false", "0", "no")

    p.add_argument("--gradient_checkpointing", type=_bool, nargs="?", const=True, default=True,
                   help="remat the ViT blocks and decoder layers (run_sft_video.sh:27)")
    p.add_argument("--bf16", type=_bool, nargs="?", const=True, default=True,
                   help="train in bfloat16 ('false' keeps the checkpoint's stored dtype)")
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--nframes", type=int, default=None)
    p.add_argument("--per_device_train_batch_size", type=int, default=1,
                   help="examples a step (reference: 1, run_sft_video.sh:13)")
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_fsdp", type=int, default=-1)
    p.add_argument("--mesh_tensor", type=int, default=1)
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    # PEFT / LoRA (reference: peft_config via TRL --use_peft flags,
    # sft_multi_task.py:479)
    p.add_argument("--use_peft", action="store_true")
    p.add_argument("--lora_r", type=int, default=16)
    p.add_argument("--lora_alpha", type=float, default=32.0)
    p.add_argument("--lora_target_modules", default="q_proj,v_proj",
                   help="comma-separated (HF names like q_proj or leaf names like q_w)")
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--report_to", default="none")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; the CPU runs only when asked for")
    return p.parse_args(argv)


def stored_dtype(model_dir: str):
    """The dtype of the first tensor of the checkpoint's first shard."""
    import torch
    from safetensors import safe_open

    shard = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))[0]
    with safe_open(os.path.join(model_dir, shard), framework="pt") as f:
        name = _STORED_DTYPES[f.get_slice(next(iter(f.keys()))).get_dtype()]
    return getattr(torch, name)


def main(argv=None):
    args = parse_args(argv)
    os.environ.setdefault("WANDB_MODE", "offline")
    device = train_device(args, "sft_main")

    import torch

    from ..parallel import distributed as D

    D.initialize(args.coordinator_address, args.num_processes, args.process_id,
                 device=device.type)
    mesh = train_mesh(args, "sft_main")

    from ..data.processor import O3VideoProcessor
    from ..data.sft_dataset import collate_sft_batch, load_sft_dataset, prepare_sft_example
    from ..models.qwen25vl import params as P
    from ..models.qwen25vl.config import Qwen25VLConfig
    from ..utils.metrics import MetricsBus
    from . import checkpoint as CKPT
    from .lora import LoraConfig, adapter_leaves, init_adapters, merge_adapters
    from .sft import (SFTConfig, make_lora_train_step, make_optimizer, make_train_step,
                      require_trainable, shard_batch)

    # The loader casts every floating leaf to the config's dtype: bf16 as the
    # reference trains (run_sft_video.sh:28), or the stored dtype.
    dtype = torch.bfloat16 if args.bf16 else stored_dtype(args.model_name_or_path)
    model_cfg = Qwen25VLConfig.from_pretrained(args.model_name_or_path, dtype=dtype)
    require_trainable(model_cfg)
    check_app_patch(model_cfg, "sft_main")
    params, _ = P.load_pretrained(args.model_name_or_path, device, cfg=model_cfg)
    processor = O3VideoProcessor.from_pretrained(args.model_name_or_path)

    raw = load_sft_dataset(args.dataset_name)
    prepared = [prepare_sft_example(ex, args.data_root) for ex in raw]

    # the global batch: one block of rows per data replica
    global_bs = (mesh.shape["data"] if mesh is not None else 1) * args.per_device_train_batch_size
    if len(prepared) < global_bs:
        raise ValueError(f"dataset has {len(prepared)} usable examples but the global batch is "
                         f"{global_bs} (mesh data axis x per-device batch); reduce --mesh_data / "
                         "--per_device_train_batch_size or add data")
    steps_per_epoch = max(1, len(prepared) // global_bs)
    total_steps = (args.max_steps if args.max_steps > 0
                   else int(steps_per_epoch * args.num_train_epochs))
    train_cfg = SFTConfig(
        learning_rate=args.learning_rate,
        max_grad_norm=args.max_grad_norm,
        gradient_checkpointing=args.gradient_checkpointing,
        save_steps=args.save_steps,
        logging_steps=args.logging_steps,
        total_steps=total_steps,
    )
    optimizer = make_optimizer(train_cfg)

    if mesh is not None:
        from ..parallel import replicate, shard_params

        params = shard_params(params, mesh, model_cfg)
    lora_cfg = adapters = None
    if args.use_peft:
        lora_cfg = LoraConfig(
            rank=args.lora_r, alpha=args.lora_alpha,
            target_modules=LoraConfig.normalize_targets(args.lora_target_modules.split(",")),
        )
        adapters = init_adapters(params, lora_cfg, dtype=torch.bfloat16)
        if mesh is not None:  # whole on every rank, as JAX's replicate places them
            adapters = replicate(adapters, mesh)
        opt_state = optimizer.init(adapter_leaves(adapters))
        lora_step = make_lora_train_step(model_cfg, train_cfg, optimizer, lora_cfg.scale,
                                         mesh=mesh)

        def train_step(a, o, b):
            return lora_step(a, o, b, params)
    else:
        P.trainable(params)
        opt_state = optimizer.init(params)
        train_step = make_train_step(model_cfg, train_cfg, optimizer, mesh=mesh)

    def ckpt_state(step):
        # under PEFT the small adapter dict is saved, not the frozen base
        return {"params": adapters if adapters is not None else params,
                "opt_state": opt_state, "meta": {"step": step}}

    start_step = 0
    if args.resume_from_checkpoint:
        # into the live shards (topology-change-safe)
        state, start_step = CKPT.restore_checkpoint(args.resume_from_checkpoint,
                                                    target=ckpt_state(0), mesh=mesh,
                                                    cfg=model_cfg)
        opt_state = state["opt_state"]
        print(f"Resumed from step {start_step}")

    def save(step, async_save=False):
        CKPT.save_checkpoint(args.output_dir, step, ckpt_state(step), async_save=async_save,
                             mesh=mesh, cfg=model_cfg)

    metrics = MetricsBus(use_wandb=args.report_to == "wandb", primary=D.is_primary())
    step = start_step
    n_skipped = 0
    # The sampler is sequential: a resumed run skips the batches its partial
    # epoch already trained instead of replaying prepared[0:].
    epoch = start_step // steps_per_epoch
    resume_offset = (start_step % steps_per_epoch) * global_bs
    while step < total_steps:
        made_progress = False
        start_i, resume_offset = resume_offset, 0  # only the resumed epoch
        for i in range(start_i, len(prepared) - global_bs + 1, global_bs):
            if step >= total_steps:
                break
            group = prepared[i:i + global_bs]
            try:
                batch = collate_sft_batch(group, processor, model_cfg, args.data_root,
                                          nframes=args.nframes)
            except DATA_ERRORS as e:
                batch = None
                print(f"[warn] collate failed at step {step} ({e!r}); skipping batch")
            # every process skips the batch if any failed it, so that none
            # enters a collective the others do not
            if not D.all_hosts_ok(batch is not None, "sft collate"):
                n_skipped += 1
                continue
            batch = shard_batch(batch, mesh)
            if adapters is not None:
                adapters, opt_state, m = train_step(adapters, opt_state, batch)
            else:
                params, opt_state, m = train_step(params, opt_state, batch)
            metrics.push(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
            step += 1
            made_progress = True
            if step % train_cfg.logging_steps == 0:
                metrics.flush(step, extra={"epoch": epoch, "skipped": n_skipped})
            if step % train_cfg.save_steps == 0:
                save(step, async_save=True)
        epoch += 1
        if not made_progress and start_i == 0:
            # every batch of a whole epoch failed its collate: stop instead of
            # spinning (a resumed epoch that skipped to its tail is not this)
            raise RuntimeError(f"epoch {epoch - 1} made no training progress ({n_skipped} "
                               f"batches skipped) — data is unusable")

    CKPT.wait_for_saves()
    save(step)
    if mesh is not None:  # every rank gathers; the first writes
        from ..parallel import gather_params

        with torch.no_grad():
            params = gather_params(params, mesh, model_cfg)
    if D.is_primary():
        if adapters is not None:
            # PEFT's merge_and_unload: the base with the deltas folded in
            CKPT.export_safetensors(merge_adapters(params, adapters, lora_cfg.scale), model_cfg,
                                    args.output_dir)
        else:
            CKPT.export_safetensors(params, model_cfg, args.output_dir)
        CKPT.write_model_card(args.output_dir, trainer_name="SFT",
                              base_model=args.model_name_or_path,
                              dataset_name=args.dataset_name)
    D.sync("sft export")
    print(f"SFT complete: {step} steps -> {args.output_dir}")


if __name__ == "__main__":
    main()
