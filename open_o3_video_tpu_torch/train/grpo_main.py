"""GSPO RL entry point (counterpart of ``open_o3_video_tpu/train/grpo_main.py``:
the reference's grpo.py + run_grpo_video.sh flags).

Usage:
  python -m open_o3_video_tpu_torch.train.grpo_main \
      --model_name_or_path ./checkpoints/sft \
      --dataset_name /path/STGR-RL-36k.json \
      --data_root /path/data \
      --output_dir ./checkpoints/gspo \
      --max_prompt_length 16384 --max_completion_length 768 \
      --num_generations 4 --beta 0.04 --max_grad_norm 5 --use_peft

The same flags and loop as the JAX entry point: one prompt per step, the
last good sample ("using fixed data") when a sample fails to prepare, a
checkpoint every ``--save_steps`` and at the end, then the export (under
PEFT, the base with the adapters merged). ``--device`` (default ``cuda``)
picks the card; the CPU runs only when asked for (``--device cpu``).

On a mesh (several processes, as ``sft_main``'s: torchrun's environment or
``--coordinator_address``/``--num_processes``/``--process_id``; or
``--mesh_tensor``/``--mesh_fsdp`` above 1) every process iterates the same
dataset cursor and a step takes one prompt per ``data`` replica, as JAX's;
``GSPOTrainer`` gets the mesh (sharded policy and reference, rollout rows
over ``data``), checkpoints hold the whole tree, and the first process
writes the export.

  torchrun --nproc_per_node 8 -m open_o3_video_tpu_torch.train.grpo_main ... --mesh_data 8
"""

from __future__ import annotations

import argparse
import os

from .launch import check_app_patch, train_device, train_mesh


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GSPO RL training (PyTorch)")
    p.add_argument("--model_name_or_path", required=True)
    p.add_argument("--dataset_name", required=True, help="STGR-RL json/jsonl")
    p.add_argument("--data_root", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument(
        "--reward_funcs",
        nargs="+",
        default=["ans_acc", "ans_tiou", "ans_viou", "thk_temporal_point",
                 "thk_temporal_segment", "thk_spatial", "format"],
    )
    p.add_argument("--max_prompt_length", type=int, default=16384)
    p.add_argument("--max_completion_length", type=int, default=768)
    p.add_argument("--num_generations", type=int, default=4)
    p.add_argument("--beta", type=float, default=0.04)
    p.add_argument("--learning_rate", type=float, default=1e-6)
    p.add_argument("--max_grad_norm", type=float, default=5.0)
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--num_train_epochs", type=float, default=1.0)
    p.add_argument("--save_steps", type=int, default=500)
    p.add_argument("--logging_steps", type=int, default=1)
    p.add_argument("--max_pixels", type=int, default=12845056)
    p.add_argument("--min_pixels", type=int, default=3136)
    # Parse-only, as in the reference (grpo.py:41-48): its trainer reads none
    # of them (grpo_trainer.py:305, :315, :660).
    p.add_argument("--temporal", type=bool, default=True)
    p.add_argument("--len_control", type=bool, default=True)
    p.add_argument("--gspo", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--nframes", type=int, default=None)
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_fsdp", type=int, default=-1)
    p.add_argument("--mesh_tensor", type=int, default=1)
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    # PEFT / LoRA (reference: peft_config via TRL --use_peft flags, grpo.py:98)
    p.add_argument("--use_peft", action="store_true")
    p.add_argument("--lora_r", type=int, default=16)
    p.add_argument("--lora_alpha", type=float, default=32.0)
    p.add_argument("--lora_target_modules", default="q_proj,v_proj",
                   help="comma-separated (HF names like q_proj or leaf names like q_w)")
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--report_to", default="none")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; the CPU runs only when asked for")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    os.environ.setdefault("WANDB_MODE", "offline")
    device = train_device(args, "grpo_main")

    from ..parallel import distributed as D

    D.initialize(args.coordinator_address, args.num_processes, args.process_id,
                 device=device.type)
    mesh = train_mesh(args, "grpo_main")

    import torch

    from ..data.processor import O3VideoProcessor
    from ..data.rl_dataset import load_rl_dataset, prepare_rl_sample
    from ..grounding.rewards import REWARD_REGISTRY
    from ..models.qwen25vl import params as P
    from ..models.qwen25vl.config import Qwen25VLConfig
    from ..utils.metrics import MetricsBus
    from . import checkpoint as CKPT
    from .gspo import GSPOConfig, GSPOTrainer
    from .sft import require_trainable
    from .lora import LoraConfig, merge_adapters

    model_cfg = Qwen25VLConfig.from_pretrained(args.model_name_or_path)
    require_trainable(model_cfg)
    check_app_patch(model_cfg, "grpo_main")
    params, model_cfg = P.load_pretrained(args.model_name_or_path, device)
    # PEFT: the reference model is the base with adapters disabled, so the
    # checkpoint is read once; a full fine-tune keeps a second, frozen copy.
    ref_params = None if args.use_peft else P.load_pretrained(args.model_name_or_path, device)[0]
    processor = O3VideoProcessor.from_pretrained(args.model_name_or_path)

    dataset = load_rl_dataset(args.dataset_name)
    if not dataset:
        raise ValueError("RL dataset is empty after the reference's multiple-of-4 train "
                         "truncation (data_loader.py:53-54): provide >= 4 examples")

    cfg = GSPOConfig(
        num_generations=args.num_generations,
        max_prompt_length=args.max_prompt_length,
        max_completion_length=args.max_completion_length,
        beta=args.beta,
        learning_rate=args.learning_rate,
        max_grad_norm=args.max_grad_norm,
        gspo=args.gspo,
        logging_steps=args.logging_steps,
    )
    metrics = MetricsBus(use_wandb=args.report_to == "wandb", primary=D.is_primary())
    lora_cfg = None
    if args.use_peft:
        lora_cfg = LoraConfig(
            rank=args.lora_r, alpha=args.lora_alpha,
            target_modules=LoraConfig.normalize_targets(args.lora_target_modules.split(",")),
            seed=args.seed,
        )
    trainer = GSPOTrainer(
        params, ref_params, model_cfg, cfg,
        detokenize=lambda ids: processor.decode(ids, skip_special_tokens=True),
        reward_funcs=[REWARD_REGISTRY[name] for name in args.reward_funcs],
        mesh=mesh, metrics=metrics, seed=args.seed, lora=lora_cfg,
    )

    def ckpt_state(step):
        # (seed, step) fixes the rollout sampler's stream on resume; under
        # PEFT the small adapter dict is saved, not the frozen base.
        weights = trainer.adapters if trainer.adapters is not None else trainer.params
        return {"params": weights, "opt_state": trainer.opt_state,
                "meta": {"step": step, "seed": trainer.seed}}

    start_step = 0
    if args.resume_from_checkpoint:
        # into the live shards (topology-change-safe)
        state, start_step = CKPT.restore_checkpoint(args.resume_from_checkpoint,
                                                    target=ckpt_state(0), mesh=mesh,
                                                    cfg=model_cfg)
        trainer.opt_state = state["opt_state"]
        trainer.seed = int(state["meta"]["seed"])
        print(f"Resumed from step {start_step} (sampler seed {trainer.seed})")

    def save(step, async_save=False):
        CKPT.save_checkpoint(args.output_dir, step, ckpt_state(step), async_save=async_save,
                             mesh=mesh, cfg=model_cfg)

    # one prompt per data replica per step (the reference's one prompt a
    # GPU): epochs are passes over the dataset
    n_prompts = mesh.shape["data"] if mesh is not None else 1
    total_steps = (args.max_steps if args.max_steps > 0
                   else -(-int(len(dataset) * args.num_train_epochs) // n_prompts))
    step = start_step
    cursor = start_step * n_prompts
    last_good_sample = None
    while step < total_steps:
        batch_samples = []
        for _ in range(n_prompts):
            example = dataset[cursor % len(dataset)]
            cursor += 1
            try:
                sample = prepare_rl_sample(example, processor, args.data_root,
                                           nframes=args.nframes)
                last_good_sample = sample
            except Exception as e:
                # the reference's "using fixed data" (grpo_trainer.py:452-465)
                print(f"[warn] sample prep failed at step {step} ({e!r}); using fixed data")
                sample = last_good_sample
                if sample is None:
                    continue
            batch_samples.append(sample)
        if not batch_samples:  # nothing good yet: the step passes without an update
            step += 1
            continue
        while len(batch_samples) < n_prompts:  # keep B == the data axis
            batch_samples.append(batch_samples[0])
        trainer.step_batch(batch_samples, global_step=step, max_steps=total_steps)
        step += 1
        if step % cfg.logging_steps == 0:
            metrics.flush(step)
        if step % args.save_steps == 0:
            save(step, async_save=True)

    CKPT.wait_for_saves()
    save(step)
    params = trainer.params
    if mesh is not None:  # every rank gathers; the first writes
        from ..parallel import gather_params

        with torch.no_grad():
            params = gather_params(params, mesh, model_cfg)
    if D.is_primary():
        if trainer.adapters is not None:
            # PEFT's merge_and_unload: the base with the deltas folded in
            params = merge_adapters(params, trainer.adapters, lora_cfg.scale)
        CKPT.export_safetensors(params, model_cfg, args.output_dir)
        CKPT.write_model_card(args.output_dir, trainer_name="GSPO",
                              base_model=args.model_name_or_path,
                              dataset_name=args.dataset_name)
    D.sync("gspo export")
    print(f"GSPO complete: {step} steps -> {args.output_dir}")


if __name__ == "__main__":
    main()
