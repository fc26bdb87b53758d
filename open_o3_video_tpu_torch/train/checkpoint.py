"""Checkpoint IO (counterpart of ``open_o3_video_tpu/train/checkpoint.py``,
which uses orbax): periodic saves of the training state, resume into the
caller's tensors, and an HF-convention safetensors export.

A checkpoint is ``<dir>/step_%08d/state.pt``, one ``torch.save`` of the
state dict with every tensor on the host and each ``torch.optim.Optimizer``
as its ``state_dict()``. ``async_save=True`` copies the tensors to the host
before it returns (the trainer updates its tensors in place) and writes the
file on a background thread; ``wait_for_saves`` waits for the writes and
raises the first one's error. The writer is module state, as the JAX
package's orbax checkpointer is, so the two APIs match. The state is any
tree of tensors, so every family's params and AdamW state save and
restore alike (the MoE families' expert stacks and routers, Aria's tower
and projector).
``export_safetensors`` writes the format itself (``params.save_safetensors``)
and ``config.json``, so the JAX package's ``params.load_pretrained`` reads the
directory.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
from typing import Any, Optional

import torch

from ..models.qwen25vl.params import save_safetensors

STATE_FILE = "state.pt"
_writer: Optional[concurrent.futures.ThreadPoolExecutor] = None
_pending: list[concurrent.futures.Future] = []


def _to_host(state):
    """The state with tensors detached on the host and optimizers as their
    state dicts (themselves copied to the host)."""
    if isinstance(state, torch.optim.Optimizer):
        return _to_host(state.state_dict())
    if isinstance(state, dict):
        return {k: _to_host(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_host(v) for v in state)
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    return state


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def save_checkpoint(ckpt_dir: str, step: int, state: dict[str, Any],
                    async_save: bool = False) -> str:
    """Save {params, opt_state, meta, ...} under ``step_%08d``; returns the
    directory. The file is written under a temporary name and renamed, so a
    directory that holds ``state.pt`` holds a whole checkpoint."""
    path = _step_dir(ckpt_dir, step)
    host = _to_host(state)

    def write():
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(host, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))

    global _writer
    if async_save:
        if _writer is None:
            _writer = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="checkpoint")
        _pending.append(_writer.submit(write))
    else:
        write()
    return path


def wait_for_saves() -> None:
    """Block until every async save has been written; raises a failed
    write's error."""
    while _pending:
        _pending.pop(0).result()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(name.split("_")[1])
        for name in os.listdir(ckpt_dir)
        if name.startswith("step_") and name.split("_")[1].isdigit()
        and os.path.exists(os.path.join(ckpt_dir, name, STATE_FILE))
    ]
    return max(steps) if steps else None


def _restore_into(target, saved):
    """Copy ``saved`` into ``target``'s tensors (keeping their device and
    dtype) and optimizers; returns the restored tree (``target``'s objects
    where it has them)."""
    if isinstance(target, torch.optim.Optimizer):
        target.load_state_dict(saved)
        return target
    if isinstance(target, dict):
        return {k: _restore_into(target[k], saved[k]) if k in target else saved[k]
                for k in saved}
    if isinstance(target, (list, tuple)):
        return type(target)(_restore_into(t, s) for t, s in zip(target, saved))
    if isinstance(target, torch.Tensor):
        with torch.no_grad():
            target.copy_(saved)
        return target
    return saved


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       target: Optional[dict] = None) -> tuple[dict, int]:
    """(state, step) of a checkpoint (the latest when ``step`` is None).
    With ``target`` (the live state: tensors, optimizers), every saved
    tensor is copied into the target's tensor in place and every optimizer
    loads its saved state dict, so the trainer resumes on its own devices;
    without it the tensors come back on the host."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    saved = torch.load(os.path.join(_step_dir(ckpt_dir, step), STATE_FILE), map_location="cpu",
                       weights_only=True)
    return (saved if target is None else _restore_into(target, saved)), step


def export_safetensors(params: dict, cfg, out_dir: str) -> None:
    """Export plain (merged) weights as ``model.safetensors`` in the HF
    layout, with ``config.json``, so the directory loads on its own."""
    os.makedirs(out_dir, exist_ok=True)
    save_safetensors(params, cfg, os.path.join(out_dir, "model.safetensors"))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg.to_hf_dict(), f, indent=2)


def write_model_card(
    out_dir: str,
    *,
    trainer_name: str,
    base_model: "str | None" = None,
    model_name: "str | None" = None,
    dataset_name: "str | None" = None,
    tags: "tuple[str, ...]" = (),
) -> None:
    """Draft model card (README.md) in the exported directory, as the JAX
    package writes it (TRL's ``generate_model_card``, with the DeepSeekMath
    citation for the GRPO/GSPO family)."""
    os.makedirs(out_dir, exist_ok=True)
    model_name = model_name or os.path.basename(os.path.normpath(out_dir))
    front = ["---"]
    if base_model:
        front.append(f"base_model: {base_model}")
    front += [
        "library_name: open_o3_video_tpu_torch",
        f"model_name: {model_name}",
        "tags:",
        "- generated_from_trainer",
        f"- {trainer_name.lower()}",
    ]
    front += [f"- {t}" for t in tags]
    if dataset_name:
        front.append(f"datasets:\n- {dataset_name}")
    front.append("---")
    citation = ""
    if trainer_name.upper() in ("GRPO", "GSPO"):
        citation = (
            "\n## Citations\n\n```bibtex\n"
            "@article{zhihong2024deepseekmath,\n"
            "    title        = {{DeepSeekMath: Pushing the Limits of "
            "Mathematical Reasoning in Open Language Models}},\n"
            "    author       = {Zhihong Shao and Peiyi Wang and Qihao Zhu "
            "and Runxin Xu and Junxiao Song and Mingchuan Zhang and "
            "Y. K. Li and Y. Wu and Daya Guo},\n"
            "    year         = 2024,\n"
            "    eprint       = {arXiv:2402.03300},\n"
            "}\n```\n"
        )
    body = (
        f"\n# {model_name}\n\n"
        + (f"This model is a fine-tuned version of [{base_model}]"
           f"(https://huggingface.co/{base_model})" if base_model
           else "This model was trained from scratch")
        + (f" on the {dataset_name} dataset" if dataset_name else "")
        + f" with the **{trainer_name}** trainer of open_o3_video_tpu_torch "
        "(PyTorch on CUDA).\n\n"
        "## Quick start\n\n```python\n"
        "import torch\n"
        "from open_o3_video_tpu_torch.models.qwen25vl import params as P\n"
        f"params, cfg = P.load_pretrained(\"{out_dir}\", torch.device(\"cuda\"))\n```\n"
        + citation
    )
    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write("\n".join(front) + "\n" + body)
