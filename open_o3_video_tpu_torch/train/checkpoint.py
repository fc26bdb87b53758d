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

On a mesh (``mesh`` and the model's ``cfg`` given), a checkpoint holds the
whole tree: ``save_checkpoint`` gathers every sharded leaf and its AdamW
moments (``parallel.gather_params``; every rank takes part) and the first
rank writes, so the file is the one a single device writes; a restore
places the whole checkpoint into the live shards of whatever mesh the
caller runs on (JAX's "topology-change-safe" restore into the live
shardings), or into a single device's tensors.
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


def _has_shards(tree) -> bool:
    from ..ops.sharded import Sharded

    if isinstance(tree, Sharded):
        return True
    if isinstance(tree, dict):
        return any(_has_shards(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_shards(v) for v in tree)
    return False


def _moments(optimizer, fn) -> dict:
    """An optimizer's state dict with each parameter's moments mapped by
    ``fn(param, moment)``."""
    sd = optimizer.state_dict()
    params = optimizer.param_groups[0]["params"]
    state = {i: {k: (fn(params[i], v) if isinstance(v, torch.Tensor) and v.ndim else v)
                 for k, v in st.items()} for i, st in sd["state"].items()}
    return {**sd, "state": state}


@torch.no_grad()
def _gathered(state, mesh, cfg):
    """The state with its sharded params and their AdamW moments whole."""
    from ..parallel.mesh import _unplace, gather_params, head_plan, placements

    params = state.get("params")
    where = placements(params) if _has_shards(params) else {}
    plan = head_plan(cfg, mesh.shape.get("tensor", 1))

    def whole(p, t):
        spec, path = where.get(id(p), ((), ""))
        return _unplace(t, spec, path, mesh, cfg, plan) if any(spec) else t

    def walk(x):
        if isinstance(x, torch.optim.Optimizer):
            return _moments(x, whole)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x

    out = walk({k: v for k, v in state.items() if k != "params"})
    out["params"] = gather_params(params, mesh, cfg) if where else params
    return out


def _placed(saved, target, mesh, cfg):
    """A whole saved state cut to the live target's shards."""
    from ..parallel.mesh import _place, head_plan, placements, shard_params

    params = target.get("params")
    if not _has_shards(params):
        return saved
    where = placements(params)
    plan = head_plan(cfg, mesh.shape.get("tensor", 1))
    out = dict(saved)
    out["params"] = shard_params(saved["params"], mesh, cfg)

    def cut(target_opt, sd):
        live = target_opt.param_groups[0]["params"]
        state = {}
        for i, st in sd["state"].items():
            spec, path = where.get(id(live[int(i)]), ((), ""))
            state[i] = {k: (_place(v, spec, path, mesh, cfg, plan)
                            if isinstance(v, torch.Tensor) and v.ndim and any(spec) else v)
                        for k, v in st.items()}
        return {**sd, "state": state}

    def walk(t, s):
        if isinstance(t, torch.optim.Optimizer):
            return cut(t, s)
        if isinstance(t, dict):
            return {k: walk(t[k], v) if k in t else v for k, v in s.items()}
        return s

    out.update({k: walk(target[k], v) for k, v in saved.items() if k != "params" and k in target})
    return out


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def save_checkpoint(ckpt_dir: str, step: int, state: dict[str, Any],
                    async_save: bool = False, mesh=None, cfg=None) -> str:
    """Save {params, opt_state, meta, ...} under ``step_%08d``; returns the
    directory. The file is written under a temporary name and renamed, so a
    directory that holds ``state.pt`` holds a whole checkpoint. On a mesh
    every rank calls it; the state is gathered whole and the first rank
    writes."""
    path = _step_dir(ckpt_dir, step)
    if mesh is not None:
        import torch.distributed as dist

        state = _gathered(state, mesh, cfg)
        if dist.get_rank() != 0:
            return path
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
    if _has_shards(target):  # a Sharded leaf: its parts from the placed copy's
        for k, t in target.parts.items():
            with torch.no_grad():
                t.copy_(saved.parts[k])
        return target
    return saved


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       target: Optional[dict] = None, mesh=None, cfg=None) -> tuple[dict, int]:
    """(state, step) of a checkpoint (the latest when ``step`` is None).
    With ``target`` (the live state: tensors, optimizers), every saved
    tensor is copied into the target's tensor in place and every optimizer
    loads its saved state dict, so the trainer resumes on its own devices;
    without it the tensors come back on the host. With ``mesh`` the target's
    params are ``shard_params``' output and the whole checkpoint is cut to
    their shards first (and the AdamW moments to their params')."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    saved = torch.load(os.path.join(_step_dir(ckpt_dir, step), STATE_FILE), map_location="cpu",
                       weights_only=True)
    if target is not None and mesh is not None:
        saved = _placed(saved, target, mesh, cfg)
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
