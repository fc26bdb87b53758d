"""Evaluation CLI of the port (counterpart of ``open_o3_video_tpu/eval/cli.py``,
with its flags and defaults):

  python -m open_o3_video_tpu_torch.eval.cli vstar --model_path ... --anno ... --video_folder ...
  python -m open_o3_video_tpu_torch.eval.cli vstar-judge --result_file ... --model_path <judge>
  python -m open_o3_video_tpu_torch.eval.cli videomme|worldsense|videommmu --model_path ... --data_dir ...
  python -m open_o3_video_tpu_torch.eval.cli tvgbench --model_path ... --anno ... --video_folder ...

``--device`` (default ``cuda``) picks the card; the CPU runs only when asked
for (``--device cpu``). On several cards, one process each:

  torchrun --nproc_per_node N -m open_o3_video_tpu_torch.eval.cli ... --mesh_tensor N

serves one model split over the N cards (``--mesh_data N``: N replicas,
the DP eval fleet; the product of the two must be N). Rank 0 writes the
results; another rank writes its copy to ``<output>.rank<r>``.
``--config`` is read as the flat ``key: scalar`` form that every
``configs/eval/*.yaml`` holds (``read_flat_yaml``, no PyYAML), which
refuses anything else.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Optional

import torch

DEFAULT_CONFIGS = {
    # reference: eval/config/*.yaml
    "vstar": {"temperature": 0.0, "max_tokens": 2048, "video_max_pixels": 2097152, "video_max_frames": 16},
    "tvgbench": {"temperature": 0.0, "max_tokens": 2048, "video_max_pixels": 2097152, "video_max_frames": 16},
    "videomme": {"temperature": 0.0, "max_tokens": 8192, "video_max_pixels": 262144, "video_max_frames": 64},
    "worldsense": {"temperature": 0.0, "max_tokens": 8192, "video_max_pixels": 262144, "video_max_frames": 64},
    "videommmu": {"temperature": 0.0, "max_tokens": 8192, "video_max_pixels": 262144, "video_max_frames": 64},
}

# The scalars a flat config may hold, each read as yaml.safe_load reads it;
# any other value (YAML 1.1's yes/no/on/off, .inf, 1_000, flow or block
# forms, escapes) is refused rather than read differently.
_NULL = ("", "~", "null")
_BOOLS = {"true": True, "True": True, "TRUE": True, "false": False, "False": False, "FALSE": False}
_YAML11_WORDS = {"yes", "no", "on", "off", "null"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*([eE][-+][0-9]+)?$")
_PLAIN = re.compile(r"[A-Za-z][A-Za-z0-9_./-]*$")
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?:\s+(.*))?$")


def _scalar(text: str, where: str):
    if text in _NULL:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"" and not set(text[1:-1]) & set("'\"\\"):
        return text[1:-1]
    if _PLAIN.match(text) and text.lower() not in _YAML11_WORDS:
        return text
    raise ValueError(f"{where}: {text!r} is not an int, float, bool, null or plain string")


def read_flat_yaml(path: str) -> dict:
    """A yaml file of ``key: scalar`` lines (comments and blank lines
    allowed), each value read as ``yaml.safe_load`` reads it; anything else
    (nesting, lists, anchors, block scalars, other scalar forms) raises
    ValueError."""
    out = {}
    with open(path) as f:
        for n, line in enumerate(f, 1):
            body = line.rstrip("\n").rstrip()
            if not body.strip() or body.lstrip().startswith("#"):
                continue
            m = _KEY.match(body)
            if m is None or m.group(1) in out:
                raise ValueError(f"{path}:{n}: not a flat 'key: scalar' line: {body!r}")
            value = (m.group(2) or "").strip()
            if value[:1] not in ("'", '"'):
                value = re.split(r"\s#", value, maxsplit=1)[0].strip()  # a trailing comment
            out[m.group(1)] = _scalar(value, f"{path}:{n}")
    return out


def load_model_kwargs(args, bench: str) -> dict:
    kwargs = dict(DEFAULT_CONFIGS[bench])
    if args.config and os.path.exists(args.config):
        kwargs.update(read_flat_yaml(args.config))
    return kwargs


def build_model(args, bench: str):
    from .model_engine import QwenVLEngine

    kwargs = load_model_kwargs(args, bench)
    if args.load_in_int8:
        kwargs["load_in_int8"] = True
    if args.load_in_int4:
        kwargs["load_in_int4"] = True
    mesh = make_eval_mesh(args)
    if args.mesh_data > 1:
        # the DP eval fleet: each rank of `data` serves its share of the slot
        # rows (the reference's per-GPU workers)
        kwargs["batch_axis"] = "data"
        kwargs["max_slots"] = args.mesh_data * args.slots_per_chip
    return QwenVLEngine(args.model_path, rt_shape=True, device=args.device, mesh=mesh, **kwargs)


def make_eval_mesh(args, tensor_only: bool = False, build: bool = True):
    """The (data, tensor) mesh of ``--mesh_data`` x ``--mesh_tensor`` ranks
    over the processes torchrun started (None for one rank). Its size must
    be the world size; ``build=False`` only checks that."""
    from ..parallel import distributed, make_mesh

    data = 1 if tensor_only else args.mesh_data
    if data * args.mesh_tensor == 1:
        return None
    distributed.initialize(device="cpu" if args.device == "cpu" else "cuda")
    world = distributed.process_count()
    if data * args.mesh_tensor != world:
        raise SystemExit(f"eval: a mesh of --mesh_data {data} x --mesh_tensor "
                         f"{args.mesh_tensor} = {data * args.mesh_tensor} ranks needs as many "
                         f"processes; the world size is {world} (torchrun --nproc_per_node)")
    return make_mesh(data=data, fsdp=1, tensor=args.mesh_tensor) if build else None


def check_args(args) -> None:
    """Refuse what the port does not serve, before anything loads: no card
    without ``--device cpu``, a mesh whose size is not the world size."""
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("eval: no CUDA device; pass --device cpu to evaluate on the CPU")
    data = 1 if args.benchmark == "vstar-judge" else args.mesh_data
    if data * args.mesh_tensor > 1:
        make_eval_mesh(args, tensor_only=args.benchmark == "vstar-judge", build=False)


# Where each benchmark writes without --output.
DEFAULT_OUTPUTS = {"vstar": "vstar_results.json", "videomme": "videomme_results.json",
                   "worldsense": "worldsense", "tvgbench": "tvgbench_results.json",
                   "videommmu": "videommmu_results.json"}


def _rank_output(path: Optional[str]) -> Optional[str]:
    """Rank 0 writes the results; another rank of a mesh its own copy beside
    them (``<path>.rank<r>``), so no two processes write one file."""
    from ..parallel import distributed

    r = distributed.process_index()
    return path if path is None or r == 0 else f"{path}.rank{r}"


def main(argv=None):
    parser = argparse.ArgumentParser(description="Benchmark evaluation")
    parser.add_argument("benchmark", choices=["vstar", "vstar-judge", "videomme", "worldsense", "videommmu", "tvgbench"])
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--config", default=None, help="yaml overriding model kwargs")
    parser.add_argument("--anno", default=None, help="V-STAR annotation json")
    parser.add_argument("--video_folder", default=None)
    parser.add_argument("--data_dir", default=None)
    parser.add_argument("--asr_dir", default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--result_file", default=None, help="for vstar-judge")
    parser.add_argument(
        "--load_in_int8", action="store_true",
        help="quantize the decoder's weights to int8 as they load",
    )
    parser.add_argument(
        "--load_in_int4", action="store_true",
        help="quantize the decoder's weights to group-128 int4 as they load (K7; the 72B "
             "judge in ~40 GB on one card)",
    )
    parser.add_argument("--N", type=int, default=1)
    parser.add_argument("--vote", default="majority_voting",
                        choices=["majority_voting", "confidence_voting"])
    parser.add_argument("--think_mode", type=lambda s: s.lower() != "false", default=True)
    parser.add_argument("--add_asr", type=lambda s: s.lower() != "false", default=None)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--mesh_tensor", type=int, default=1)
    parser.add_argument("--mesh_data", type=int, default=1,
                        help="data-parallel eval fleet width (ranks of the DP fleet)")
    parser.add_argument("--slots_per_chip", type=int, default=8)
    parser.add_argument(
        "--item_batch", type=int, default=4,
        help="items evaluated together through the engine (each engine call is "
        "item_batch x N requests, through the engine's 8 decode slots)",
    )
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu, which runs only when asked for")
    args = parser.parse_args(argv)
    check_args(args)
    if args.mesh_tensor * args.mesh_data > 1:
        args.output = _rank_output(args.output or DEFAULT_OUTPUTS.get(args.benchmark))

    if args.benchmark == "vstar":
        from . import vstar

        model = build_model(args, "vstar")
        vstar.evaluate(
            args.anno, args.video_folder, model,
            args.output or "vstar_results.json",
            think_mode=args.think_mode, limit=args.limit,
            item_batch=args.item_batch,
        )
    elif args.benchmark == "vstar-judge":
        from .judge import EngineJudge, evaluate_json

        judge = EngineJudge(args.model_path, mesh=make_eval_mesh(args, tensor_only=True),
                            load_in_int8=args.load_in_int8, load_in_int4=args.load_in_int4,
                            device=args.device)
        evaluate_json(args.result_file, judge)
    elif args.benchmark == "videomme":
        from . import videomme

        model = build_model(args, "videomme")
        videomme.evaluate(
            model, args.data_dir, args.output or "videomme_results.json",
            N=args.N, vote=args.vote, think_mode=args.think_mode,
            add_asr=bool(args.add_asr), asr_dir=args.asr_dir, limit=args.limit,
            item_batch=args.item_batch,
        )
    elif args.benchmark == "worldsense":
        from . import worldsense

        model = build_model(args, "worldsense")
        worldsense.evaluate(
            model, args.data_dir, args.output or "worldsense",
            asr_dir=args.asr_dir, add_asr=args.add_asr if args.add_asr is not None else True,
            N=args.N, vote=args.vote, think_mode=args.think_mode, limit=args.limit,
            item_batch=args.item_batch,
        )
    elif args.benchmark == "tvgbench":
        from . import tvgbench

        model = build_model(args, "tvgbench")
        tvgbench.evaluate(
            args.anno, args.video_folder, model,
            args.output or "tvgbench_results.json",
            think_mode=args.think_mode, limit=args.limit,
            item_batch=args.item_batch,
        )
    elif args.benchmark == "videommmu":
        from . import videommmu

        model = build_model(args, "videommmu")
        videommmu.evaluate(
            model, args.data_dir, args.output or "videommmu_results.json",
            N=args.N, vote=args.vote, think_mode=args.think_mode, limit=args.limit,
            item_batch=args.item_batch,
        )


if __name__ == "__main__":
    main()
