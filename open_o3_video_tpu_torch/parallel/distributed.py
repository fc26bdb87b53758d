"""Multi-process bootstrap and global-tensor helpers on ``torch.distributed``
(counterpart of ``open_o3_video_tpu/parallel/distributed.py``).

- ``initialize()`` starts the default process group: from JAX-style
  arguments (a coordinator ``host:port``, or ``file://...`` for a file
  store, the process count and this process's id) or from torchrun's
  environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
  NCCL on the card, gloo when the caller asks for the CPU.
- ``make_hybrid_mesh()`` lays out (data, fsdp, tensor) so that fsdp and
  tensor stay within a host and the outer data parallelism crosses hosts.
- ``put_global()`` builds a DTensor from this rank's own rows.
- ``is_primary()`` gates host-side IO to rank 0; ``all_hosts_ok`` and
  ``assert_in_sync`` keep an SPMD fleet on one branch, or fail loudly.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device: str = "cuda",
               timeout_s: float = 600.0) -> bool:
    """Start the default process group once; returns whether it spans more
    than one process. Explicit arguments win, then JAX's environment names
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``),
    then torchrun's. Without any, nothing starts (one process). ``device``
    "cuda" takes NCCL (and this rank's card, ``LOCAL_RANK``), "cpu" gloo."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    coordinator_address = coordinator_address or env.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = env.get("JAX_NUM_PROCESSES", env.get("WORLD_SIZE"))
    if process_id is None:
        process_id = env.get("JAX_PROCESS_ID", env.get("RANK"))
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if coordinator_address is None or num_processes is None:
        return False
    num_processes, process_id = int(num_processes), int(process_id or 0)
    if device == "cuda":
        backend = "nccl"
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)) % torch.cuda.device_count())
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if coordinator_address.startswith("file://"):
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    kw = {"device_id": torch.device("cuda", torch.cuda.current_device())} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return num_processes > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def _device() -> torch.device:
    """Where the default group's collectives take tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_hybrid_mesh(data: int = 1, fsdp: int = -1, tensor: int = 1,
                     dcn_data: Optional[int] = None):
    """(data, fsdp, tensor) mesh over every process, ``dcn_data`` slices of
    data x fsdp x tensor ranks each: the slices' data parallelism crosses
    hosts, fsdp and tensor stay within one (consecutive ranks share a host,
    as torchrun numbers them). ``dcn_data`` defaults to the hosts
    (``WORLD_SIZE / LOCAL_WORLD_SIZE``); one slice is ``make_mesh``."""
    from .mesh import make_mesh

    n = process_count()
    if dcn_data is None:
        dcn_data = n // int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if dcn_data <= 1:
        return make_mesh(data=data, fsdp=fsdp, tensor=tensor)
    per_slice = n // dcn_data
    if fsdp == -1:
        fsdp = per_slice // (data * tensor)
    if data * fsdp * tensor != per_slice:
        raise ValueError(f"slice mesh {data}x{fsdp}x{tensor} != {per_slice} processes a slice")
    return make_mesh(data=dcn_data * data, fsdp=fsdp, tensor=tensor)


def put_global(x, mesh, spec):
    """A DTensor from this rank's LOCAL rows: ``spec`` (one mesh axis or
    None per dimension of ``x``) says which axis each dimension is split
    over; this rank passes its own block, as each DDP rank feeds its own
    samples."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = []
    for axis in mesh.axis_names:
        dims = [d for d, a in enumerate(spec) if a == axis]
        placements.append(Shard(dims[0]) if dims else Replicate())
    local = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    return DTensor.from_local(local.to(mesh.device_type), mesh.device_mesh, placements)


def sync(tag: str = "sync") -> None:
    """Barrier across processes (nothing with one)."""
    if process_count() > 1:
        dist.barrier()


def scalar(x) -> float:
    """A host float from a tensor or a replicated DTensor."""
    full = getattr(x, "full_tensor", None)
    return float(full() if full is not None else x)


def all_hosts_ok(ok: bool, tag: str = "batch") -> bool:
    """True only when every process's ``ok`` is true (an all-reduce of the
    minimum), so every process takes the same branch."""
    if process_count() == 1:
        return bool(ok)
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32, device=_device())
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item() == 1)


def assert_in_sync(digest, tag: str = "batch") -> None:
    """Raise, naming every process's ``digest``, if they differ: a
    host-local failure absorbed on one process only would otherwise send
    the processes into different collectives, and hang."""
    if process_count() == 1:
        return
    mine = torch.as_tensor(np.asarray(digest, dtype=np.float64).reshape(-1), device=_device())
    out = torch.empty(process_count() * mine.numel(), dtype=mine.dtype, device=mine.device)
    dist.all_gather_into_tensor(out, mine)
    gathered = out.reshape(process_count(), -1).cpu().numpy()
    if not (gathered == gathered[0]).all():
        raise RuntimeError(
            f"SPMD divergence on '{tag}': processes computed different inputs "
            f"(digests: {gathered.tolist()}); a host-local failure was absorbed "
            "inconsistently. Fix the data source or exclude the failing item on every "
            "process.")
