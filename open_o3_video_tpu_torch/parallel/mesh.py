"""Mesh construction and parameter sharding (counterpart of
``open_o3_video_tpu/parallel/mesh.py``).

One process per rank (torchrun's model, not JAX's single controller). The
mesh is a ``torch.distributed`` ``DeviceMesh`` with JAX's axis names and
order, (data, fsdp[, context], tensor), wrapped in ``Mesh``, which keeps
each axis's size (``mesh.shape``, a mapping as JAX's), this rank's
coordinates, and the collectives the sharded forward issues.

``PARAM_RULES`` are JAX's, regex for regex, each ``PartitionSpec`` a tuple
of mesh-axis names; ``param_sharding_rules`` keeps JAX's divisibility
fallback and reads quantized and LoRA leaves as JAX's ``_path_str`` names
them (``.../q_w/w_p``, ``.../o_w/base/w_q``, ``.../q_w/a``). Given the
model's config it applies the port's two departures:

- **Head alignment.** JAX's rules split at element granularity and GSPMD
  reshards inside a head; here attention leaves split at whole heads only.
  Where the KV heads do not divide over ``tensor`` but each rank's query
  heads read one KV head, that rank holds it (``HEADS``); where the query
  heads do not divide, attention stays replicated over ``tensor``.
- **The tower's qkv layout.** ``qkv_w``/``qkv_b`` are stored [q|k|v]; before
  the split their columns are permuted to [q_r|k_r|v_r] per rank, so each
  rank's shard is its heads' q, k and v. ``gather_params`` undoes it.

``shard_params`` puts each placed weight as a local shard plus its
placement (``ops.sharded.Sharded``), and slices the other leaves (biases)
to the rank's columns. No DTensor reaches a kernel.
"""

from __future__ import annotations

import collections
import dataclasses
import re
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.int4 import Int4Linear
from ..ops.quant import LoraLinear, QuantizedLinear
from ..ops.sharded import FSDP, HEADS, TENSOR, Sharded

AXES = ("data", "fsdp", "tensor")


def _gather(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in the group's rank order. Flat
    buffers, as gloo takes them."""
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=group)
    return out.reshape((n,) + tuple(x.shape))


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the group, on a fresh contiguous tensor."""
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


def _slice(x: torch.Tensor, n: int, rank: int, dim: int) -> torch.Tensor:
    per = x.shape[dim] // n
    return x.narrow(dim, rank * per, per).contiguous()


# The collectives under autograd. Within a model replica (the ranks that
# share a ``data`` coordinate) every rank reads the same rows, so a tensor
# is either replicated over an axis (each rank holds the same value, and
# the gradient it holds is the whole gradient) or split over it (each rank
# holds its slice, and the gradient of that slice). Each function's
# backward keeps that convention (Megatron's f and g).


class _SumOver(torch.autograd.Function):
    """Partial sums -> their total, replicated: all-reduce forward; the
    gradient of a replicated total passes to each partial unchanged (the
    row-parallel output after o and down, the vocabulary rows of ``embed``,
    the experts' combine)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh._reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyIn(torch.autograd.Function):
    """A replicated tensor entering compute that differs by rank (a
    column-parallel product, a rank's slice): identity forward; backward,
    each rank's partial gradient summed over the axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.mesh.collectives["bwd_all_reduce"] += 1
        return _sum(g, ctx.mesh.groups[ctx.axis]), None, None


class _GatherOut(torch.autograd.Function):
    """Slices -> the whole, replicated (the column gathers: ``dense``'s
    all-gather on N, an input gathered before a product that is not split
    on K): backward keeps this rank's slice of the replicated gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.n, ctx.rank, ctx.dim = mesh.shape[axis], mesh.rank(axis), dim
        return torch.cat(_gather(x, ctx.n, mesh.groups[axis]).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.n, ctx.rank, ctx.dim), None, None, None


class _GatherWeight(torch.autograd.Function):
    """ZeRO-3: a weight's shards gathered before use; backward, the whole
    weight's gradient reduce-scattered over the axis, so that each rank's
    lands on its own shard. The ranks of ``fsdp`` read the same rows, so the
    scattered sum is divided by their number: the gradient of the one loss
    they compute together."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return torch.cat(_gather(t, mesh.shape[axis], mesh.groups[axis]).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        m, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        n, group = m.shape[axis], m.groups[axis]
        m.collectives["bwd_reduce_scatter"] += 1
        if dist.get_backend(group) == "nccl":
            parts = g.movedim(dim, 0).contiguous()
            out = torch.empty((parts.shape[0] // n,) + tuple(parts.shape[1:]), dtype=g.dtype,
                              device=g.device)
            dist.reduce_scatter_tensor(out, parts, group=group)
            out = out.movedim(0, dim)
        else:  # gloo has no reduce-scatter
            out = _slice(_sum(g, group), n, m.rank(axis), dim)
        return out.div_(n).contiguous(), None, None, None


def _grad_path(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class Mesh:
    """A mesh of processes over a ``DeviceMesh``: ``shape`` (axis -> size,
    as JAX's ``mesh.shape``), ``rank(axis)``, a process group per axis,
    and the collectives of the sharded forward, counted in
    ``collectives`` by kind (those of a backward as ``bwd_*``). Under
    autograd each collective has the backward its placement needs (the
    functions above); without it, the forward's collective alone runs."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.groups = {a: device_mesh.get_group(a) for a in self.axis_names}
        self._rank = {a: device_mesh.get_local_rank(a) for a in self.axis_names}
        self.device_type = device_mesh.device_type
        self.collectives: collections.Counter = collections.Counter()
        # The model replica of this rank: every axis but data. new_group is
        # collective, so every rank makes every replica's group.
        ranks = device_mesh.mesh
        self._replica, self._replica_src = None, dist.get_rank()
        if "data" in self.axis_names:
            ranks = ranks.reshape(self.shape["data"], -1)
        else:
            ranks = ranks.reshape(1, -1)
        for row in ranks.tolist():
            group = dist.new_group(row) if len(row) > 1 else None
            if dist.get_rank() in row and group is not None:
                self._replica, self._replica_src = group, row[0]

    def rank(self, axis: str) -> int:
        return self._rank[axis]

    def __repr__(self):
        return f"Mesh({self.shape})"

    def _reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        x = x.contiguous()
        dist.all_reduce(x, group=self.groups[axis])
        self.collectives["all_reduce"] += 1
        return x

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum over ``axis`` (float32 for half types is the caller's
        choice), in place on a fresh tensor; under autograd its backward is
        the identity."""
        if _grad_path(x):
            return _SumOver.apply(x, self, axis)
        return self._reduce(x, axis)

    def copy_in(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x``, replicated over ``axis``, as the input of compute that
        differs by rank: nothing forward; under autograd, the gradient's
        partials are summed over ``axis`` (nothing on a one-rank axis)."""
        if self.shape[axis] == 1 or not _grad_path(x):
            return x
        return _CopyIn.apply(x, self, axis)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = -1) -> torch.Tensor:
        """The ranks' ``x`` along ``axis`` concatenated on ``dim``, in rank
        order; under autograd, backward keeps this rank's slice."""
        self.collectives["all_gather"] += 1
        if _grad_path(x):
            return _GatherOut.apply(x, self, axis, dim % x.ndim)
        out = _gather(x, self.shape[axis], self.groups[axis])
        return torch.cat(out.unbind(0), dim=dim)

    def gather_weight(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """A weight's shards over ``axis`` joined on ``dim`` (ZeRO-3's
        gather before use); under autograd, a reduce-scatter backward."""
        self.collectives["weight_gather"] += 1
        if _grad_path(t):
            return _GatherWeight.apply(t, self, axis, dim % t.ndim)
        out = _gather(t, self.shape[axis], self.groups[axis])
        return torch.cat(out.unbind(0), dim=dim)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` from the first rank of this rank's model replica (the ranks
        that share its ``data`` coordinate), in place; a replica of one rank
        issues nothing."""
        if self._replica is not None:
            dist.broadcast(x, src=self._replica_src, group=self._replica)
            self.collectives["broadcast"] += 1
        return x

    def replica_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over this rank's model replica (no autograd)."""
        if self._replica is None:
            return x
        x = x.contiguous()
        dist.all_reduce(x, group=self._replica)
        self.collectives["all_reduce"] += 1
        return x


def make_mesh(data: int = 1, fsdp: int = -1, tensor: int = 1, context: int = 1,
              device_type: Optional[str] = None) -> Mesh:
    """A (data, fsdp[, context], tensor) mesh over the initialized process
    group's ranks, in rank order; ``fsdp=-1`` absorbs the rest. The device
    type follows the backend (cuda under NCCL, else cpu) unless given."""
    n = dist.get_world_size()
    if fsdp == -1:
        fsdp = n // (data * tensor * context)
    if data * fsdp * context * tensor != n:
        raise ValueError(f"mesh {data}x{fsdp}x{context}x{tensor} != {n} processes")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import init_device_mesh

    if context == 1:
        shape, names = (data, fsdp, tensor), AXES
    else:
        shape, names = (data, fsdp, context, tensor), ("data", "fsdp", "context", "tensor")
    return Mesh(init_device_mesh(device_type, shape, mesh_dim_names=names))


# Path-pattern -> placement, first match wins (JAX's PARAM_RULES, the same
# patterns in the same order; its comments say why each is so).
PARAM_RULES: list[tuple[str, tuple]] = [
    (r"text/layers/\d+/(q_w|k_w|v_w|gate_w|up_w)(/base)?/(w_q|w_p)$", ("fsdp", "tensor")),
    (r"text/layers/\d+/(o_w|down_w)(/base)?/w_p$", (None, "tensor")),
    (r"text/layers/\d+/(o_w|down_w)(/base)?/(w_q|w_p)$", ("tensor", "fsdp")),
    (r"text/lm_head(/base)?/(w_q|w_p)$", ("fsdp", "tensor")),
    (r"text/layers/\d+/(q_w|k_w|v_w|gate_w|up_w)(/base)?/scale$", (None, "tensor")),
    (r"text/layers/\d+/(o_w|down_w)(/base)?/scale$", (None, "fsdp")),
    (r"text/lm_head(/base)?/scale$", (None, "tensor")),
    (r"text/layers/\d+/(q_w|k_w|v_w|gate_w|up_w)/a$", ("fsdp", None)),
    (r"text/layers/\d+/(q_w|k_w|v_w|gate_w|up_w)/b$", (None, "tensor")),
    (r"text/layers/\d+/(o_w|down_w)/a$", ("tensor", None)),
    (r"text/layers/\d+/(o_w|down_w)/b$", (None, "fsdp")),
    (r"text/layers/\d+/(q_w|k_w|v_w)(/base)?$", ("fsdp", "tensor")),
    (r"text/layers/\d+/(q_b|k_b|v_b)$", ("tensor",)),
    (r"text/layers/\d+/o_w(/base)?$", ("tensor", "fsdp")),
    (r"text/layers/\d+/(gate_w|up_w)(/base)?$", ("fsdp", "tensor")),
    (r"text/layers/\d+/down_w(/base)?$", ("tensor", "fsdp")),
    (r"text/layers/\d+/router$", ("fsdp", None)),
    (r"text/layers/\d+/moe_fc1$", ("tensor", "fsdp", None)),
    (r"text/layers/\d+/moe_fc2$", ("tensor", None, "fsdp")),
    (r"text/layers/\d+/(input_norm|post_norm)$", ()),
    (r"text/embed_tokens$", ("tensor", "fsdp")),
    (r"text/lm_head(/base)?$", ("fsdp", "tensor")),
    (r"text/final_norm$", ()),
    (r"visual/blocks/\d+/(qkv_w|gate_w|up_w|fc1_w)/w_q$", ("fsdp", "tensor")),
    (r"visual/blocks/\d+/(proj_w|down_w|fc2_w)/w_q$", ("tensor", "fsdp")),
    (r"visual/blocks/\d+/(qkv_w|gate_w|up_w|fc1_w)/scale$", (None, "tensor")),
    (r"visual/blocks/\d+/(proj_w|down_w|fc2_w)/scale$", (None, "fsdp")),
    (r"visual/blocks/\d+/qkv_w$", ("fsdp", "tensor")),
    (r"visual/blocks/\d+/qkv_b$", ("tensor",)),
    (r"visual/blocks/\d+/proj_w$", ("tensor", "fsdp")),
    (r"visual/blocks/\d+/(gate_w|up_w|fc1_w)$", ("fsdp", "tensor")),
    (r"visual/blocks/\d+/(gate_b|up_b|fc1_b)$", ("tensor",)),
    (r"visual/blocks/\d+/(down_w|fc2_w)$", ("tensor", "fsdp")),
    (r"visual/patch_embed$", (None, "fsdp")),
    (r"visual/pos_embed$", (None, "fsdp")),
    (r"visual/(merger|deepstack/\d+)/fc1_w$", ("fsdp", "tensor")),
    (r"visual/(merger|deepstack/\d+)/fc1_b$", ("tensor",)),
    (r"visual/(merger|deepstack/\d+)/fc2_w$", ("tensor", "fsdp")),
    (r".*", ()),
]

# Attention leaves under head alignment: (pattern, the axis that runs over
# heads, which heads: "q", "kv" (the text decoder's) or "vision").
_HEAD_AXES = [
    (r"text/layers/\d+/(q_w|k_w|v_w)(/base)?(/w_q|/w_p|/scale|/b)?$", -1),
    (r"text/layers/\d+/(q_b|k_b|v_b)$", 0),
    (r"text/layers/\d+/o_w(/base)?(/w_q|/a)?$", 0),
    (r"visual/blocks/\d+/qkv_w(/w_q|/scale)?$", -1),
    (r"visual/blocks/\d+/qkv_b$", 0),
    (r"visual/blocks/\d+/proj_w(/w_q)?$", 0),
]
_KV = re.compile(r"text/layers/\d+/(k_w|v_w|k_b|v_b)")
_QKV = re.compile(r"visual/blocks/\d+/qkv_(w|b)")


def _children(leaf) -> Optional[list]:
    """A quantized or LoRA weight's stored children, named as JAX's pytree
    keys."""
    if isinstance(leaf, QuantizedLinear):
        return [("w_q", leaf.w_q), ("scale", leaf.scale)]
    if isinstance(leaf, Int4Linear):
        return [("w_p", leaf.w_p), ("scale", leaf.scale)]
    if isinstance(leaf, LoraLinear):
        return [("base", leaf.base), ("a", leaf.a), ("b", leaf.b), ("scale", leaf.scale)]
    return None


def _walk(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over dicts and lists, quantized and LoRA weights
    walked into (their spec trees are dicts of their children's)."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(fn, v, f"{path}/{i}" if path else str(i)) for i, v in enumerate(tree)]
    kids = _children(tree)
    if kids is not None:
        return {name: _walk(fn, v, f"{path}/{name}") for name, v in kids}
    return fn(path, tree)


def _sizes(mesh) -> dict:
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """How attention splits over ``tensor`` (head alignment): ``text``
    "even" (q and kv heads divide), "kv_heads" (q heads divide, each rank
    holds the one KV head its query heads read) or "replicated"; ``vision``
    whether the tower's heads divide."""

    text: str
    vision: bool
    tensor: int

    def kv_heads(self, cfg_text, rank: int) -> tuple[int, int]:
        """(first, count) of the KV heads rank ``rank`` holds."""
        hq, hkv = cfg_text.num_attention_heads, cfg_text.num_key_value_heads
        qpr, g = hq // self.tensor, hq // hkv
        return rank * qpr // g, max(1, qpr // g)


def head_plan(cfg, tensor: int) -> HeadPlan:
    t = cfg.text
    hq, hkv = t.num_attention_heads, t.num_key_value_heads
    if hq % tensor:
        text = "replicated"
    elif hkv % tensor == 0:
        text = "even"
    elif (hq // hkv) % (hq // tensor) == 0:
        text = "kv_heads"
    else:
        text = "replicated"
    vheads = getattr(cfg.vision, "num_heads", None)
    return HeadPlan(text=text, vision=vheads is not None and vheads % tensor == 0,
                    tensor=tensor)


def _jax_spec(path: str, leaf, sizes: dict, rules) -> tuple:
    if getattr(leaf, "ndim", None) in (None, 0):
        return ()
    for pattern, spec in rules:
        if re.search(pattern, path):
            dims = []
            for i, axis in enumerate(spec):
                ok = axis is not None and i < leaf.ndim and leaf.shape[i] % sizes[axis] == 0
                dims.append(axis if ok else None)
            return tuple(dims)
    return ()


def _depart(path: str, spec: tuple, plan: Optional[HeadPlan]) -> tuple:
    """``spec`` under head alignment."""
    if plan is None:
        return spec
    for pattern, axis in _HEAD_AXES:
        if re.search(pattern, path):
            d = axis % len(spec) if spec else None
            if d is None or spec[d] != TENSOR:
                return spec
            vision = path.startswith("visual/")
            if (not plan.vision) if vision else plan.text == "replicated":
                new = None
            elif not vision and plan.text == "kv_heads" and _KV.search(path):
                new = HEADS
            else:
                return spec
            return spec[:d] + (new,) + spec[d + 1:]
    return spec


def param_sharding_rules(params, mesh, cfg=None, rules=None):
    """Placement tree matching ``params``: a tuple of axis names (or None)
    per dimension of each leaf; quantized and LoRA weights give a dict of
    their children's. ``mesh`` is a ``Mesh`` or anything with a ``shape``
    mapping. With ``cfg``, the head-alignment departure applies."""
    rules = rules if rules is not None else PARAM_RULES
    sizes = _sizes(mesh)
    plan = head_plan(cfg, sizes.get("tensor", 1)) if cfg is not None else None
    return _walk(lambda path, leaf: _depart(path, _jax_spec(path, leaf, sizes, rules), plan),
                 params)


# ------------------------------------------------------------------ placing


def _qkv_perm(n_cols: int, heads: int, tensor: int) -> torch.Tensor:
    """Column order of a [q|k|v] projection that puts each rank's heads'
    q, k and v together: [q_0|k_0|v_0|q_1|k_1|v_1|...]."""
    c = n_cols // 3
    per = c // tensor
    idx = [part * c + r * per + j for r in range(tensor) for part in range(3) for j in range(per)]
    return torch.tensor(idx, dtype=torch.long)


def _place(t: torch.Tensor, spec: tuple, path: str, mesh: Mesh, cfg, plan: HeadPlan):
    """This rank's shard of ``t`` under ``spec``."""
    original = t
    for d, axis in enumerate(spec):
        if axis == HEADS:
            first, count = plan.kv_heads(cfg.text, mesh.rank(TENSOR))
            hd = cfg.text.head_dim
            t = t.narrow(d, first * hd, count * hd)
        elif axis in (FSDP, TENSOR):
            if axis == TENSOR and _QKV.search(path):
                t = t.index_select(d, _qkv_perm(t.shape[d], cfg.vision.num_heads,
                                                mesh.shape[TENSOR]).to(t.device))
            n = mesh.shape[axis]
            if n > 1:
                per = t.shape[d] // n
                t = t.narrow(d, mesh.rank(axis) * per, per)
    # a copy of the shard only, so that the whole tensor can be freed; a
    # leaf that no axis split (a one-rank mesh) stays the caller's
    return t if t is original else t.clone()


# Column-parallel producers, and each row-parallel consumer's producer in
# the same dict: the consumer's input arrives split over ``tensor`` where
# its producer's output columns are split.
_PRODUCERS = {"q_w", "k_w", "v_w", "gate_w", "up_w", "qkv_w", "fc1_w"}
_CONSUMER_OF = {"o_w": "q_w", "down_w": "gate_w", "proj_w": "qkv_w", "fc2_w": "fc1_w"}


def _main_spec(spec):
    """The placement of a weight's main stored tensor."""
    if isinstance(spec, dict):
        return _main_spec(spec.get("base", spec.get("w_q", spec.get("w_p"))))
    return spec


def _n_cols(spec: tuple, shape: tuple, mesh: Mesh, cfg, plan: HeadPlan):
    """(first, count) of the output columns this rank holds under ``spec``,
    where N is split over ``tensor`` or over its KV heads."""
    if not spec or spec[-1] not in (TENSOR, HEADS):
        return None
    if spec[-1] == HEADS:
        first, count = plan.kv_heads(cfg.text, mesh.rank(TENSOR))
        return first * cfg.text.head_dim, count * cfg.text.head_dim
    per = shape[-1] // mesh.shape[TENSOR]
    return mesh.rank(TENSOR) * per, per


@torch.no_grad()
def shard_params(params, mesh: Mesh, cfg, rules=None):
    """The param tree on the mesh: each placed weight (2-D and up) as a
    ``Sharded`` local shard, other leaves sliced to this rank, leaves placed
    nowhere unchanged. ``cfg`` gives the heads the alignment needs. The
    shards are new leaves: a trainer marks them trainable after."""
    specs = param_sharding_rules(params, mesh, cfg, rules)
    plan = head_plan(cfg, mesh.shape.get("tensor", 1))

    def weight(leaf, spec, path, name, x_split):
        out_full = name not in _PRODUCERS
        if isinstance(leaf, LoraLinear):
            return LoraLinear(weight(leaf.base, spec["base"], path + "/base", name, x_split),
                              weight(leaf.a, spec["a"], path + "/a", "a", x_split),
                              weight(leaf.b, spec["b"], path + "/b", name, False),
                              leaf.scale)
        kids = _children(leaf)
        if kids is None:
            if not isinstance(leaf, torch.Tensor):
                return leaf
            if leaf.ndim < 2 or (not any(spec) and not x_split):
                return _place(leaf, spec, path, mesh, cfg, plan) if any(spec) else leaf
            parts, specs_ = {"w": leaf}, {"w": spec}
            kind, group = "tensor", 128
        else:
            parts, specs_ = dict(kids), dict(spec)
            kind = "int8" if isinstance(leaf, QuantizedLinear) else "int4"
            group = getattr(leaf, "group", 128)
        local = {k: _place(v, specs_[k], f"{path}/{k}" if kind != "tensor" else path, mesh, cfg,
                           plan) for k, v in parts.items()}
        return Sharded(local, specs_, kind, mesh, tuple(leaf.shape), group=group,
                       x_split=x_split, out_full=out_full,
                       n_cols=_n_cols(_main_spec(spec), tuple(leaf.shape), mesh, cfg, plan))

    def node(tree, spec, path):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                p = f"{path}/{k}" if path else str(k)
                producer = _CONSUMER_OF.get(k)
                x_split = (producer is not None and producer in tree
                           and (_main_spec(spec[producer]) or (None,))[-1] == TENSOR)
                if isinstance(v, (dict, list, tuple)):
                    out[k] = node(v, spec[k], p)
                else:
                    out[k] = weight(v, spec[k], p, k, x_split)
            return out
        if isinstance(tree, (list, tuple)):
            return [node(v, spec[i], f"{path}/{i}" if path else str(i)) if
                    isinstance(v, (dict, list, tuple)) else weight(v, spec[i], f"{path}/{i}",
                                                                  str(i), False)
                    for i, v in enumerate(tree)]
        return weight(tree, spec, path, path.rsplit("/", 1)[-1], False)

    return node(params, specs, "")


def _unplace(t: torch.Tensor, spec: tuple, path: str, mesh: Mesh, cfg, plan: HeadPlan):
    """The whole tensor from every rank's shard (``_place`` undone)."""
    for d, axis in reversed(list(enumerate(spec))):
        if axis == HEADS:
            full = mesh.gather_weight(t, TENSOR, d)
            hd, n = cfg.text.head_dim, mesh.shape[TENSOR]
            per = full.shape[d] // n
            cols = {}
            for r in range(n):
                first, count = plan.kv_heads(cfg.text, r)
                for j in range(count):
                    cols.setdefault(first + j, r * per + j * hd)
            idx = torch.cat([torch.arange(cols[h], cols[h] + hd) for h in sorted(cols)])
            t = full.index_select(d, idx.to(full.device))
        elif axis in (FSDP, TENSOR):
            if mesh.shape[axis] > 1:
                t = mesh.gather_weight(t, axis, d)
            if axis == TENSOR and _QKV.search(path):
                perm = _qkv_perm(t.shape[d], cfg.vision.num_heads, mesh.shape[TENSOR])
                t = t.index_select(d, torch.argsort(perm).to(t.device))
    return t


def gather_params(params, mesh: Mesh, cfg):
    """The unsharded tree (on every rank) from ``shard_params``' output:
    each weight gathered, the qkv permutation and the KV head selection
    undone, so an export gives back the original bytes. A bias takes the
    placement of its weight's output columns (``q_b`` of ``q_w``)."""
    plan = head_plan(cfg, mesh.shape.get("tensor", 1))

    def full(path, leaf):
        if isinstance(leaf, LoraLinear):
            return LoraLinear(full(path + "/base", leaf.base), full(path + "/a", leaf.a),
                              full(path + "/b", leaf.b), leaf.scale)
        if not isinstance(leaf, Sharded):
            return leaf
        parts = {k: _unplace(v, leaf.specs[k], path if leaf.kind == "tensor" else
                             f"{path}/{k}", mesh, cfg, plan) for k, v in leaf.parts.items()}
        if leaf.kind == "tensor":
            return parts["w"]
        if leaf.kind == "int8":
            return QuantizedLinear(parts["w_q"], parts["scale"])
        return Int4Linear(parts["w_p"], parts["scale"], leaf.group)

    def walk(tree, path):
        if isinstance(tree, (list, tuple)):
            return [walk(v, f"{path}/{i}" if path else str(i)) for i, v in enumerate(tree)]
        if not isinstance(tree, dict):
            return full(path, tree)
        out = {}
        for k, v in tree.items():
            p = f"{path}/{k}" if path else str(k)
            w = tree.get(k[:-2] + "_w") if k.endswith("_b") else None
            w = w.base if isinstance(w, LoraLinear) else w
            if (isinstance(v, torch.Tensor) and v.ndim == 1 and isinstance(w, Sharded)
                    and w.spec[-1] in (TENSOR, HEADS)):
                out[k] = _unplace(v, w.spec[-1:], p, mesh, cfg, plan)
            else:
                out[k] = walk(v, p)
        return out

    return walk(params, "")


# ------------------------------------------------------------------ training


def placements(params) -> dict:
    """id(tensor) -> (placement, path) of every stored tensor of a tree that
    ``shard_params`` placed: a ``Sharded`` weight's parts by their specs, a
    bias by its weight's output split (as ``gather_params`` reads it), any
    other tensor replicated (``()``). A tensor the tree does not hold (whole
    LoRA adapters) is replicated too."""
    out = {}

    def walk(tree, path):
        if isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{path}/{i}" if path else str(i))
            return
        if isinstance(tree, Sharded):
            for k, v in tree.parts.items():
                out[id(v)] = (tree.specs[k], path if tree.kind == "tensor" else f"{path}/{k}")
            return
        if not isinstance(tree, dict):
            return
        for k, v in tree.items():
            p = f"{path}/{k}" if path else str(k)
            w = tree.get(k[:-2] + "_w") if k.endswith("_b") else None
            if (isinstance(v, torch.Tensor) and v.ndim == 1 and isinstance(w, Sharded)
                    and w.spec[-1] in (TENSOR, HEADS)):
                out[id(v)] = (w.spec[-1:], p)
            elif isinstance(v, torch.Tensor):
                out[id(v)] = ((), p)
            else:
                walk(v, p)

    walk(params, "")
    return out


def _first_holder(mesh: Mesh, cfg) -> bool:
    """Whether this rank is the lowest ``tensor`` rank that holds its KV
    heads (``HEADS``)."""
    plan = head_plan(cfg, mesh.shape[TENSOR])
    r = mesh.rank(TENSOR)
    return r == 0 or plan.kv_heads(cfg.text, r)[0] != plan.kv_heads(cfg.text, r - 1)[0]


def owns(spec: tuple, mesh: Mesh, cfg) -> bool:
    """Whether this rank counts a leaf of placement ``spec`` in a sum over
    its model replica: once per distinct shard, a replicated leaf on the
    axis's first rank only."""
    for axis in (FSDP, "context", TENSOR):
        if axis not in mesh.shape or mesh.shape[axis] == 1:
            continue
        if axis == TENSOR and HEADS in spec:
            if not _first_holder(mesh, cfg):
                return False
        elif axis not in spec and mesh.rank(axis) != 0:
            return False
    return True


def _flat_reduce(grads: list, group, scale: Optional[float] = None) -> None:
    """Sum each gradient over ``group`` in place, one collective per dtype
    (then times ``scale``)."""
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=group)
        if scale is not None:
            flat.mul_(scale)
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def sync_grads(leaves: list, mesh: Mesh, cfg, where: dict) -> int:
    """After a backward on a mesh, every trained leaf's gradient made the
    whole model's gradient of the global batch's loss, the same on each rank
    that holds the leaf: summed over ``data`` (each data rank's loss counts
    its rows over the global normaliser), averaged over ``fsdp`` where fsdp
    does not split the leaf (its ZeRO-3 peers read the same rows; a split
    leaf's reduce-scatter already averaged it), summed over the ``tensor``
    ranks that share a KV head (``HEADS``: each holds the partial of its own
    query heads), and averaged over ``tensor`` where tensor does not split
    the leaf: each tensor rank holds its whole gradient, equal up to the
    order in which its inputs' collectives summed, and the mean keeps the
    replicas' updates identical; under context parallelism, summed over
    ``context`` too (each rank's gradient is its positions'). ``where`` is
    ``placements(params)``. Returns the collectives issued."""
    grads = [(x.grad, where.get(id(x), ((), ""))[0]) for x in leaves]
    n = 0
    if mesh.shape.get(TENSOR, 1) > 1:
        plan = head_plan(cfg, mesh.shape[TENSOR])
        first, count = plan.kv_heads(cfg.text, mesh.rank(TENSOR))
        hd, width = cfg.text.head_dim, cfg.text.num_key_value_heads * cfg.text.head_dim
        for g, spec in grads:
            if HEADS in spec:  # the KV heads are a leaf's last dimension
                full = g.new_zeros(g.shape[:-1] + (width,))
                full[..., first * hd:(first + count) * hd] = g
                dist.all_reduce(full, group=mesh.groups[TENSOR])
                g.copy_(full[..., first * hd:(first + count) * hd])
                n += 1
    for axis in (TENSOR, FSDP):
        if mesh.shape.get(axis, 1) > 1:
            rep = [g for g, spec in grads if axis not in spec and HEADS not in spec]
            if rep:
                _flat_reduce(rep, mesh.groups[axis], 1.0 / mesh.shape[axis])
                n += 1
    for axis in ("context", "data"):  # each rank's positions or rows: partial sums
        if mesh.shape.get(axis, 1) > 1:
            _flat_reduce([g for g, _ in grads], mesh.groups[axis])
            n += 1
    mesh.collectives["grad_sync"] += n
    return n


def replicate(tree, mesh: Mesh):
    """Every tensor of ``tree`` the same on each rank: rank 0's values
    broadcast (JAX places them replicated)."""
    def put(_, leaf):
        if isinstance(leaf, torch.Tensor):
            with torch.no_grad():  # trainable adapters are written in place
                dist.broadcast(leaf, src=0)
        return leaf

    _walk(put, tree)
    return tree


def replicate_scalars(tree, mesh: Mesh):
    """0-d tensors (step counters) broadcast from rank 0; other leaves
    unchanged (JAX commits them to the mesh, replicated)."""
    def put(_, leaf):
        if isinstance(leaf, torch.Tensor) and leaf.ndim == 0:
            with torch.no_grad():
                dist.broadcast(leaf, src=0)
        return leaf

    _walk(put, tree)
    return tree


def local_text_config(cfg_text, mesh: Mesh, cfg):
    """The decoder's config with this rank's KV heads: what its cache
    holds."""
    t = mesh.shape.get("tensor", 1)
    plan = head_plan(cfg, t)
    if plan.text == "replicated":
        return cfg_text
    _, count = plan.kv_heads(cfg.text, mesh.rank(TENSOR))
    return dataclasses.replace(cfg_text, num_key_value_heads=count)
