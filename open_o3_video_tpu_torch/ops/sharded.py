"""A weight's local shard on a mesh, and its product with the collectives
that the placement needs (the port's counterpart of what GSPMD inserts for
``open_o3_video_tpu/parallel/mesh.py``'s rules, and of ``ops/int4.py``'s
``_sharded_int4_mm``).

``parallel.shard_params`` puts a ``Sharded`` where a placed weight was. It
holds this rank's shard of each stored tensor (a plain weight's, or an int8
or int4 weight's bytes and scale) with its placement: a tuple with one entry
per dimension, a mesh axis ("fsdp", "tensor"), ``HEADS`` (the KV heads that
this rank's query heads read, possibly also held by its neighbours) or None.
``quant.dense`` hands it ``x`` and gets back:

- the ``fsdp`` axis gathered before use (ZeRO-3), except an int4 weight
  split on K over ``fsdp`` into whole quant groups: then the kernel runs on
  the local rows and the partials are summed over ``fsdp``;
- a K split over ``tensor`` (row-parallel: o, down, the tower's proj, down
  and fc2, the merger's fc2) run on the local K columns of ``x``, the
  partial products summed by one all-reduce over ``tensor``;
- an N split over ``tensor`` (column-parallel) gives the local columns, and
  where the layer's output must be whole (``out_full``: an int4 o or down,
  whose packed rows JAX keeps column-parallel, and the lm_head) one
  all-gather over ``tensor``;
- ``x_split``: the input arrives split over ``tensor`` along K (the local
  heads of an attention, the local columns of an MLP); a weight that is not
  split on K over ``tensor`` first gathers it.

Every kernel sees plain local tensors: K7 runs on the local shard of the
packed weight, never on a gathered copy. Resharding a weight (a gather or a
slice over an axis) is skipped where that axis has one rank; the
activations' collectives run on every mesh, so a one-rank mesh issues
them too (identities).
"""

from __future__ import annotations

from typing import Optional

import torch

FSDP, TENSOR = "fsdp", "tensor"
# A KV projection's columns where the KV heads do not divide over
# ``tensor``: each rank holds the heads that its query heads read.
HEADS = "tensor/heads"


class Sharded:
    """This rank's shard of one weight. ``parts`` maps the stored tensors'
    names ("w" for a plain weight; "w_q", "scale" for int8; "w_p", "scale"
    for int4) to their local shards, ``specs`` to their placements;
    ``shape`` is the logical weight's global shape."""

    def __init__(self, parts: dict, specs: dict, kind: str, mesh, shape: tuple, *,
                 group: int = 128, x_split: bool = False, out_full: bool = True,
                 n_cols: Optional[tuple[int, int]] = None):
        self.parts, self.specs, self.kind, self.mesh = parts, specs, kind, mesh
        self.shape, self.group = tuple(shape), group
        self.x_split, self.out_full = x_split, out_full
        # (first, count) of the output columns this rank holds, where N is
        # split over ``tensor`` or its KV heads (``HEADS``)
        self.n_cols = n_cols
        self._int8 = {}  # (k_to, n_to) -> the int8 weight, where nothing is gathered

    @property
    def main(self) -> str:
        return {"tensor": "w", "int8": "w_q", "int4": "w_p"}[self.kind]

    @property
    def spec(self) -> tuple:
        return self.specs[self.main]

    @property
    def dtype(self):
        return self.parts[self.main].dtype

    @property
    def device(self):
        return self.parts[self.main].device

    def __repr__(self):
        return f"Sharded({self.kind}, shape={self.shape}, spec={self.spec})"

    # ------------------------------------------------------------ resharding

    def _to(self, name: str, target: tuple) -> torch.Tensor:
        """The local shard of part ``name`` resharded to ``target``: an axis
        the part is split over and the target is not is gathered; an axis
        the target splits and the part does not is sliced."""
        t, spec = self.parts[name], self.specs[name]
        for d, (have, want) in enumerate(zip(spec, target)):
            if have == want:
                continue
            if have in (FSDP, TENSOR) and self.mesh.shape[have] > 1:
                t = self.mesh.gather_weight(t, have, d)
            if want in (FSDP, TENSOR) and self.mesh.shape[want] > 1:
                n = t.shape[d] // self.mesh.shape[want]
                t = t.narrow(d, self.mesh.rank(want) * n, n)
        return t

    def local(self) -> torch.Tensor:
        """The plain weight with ``fsdp`` gathered and its ``tensor`` split
        kept (the experts' stacks, a position table)."""
        assert self.kind == "tensor"
        return self._to("w", tuple(None if a == FSDP else a for a in self.spec))

    def _leaf(self, k_to, n_to):
        """The weight to multiply, at placement (k_to, n_to)."""
        from .int4 import Int4Linear
        from .quant import QuantizedLinear

        if self.kind == "tensor":
            return self._to("w", (k_to, n_to))
        if self.kind == "int8":
            # QuantizedLinear lays its bytes out for torch._int_mm once; that
            # layout is kept unless a gather (ZeRO-3) made the bytes
            key = (k_to, n_to)
            if key in self._int8:
                return self._int8[key]
            w = QuantizedLinear(self._to("w_q", key), self._to("scale", (None, n_to)))
            if self.mesh.shape.get(FSDP, 1) == 1:
                self._int8[key] = w
            return w
        return Int4Linear(self._to("w_p", (k_to, n_to)), self._to("scale", (k_to, n_to)),
                          self.group)

    # --------------------------------------------------------------- product

    def dense(self, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        from .quant import dense

        m = self.mesh
        k_ax, n_ax = self.spec
        # An int4 K split over fsdp runs on the local rows when each shard
        # holds whole quant groups (the kernel scales group by group);
        # otherwise, and for every other weight, fsdp is gathered first.
        n_groups = self.shape[0] // self.group
        k_partial = (k_ax == TENSOR or (k_ax == FSDP and self.kind == "int4"
                                         and m.shape[FSDP] > 1 and n_groups % m.shape[FSDP] == 0))
        k_to = k_ax if k_partial else None
        n_to = n_ax if n_ax in (TENSOR, HEADS) else None
        if self.x_split and k_to != TENSOR:
            x = m.all_gather(x, TENSOR, dim=-1)
        if not (self.x_split and k_to == TENSOR):
            # x is replicated; under autograd, each rank's part of its
            # gradient is summed over the axes its compute differs on
            for axis in {k_to, TENSOR if n_to in (TENSOR, HEADS) else None} - {None}:
                x = m.copy_in(x, axis)
            if k_to is not None:
                n = x.shape[-1] // m.shape[k_to]
                x = x.narrow(-1, m.rank(k_to) * n, n)
        y = dense(x, self._leaf(k_to, n_to), impl)
        if k_to is not None:
            y = m.all_reduce(y, k_to)
        if n_to == TENSOR and self.out_full:
            y = m.all_gather(y, TENSOR, dim=-1)
        return y

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of an embedding table split over the vocabulary on
        ``tensor``: each rank looks up the ids in its range, zeros the
        others, and one all-reduce over ``tensor`` sums them (exact: one
        term per id is not zero)."""
        table = self._to("w", (self.spec[0], None))
        if self.spec[0] != TENSOR:
            return table[ids]
        m = self.mesh
        lo = m.rank(TENSOR) * table.shape[0]
        rel = ids - lo
        mine = (rel >= 0) & (rel < table.shape[0])
        rows = table[rel.clamp(0, table.shape[0] - 1)]
        rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                               device=rows.device))
        return m.all_reduce(rows, TENSOR)


def lora_views(base: Sharded, a: torch.Tensor, b: torch.Tensor) -> tuple[Sharded, Sharded]:
    """Whole LoRA adapters (replicated on every rank, as JAX's ``replicate``
    places them) as the products over a sharded ``base`` read them: ``a``'s
    rows split over ``tensor`` where the base's K is (o, down), ``b``'s
    columns where the base's N is (q, k, v, gate, up; a KV projection's
    heads under ``HEADS``), an ``fsdp`` split of the base read whole. The
    slices are taken under autograd after ``copy_in``, so each adapter's
    gradient is summed wherever the base product is split."""
    m = base.mesh
    k_ax, n_ax = base.spec
    a_spec = (TENSOR if k_ax == TENSOR else None, None)
    b_spec = (None, n_ax if n_ax in (TENSOR, HEADS) else None)
    if a_spec[0] == TENSOR and m.shape[TENSOR] > 1:
        per = a.shape[0] // m.shape[TENSOR]
        a = m.copy_in(a, TENSOR).narrow(0, m.rank(TENSOR) * per, per)
    if b_spec[1] is not None and base.n_cols is not None and base.n_cols[1] != b.shape[1]:
        b = m.copy_in(b, TENSOR).narrow(1, *base.n_cols)
    return (Sharded({"w": a}, {"w": a_spec}, "tensor", m, tuple(a.shape), x_split=base.x_split),
            Sharded({"w": b}, {"w": b_spec}, "tensor", m, tuple(b.shape),
                    out_full=base.out_full, n_cols=base.n_cols))


def local(w) -> torch.Tensor:
    """A weight used other than through ``dense``, as a plain tensor:
    itself, or a ``Sharded`` weight's ``local()``."""
    return w.local() if isinstance(w, Sharded) else w


def expert_range(w) -> Optional[tuple[int, int]]:
    """(first, count) of the experts this rank holds of a stack split over
    ``tensor`` on its expert axis; None where every rank holds them all."""
    if not isinstance(w, Sharded) or w.spec[0] != TENSOR:
        return None
    n = w.shape[0] // w.mesh.shape[TENSOR]
    return w.mesh.rank(TENSOR) * n, n
