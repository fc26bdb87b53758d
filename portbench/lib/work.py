"""The work a served call's inputs need, from their shapes: the tower's
patch grids, the prefill attention's forwards, the decode steps' contexts
and the prompt tokens that a shared prefix can serve. The counts of
``counts.py`` take these; no number of the program's enters them.
"""

from __future__ import annotations

from ..reference import inputs as ref_inputs
from .serve_check import VSTAR_PREFIX_KEYS, vstar_text

# The shortest common prefix that a prefix cache is worth serving (the
# engine's default ``prefix_cache_min``, the V-STAR eval's setting).
PREFIX_MIN = 256


def _prompt_ids(call: dict, arch) -> list:
    if call["entry"] != "vstar_item":
        return [list(r["ids"]) for r in call["requests"]]
    v = arch.vision
    h, w = call["frames"][0].shape[:2]
    rh, rw = ref_inputs.smart_resize(h, w, factor=v.patch * v.merge)
    count = (rh // v.patch) * (rw // v.patch) // v.unit
    return [ref_inputs.encode(ref_inputs.expand_pads(vstar_text(call, k), ref_inputs.IMAGE_PAD,
                                                     [count] * len(call["frames"])))
            for k in call["keys"]]


def _lcp(seqs) -> int:
    n = min(len(s) for s in seqs)
    for i in range(n):
        if any(s[i] != seqs[0][i] for s in seqs[1:]):
            return i
    return n


def call_work(call: dict, answers: list, arch) -> dict:
    """Shapes of one call: ``grids`` (one list per video), ``forwards``
    ((queries, keys) of each prefill row as the inputs need it: a shared
    prefix once), ``prompts`` (each prompt's tokens), ``shared`` (each
    prompt's tokens that a shared prefix holds), ``answers`` (tokens served
    per request)."""
    v = arch.vision
    ids = _prompt_ids(call, arch)
    lens = [len(x) for x in ids]
    shared = [0] * len(ids)
    if call["entry"] == "vstar_item":
        h, w = call["frames"][0].shape[:2]
        rh, rw = ref_inputs.smart_resize(h, w, factor=v.patch * v.merge)
        grids = [[(1, rh // v.patch, rw // v.patch)] * len(call["frames"])]
        members = [i for i, k in enumerate(call["keys"]) if k in VSTAR_PREFIX_KEYS]
        pl = min(_lcp([ids[i] for i in members]), min(lens[i] for i in members) - 1)
        if pl >= PREFIX_MIN:
            for i in members:
                shared[i] = pl
    else:
        grids = [[tuple(r["grid"])] for r in call["requests"]]
        pl = 0
    forwards = [(pl, pl)] if any(shared) else []
    forwards += [(n - s, n) for n, s in zip(lens, shared)]
    return {"grids": grids, "forwards": forwards, "prompts": lens, "shared": shared,
            "answers": [len(a) for a in answers]}
