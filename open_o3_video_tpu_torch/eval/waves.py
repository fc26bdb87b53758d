"""Decode waves for the eval wrappers (``QwenVLEngine``, ``EngineJudge``).

The JAX engine streams a call's requests through ``max_slots``
continuous-batching decode slots (8 by default); the port's engine runs all
of a call's requests as one left-padded batch. So a request list is cut into
waves of ``max_slots``, run one after another in order, as the JAX engine
fills its slots in order.
"""

from __future__ import annotations

import collections
import time
from typing import Optional, Sequence

MAX_SLOTS = 8  # the JAX engine's default decode slots


def split_waves(requests: Sequence, max_slots: int) -> list[list]:
    """``requests`` in order, cut into full waves of ``max_slots`` (the last
    may be shorter). An item whose requests straddle two waves is encoded
    in both: at V-STAR's shapes full waves of 8 beat waves of 5 that keep an
    item's queries together by ~20% (``scripts/exp_eval_waves_torch.py``)."""
    return [list(requests[i : i + max_slots]) for i in range(0, len(requests), max_slots)]


def generate_in_waves(engine, requests: Sequence, sampling, max_slots: int = MAX_SLOTS,
                      waves: Optional[list] = None) -> list[dict]:
    """``engine.generate`` over ``requests`` wave by wave; the outputs in
    order. Where ``waves`` is a list, each wave appends its record to it and
    prints it: requests, tower passes (distinct patch arrays), seconds, and
    the seconds of each engine stage within it."""
    outs: list[dict] = []
    for wave in split_waves(requests, max_slots):
        before = collections.Counter(engine.stage_seconds)
        t0 = time.perf_counter()
        outs.extend(engine.generate(wave, sampling))
        if waves is None:
            continue
        stages = collections.Counter(engine.stage_seconds)
        stages.subtract(before)
        passes = len({id(r.pixel_patches) for r in wave if r.pixel_patches is not None})
        waves.append({"requests": len(wave), "tower_passes": passes,
                      "seconds": time.perf_counter() - t0,
                      "stage_seconds": {k: v for k, v in stages.items() if v}})
        print(f"[eval] wave of {len(wave)} requests: {passes} tower passes, "
              f"{waves[-1]['seconds']:.3f} s, stages "
              + ", ".join(f"{k} {v:.3f} s" for k, v in waves[-1]["stage_seconds"].items()))
    return outs
