"""The work a Kimi-VL session call's inputs need, from their shapes (as
``work.call_work`` for the Qwen cells): the tower's grids, the prefill
forwards (the shared video prefix once, then each prompt's suffix), the
prompts, the tokens a shared prefix holds and the answers."""

from __future__ import annotations

from .work import PREFIX_MIN, _lcp


def call_work(call: dict, answers: list, arch) -> dict:
    ids = [list(r["ids"]) for r in call["requests"]]
    lens = [len(x) for x in ids]
    pl = min(_lcp(ids), min(lens) - 1) if len(ids) > 1 else 0
    shared = [pl] * len(ids) if pl >= PREFIX_MIN else [0] * len(ids)
    forwards = [(pl, pl)] if any(shared) else []
    forwards += [(n - s, n) for n, s in zip(lens, shared)]
    return {"grids": [[tuple(call["grid"])]], "forwards": forwards, "prompts": lens,
            "shared": shared, "answers": [len(a) for a in answers]}
