"""The check must fail what it exists to catch: a run of a serving cell on
the CPU at a tiny size, with the harness's look for a card skipped and the
cell's own limits, with the answers altered where the program produces
them, and judging the control (the reference computed in float8 e4m3) in
the program's place."""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

import tiny
from portbench.lib import serve_check
from portbench.runners import serve

BENCH_DIR = Path(__file__).resolve().parents[1]
CELLS = [(tiny.qwen25, "vstar", "vstar.qwen25vl-7b"),
         (tiny.qwen3_moe, "video8", "serve.qwen3vl-30b-a3b")]


def run(config, mix, cell, seed, judge=None, max_tokens=None):
    m = tiny.mix(mix)
    m["max_tokens"] = max_tokens or m["max_tokens"]
    files = {"config": config(), "mix": m,
             "limits": json.loads((BENCH_DIR / "limits" / f"{cell}.json").read_text())}
    return serve.run(cell, files, [], seed, 0.01, False, torch.device("cpu"),
                           time.perf_counter(), judge=judge)


@pytest.mark.parametrize("config,mix,cell", CELLS, ids=[c for _, _, c in CELLS])
def test_a_token_altered_where_it_is_produced_is_not_correct(config, mix, cell, monkeypatch):
    from open_o3_video_tpu_torch.engine import engine as engine_mod

    sample = engine_mod.sample_token

    def altered(gen, logits, **kw):  # every answer's tokens: the least likely instead
        sample(gen, logits, **kw)
        return logits.argmin(-1)

    assert run(config, mix, cell, 2**31 + 1)["correct"]
    monkeypatch.setattr(engine_mod, "sample_token", altered)
    r = run(config, mix, cell, 2**31 + 1)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("seed", [7, 2**31 + 11, 2**32 + 5])
@pytest.mark.parametrize("config,mix,cell", CELLS, ids=[c for _, _, c in CELLS])
def test_the_float8_control_reads_wider_than_the_program(config, mix, cell, seed, monkeypatch):
    """At this size the readings lie far under the cell's limits (set from
    the card at the cell's size, where the control fails them); what holds
    here, over 2 answers of 32 tokens, is the order: on the number whose
    upper reading the control gives, its reading is more than twice the
    program's. The per-token distances are about ten times smaller here
    than at the cell's size (the program's log-probabilities 0.001 off the
    reference's, not 0.013), so ``off_share`` counts a token off at a tenth
    of its threshold."""
    monkeypatch.setattr(serve_check, "OFF", serve_check.OFF / 10)
    limits = json.loads((BENCH_DIR / "limits" / f"{cell}.json").read_text())
    name = next(n for n, lim in limits.items() if lim["upper_from"] == "fp8")
    prog = run(config, mix, cell, seed, max_tokens=32)["check"][name]
    ctrl = run(config, mix, cell, seed, judge="fp8", max_tokens=32)["check"][name]
    assert ctrl > 2 * prog and ctrl > 5e-3, (name, prog, ctrl)
