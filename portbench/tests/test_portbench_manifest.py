"""BENCHMARK.json against the benchmark's rules: keys, names, units,
limits of size, the files each entry names, and the per-layer metrics'
cells."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    assert 1 <= len(spec["command"]) <= 32 and all(one_line(w) for w in spec["command"])
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in spec["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in spec["paths"])


def test_names_units_and_keys(spec):
    names = {}
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[kind]:
            assert NAME.match(e["name"]), e["name"]
            assert (kind, e["name"]) not in names
            names[(kind, e["name"])] = e
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in spec["paths"]))
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert one_line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert one_line(m["layer"])


def test_every_config_is_used_and_its_file_holds_it(spec):
    used = {w["config"] for w in spec["workloads"]}
    files = [c["file"] for c in spec["configs"]]
    assert len(files) == len(set(files))
    for c in spec["configs"]:
        assert c["name"] in used
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and "assumed" in data


def test_every_cell_reports_setup_another_metric_and_a_layer(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for w in spec["workloads"]:
        mine = [n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2
        layers = [m for m in spec["per_layer"] if w["name"] in m.get("workloads", [])]
        assert layers
        for m in layers:
            assert m["moves"] in mine, (w["name"], m["name"])
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH_DIR / "limits" / f"{w['name']}.json").exists()


def test_per_layer_metrics_have_readers_and_listed_cells(spec):
    cells = {w["name"] for w in spec["workloads"]}
    by_layer: dict = {}
    for m in spec["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
        assert set(m["workloads"]) <= cells
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
    for m in spec["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_four_chip_cells_and_run_length_fit_the_check(spec):
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(spec["workloads"]) // 4)
    # A full check of 24 cells: 2 + 14 runs a cell, run_seconds + 60 each,
    # 2 x 90 s a cell to compile, 1200 s spare, within 43200 s.
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_limits_files_name_their_readings():
    for path in (BENCH_DIR / "limits").glob("*.json"):
        lim = json.loads(path.read_text())
        for name, entry in lim.items():
            assert {"limit", "lower", "upper"} <= set(entry), (path.name, name)
