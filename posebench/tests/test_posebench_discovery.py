"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file by the harness."""

import json
import re

import pytest

from posebench.harness import ROOT, Cell, load_module

B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(B["paths"]) <= 16 and len(B["command"]) <= 32
    for p in B["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert all(_line(w) for w in B["command"])
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    n = 24                                  # the contract's largest benchmark
    assert (2 + 14 * n) * (B["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    assert len(json.dumps(B)) <= 64 * 1024


def test_names_units_and_entries():
    names = [c["name"] for c in B["configs"]] + CELLS
    metrics = B["end_to_end"] + B["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in B["configs"])) == len(B["configs"])
    assert len(set(CELLS)) == len(CELLS)
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    pairs = set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
        reported = [m for m in B["end_to_end"]
                    if w["name"] in m.get("workloads", CELLS)]
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in B["per_layer"])
    assert len(pairs) == len(B["workloads"])
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(
        1, len(B["workloads"]) // 4)
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert c in CELLS
            assert c in e2e[m["moves"]].get("workloads", CELLS)


def test_configs_are_files_under_paths():
    used = {w["config"] for w in B["workloads"]}
    files = set()
    for c in B["configs"]:
        assert c["name"] in used and _line(c["why"]) and _line(c["source"])
        assert any(c["file"].startswith(p + "/") for p in B["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        files.add(c["file"])
    assert len(files) == len(B["configs"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = Cell(cell)
    assert hasattr(c.generator_module(), "Session")
    assert hasattr(c.model_module(), "build")
    ref = c.reference_module()
    assert callable(ref.forward) and ref.param_specs(c.widths)
    assert c.spec["limits"] and int(c.spec["trace_iters"]) > 0
    assert c.per_layer and c.end_to_end


@pytest.mark.parametrize("metric", [m["name"] for m in B["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(load_module("metrics", metric).read)


def test_paths_hold_only_the_benchmark():
    for p in B["paths"]:
        for f in (ROOT / p).rglob("*"):
            if f.is_file() and "__pycache__" not in f.parts:
                assert re.match(r"^[A-Za-z0-9_./-]+$",
                                str(f.relative_to(ROOT))), f
                assert f.suffix in (".py", ".json", ".md"), f
