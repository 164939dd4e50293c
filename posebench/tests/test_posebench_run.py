"""The run's result line, its refusal without a card, and the planted
faults and the control turning `correct` false. The harness's look for a
card is skipped (device="cpu") and the cells are cut to a tiny size;
every other step of a run is the benchmark's own."""

import json
import subprocess
import sys

import pytest
import torch

from posebench.harness import ROOT, Cell, judge, run_cell

TINY = {"widths": {"image_size": [64, 64], "heatmap_size": [16, 16]},
        "traffic": {"batch": 8, "pool_batches": 3, "sample_requests": 2},
        "port": {"train.mixed_precision": False}}
SEED = 2 ** 33 + 12345          # wider than 32 bits, as a check's seeds are


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, fault=None, trace=False):
    return run_cell(cell, SEED, 0.3, trace, device="cpu", overrides=TINY,
                    fault=fault, check_modules=False, log=lambda *a, **k: None)


def test_result_line_keys_in_order():
    r = _run("vitpose-s-serve-flip-b128")
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "setup", "compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"serve_img_s", "serve_p95_ms", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert set(r["compared"]) == set(Cell(
        "vitpose-s-serve-flip-b128").spec["limits"])
    json.loads(json.dumps(r))


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be seen here")
    p = subprocess.run([sys.executable, "posebench/run.py", "--workload",
                        "r50-serve-flip-b128", "--seed", str(SEED),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_judge():
    ok, shown = judge({"a": 0.1, "b": 0.2}, {"a": 0.5, "b": 0.1})
    assert not ok and shown == {"a": {"value": 0.1, "limit": 0.5},
                                "b": {"value": 0.2, "limit": 0.1}}
    assert not judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not judge({}, {"a": 1.0})[0]
    assert judge({"a": 1.0}, {"a": 1.0})[0]


SOUND = ["r50-serve-flip-b128", "vitpose-s-serve-flip-b128",
         "r50-train-b64"]
FAULTS = [("r50-serve-flip-b128", "answer_altered"),
          ("r50-serve-flip-b128", "half_batch"),
          ("vitpose-s-serve-flip-b128", "answer_altered"),
          ("vitpose-s-serve-flip-b128", "half_batch"),
          ("r50-train-b64", "unchanged"),
          ("r50-train-b64", "half_batch")]


@pytest.mark.parametrize("cell", SOUND)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["compared"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_is_not_correct(cell, fault):
    r = _run(cell, fault)
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("cell", SOUND)
def test_control_is_not_correct(cell):
    """The reference in fp8 in the program's place fails the cell's
    limits."""
    c = Cell(cell, TINY)
    s = c.generator_module().Session(c, SEED, torch.device("cpu"))
    s.warm_up()
    for i in range(2):
        s.call(i)
    s.finish()
    s.release()
    ok, shown = judge(s.check(quant=True), c.spec["limits"])
    assert not ok, shown
