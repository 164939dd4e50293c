"""The port's layer spans and copy counter (tpupose_torch/utils/trace.py):
host times always, profiler ranges and CUDA events only under a profiler
or after `enable()`; where the serving request and the train steps open
them; none in an exported program; the benchmark's nine readers of them
(posebench/metrics/); and `train.profile_dir`'s one-step chrome trace.

Bounds: a span's host part costs at most 2 us: the best loop of 1,000
spans within 10 s, in the thread's CPU time (a busy neighbour on a shared
host slows the loops up to twofold for seconds at a time); everything
else is exact.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tpupose_torch.utils
from posebench.harness import load_module
from tpupose_torch.configs.default import OptimizerConfig, default_config
from tpupose_torch.engine.evaluator import TopDownEvaluator, pageable_bytes
from tpupose_torch.engine.optimizers import make_optimizer
from tpupose_torch.engine.predictor import HeatmapPredictor
from tpupose_torch.engine.train_state import (TrainState,
                                              make_heatmap_train_step,
                                              make_simcc_train_step)
from tpupose_torch.losses.heatmap import joints_mse_loss
from tpupose_torch.losses.simcc import simcc_kl_loss
from tpupose_torch.models.simcc import SimCCPose
from tpupose_torch.models.simple_baseline import SimpleBaseline
from tpupose_torch.utils import trace

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
K, HW, HM = 4, (64, 64), (16, 16)
PAIRS = np.array([(1, 2)])
SERVE = ["serve.h2d", "serve.model", "serve.post", "serve.post",
         "serve.d2h"]
TRAIN = ["train.input", "train.forward", "train.backward", "train.update"]
EVENTS = trace._events


@pytest.fixture(autouse=True)
def fresh_records():
    trace._records.clear()
    trace.enable(False)
    yield
    trace.enable(False)
    trace._records.clear()


def _model():
    torch.manual_seed(0)
    return SimpleBaseline("resnet18", K, (16, 16, 16), dtype=torch.float32,
                          device="cpu", param_dtype=torch.float32)


def _crops(n=2, seed=0):
    rs = np.random.default_rng(seed)
    return (rs.integers(0, 256, (n, *HW, 3), dtype=np.uint8),
            rs.uniform(20, 40, (n, 2)).astype(np.float32),
            rs.uniform(40, 80, (n, 2)).astype(np.float32))


def _tree(recs, root_name):
    """{root id: (root record, its spans in the order they closed)}."""
    roots = {r[1]: r for r in recs if r[0] == root_name and r[7] is not None}
    return {rid: (r, [x for x in recs if x[1] == rid and x is not r])
            for rid, r in roots.items()}


def test_span_records_host_times_only_and_costs_at_most_2us(monkeypatch):
    """No profiler and no enable(): host times and counts, no profiler
    range, no events; one span's host part costs at most 2 us."""
    opened = []
    monkeypatch.setattr(trace, "record_function",
                        lambda name: opened.append(name))
    with trace.root("r"):
        with trace.span("a"):
            trace.count("c", 3)
        with trace.span("a"):
            trace.count("c", 4)
    trace.count("c", 100)                      # outside a root: dropped
    recs = list(trace._records)
    assert [(r[0], r[2]) for r in recs] == [("a", "r"), ("a", "r"),
                                            ("r", None)]
    assert len({r[1] for r in recs}) == 1
    assert all(r[5] is False and r[6] is None for r in recs)
    assert recs[2][7] == {"c": 7} and recs[0][7] is None
    assert not opened
    s = trace.summary()
    assert s["roots"] == 1 and s["counts"] == {"c": 7}
    assert s["host_ms"]["a"] == pytest.approx(
        sum(r[4] - r[3] for r in recs[:2]) * 1e-6)
    assert s["device_ms"] == {"a": None, "r": None}

    n, best, give_up = 1000, float("inf"), time.monotonic() + 10.0
    with trace.root("r"):
        while best > 2000 and time.monotonic() < give_up:
            t0 = time.thread_time_ns()
            for _ in range(n):
                with trace.span("s"):
                    pass
            best = min(best, (time.thread_time_ns() - t0) / n)
    print(f"one span: {best / 1e3:.3f} us")
    assert best <= 2000


def test_request_spans_under_the_profiler():
    """One HeatmapPredictor call (flip test) under torch.profiler: one
    serve.request root holding h2d, model, post (merge), post (decode and
    back-projection), d2h in that order; their tpupose.serve.* ranges sit
    directly under the caller's range (the root opens none)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    pred = HeatmapPredictor(_model(), HM, flip_test=True, flip_pairs=PAIRS,
                            device="cpu")
    imgs, c, s = _crops()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            pred(imgs, c, s)
    (root, kids), = _tree(list(trace._records), "serve.request").values()
    assert [k[0] for k in kids] == SERVE
    assert all(k[2] == "serve.request" and k[5] and k[6] is None
               for k in kids)
    assert [k[3] for k in kids] == sorted(k[3] for k in kids)
    assert root[3] <= kids[0][3] and kids[-1][4] <= root[4]
    assert root[7] == {}                       # no copy to a card
    ranges = [e for e in prof.events() if e.name.startswith("tpupose.")]
    assert sorted(e.name for e in ranges) == sorted(
        "tpupose." + n for n in SERVE)
    assert all(e.cpu_parent is not None and e.cpu_parent.name == "caller"
               for e in ranges)


def test_pageable_bytes_counts_numpy_and_unpinned_cpu_tensors():
    imgs = np.zeros((128, 256, 192, 3), np.uint8)
    ctr = np.zeros((128, 2), np.float32)
    assert pageable_bytes(imgs, ctr, torch.zeros(128, 2)) == 18_876_416
    assert pageable_bytes([1.0, 2.0]) == 0


def _heatmap_case():
    step = make_heatmap_train_step(
        joints_mse_loss, color_jitter_strength=0.2, heatmap_size=HM,
        affine_rotation=30.0, affine_scale=0.25)
    return _model(), step, HM


def _simcc_case():
    torch.manual_seed(0)
    model = SimCCPose("resnet18", K, 2.0, image_size=HW,
                      dtype=torch.float32, device="cpu",
                      param_dtype=torch.float32)
    bins = (2 * HW[0], 2 * HW[1])
    step = make_simcc_train_step(simcc_kl_loss, bins,
                                 color_jitter_strength=0.2,
                                 affine_rotation=30.0, affine_scale=0.25)
    return model, step, bins


@pytest.mark.parametrize("case", [_heatmap_case, _simcc_case],
                         ids=["heatmap", "simcc"])
def test_train_step_spans(case):
    """One train step records input, forward, backward, update under one
    train.step root, host times only."""
    model, step, grid = case()
    opt = make_optimizer(OptimizerConfig(name="adam"),
                         model.named_parameters(), grad_clip_norm=10.0)
    state = TrainState(model, opt)
    rs = np.random.default_rng(1)
    batch = {"images": torch.from_numpy(rs.integers(0, 256, (2, *HW, 3),
                                                    dtype=np.uint8)),
             "joints": torch.from_numpy(
                 rs.uniform(2, min(grid) - 2, (2, K, 2)).astype(np.float32)),
             "visibility": torch.ones(2, K)}
    step(state, batch)
    (root, kids), = _tree(list(trace._records), "train.step").values()
    assert [k[0] for k in kids] == TRAIN
    assert all(k[2] == "train.step" and not k[5] for k in kids)
    assert state.step == 1


def _reader(name):
    return load_module("metrics", name).read


READERS = {  # metric -> (its value from _records_of_a_run, what it reads)
    "h2d_host_ms.serve": (0.5, "host"),
    "h2d_pageable_mb.serve": (18.876416, "count"),
    "model_dev_ms.serve": (2.5, "device"),
    "post_dev_ms.serve": (5.0, "device"),       # two serve.post a request
    "d2h_wait_ms.serve": (0.5, "host"),
    "input_host_ms.train": (0.5, "host"),
    "forward_host_ms.train": (0.5, "host"),
    "backward_host_ms.train": (0.5, "host"),
    "update_host_ms.train": (0.5, "host"),
}


class _Event:
    """A CUDA event's stand-in: 2.5 ms from start to end."""

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 2.5


class _Clock:
    """perf_counter_ns's stand-in: `tick` ns further at every call, so a
    span with no span inside it lasts one tick."""

    def __init__(self):
        self.t, self.tick = 0, 0

    def __call__(self):
        self.t += self.tick
        return self.t


def _request(n_bytes):
    with trace.root("serve.request"):
        for name in SERVE:
            with trace.span(name):
                if name == "serve.h2d":
                    trace.count("serve.h2d_pageable_bytes", n_bytes)


def _step(n_bytes):
    with trace.root("train.step"):
        for name in TRAIN:
            with trace.span(name):
                pass


def _records_of_a_run(monkeypatch, call, cuda: bool):
    """Records as a --trace 1 run leaves them: 2 warm-up calls (tick 4
    ms, 1 byte counted), 3 window calls (tick 0.5 ms, 18,876,416 bytes),
    2 traced calls (device part on, tick 7 ms, 5 bytes; `cuda`: events
    of 2.5 ms). Returns what a reader reads of the Summary."""
    clock = _Clock()
    monkeypatch.setattr(trace, "_clock", clock)
    monkeypatch.setattr(trace, "_events", (lambda: (_Event(), _Event()))
                        if cuda else EVENTS)
    for tick, n_bytes, device, n in ((4_000_000, 1, False, 2),
                                     (500_000, 18_876_416, False, 3),
                                     (7_000_000, 5, True, 2)):
        clock.tick = tick
        trace.enable(device)
        for _ in range(n):
            call(n_bytes)
    trace.enable(False)
    return SimpleNamespace(host_iters=3, iters=2)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_its_span(monkeypatch, metric):
    """Each reader's value from records made here: host metrics from the
    window's roots (not the warm-up's, not the traced ones), device
    metrics from the traced roots' events; None off the card, and None
    where the program has no trace module (the parent commit)."""
    want, kind = READERS[metric]
    call = _request if metric.endswith(".serve") else _step
    s = _records_of_a_run(monkeypatch, call, cuda=True)
    assert _reader(metric)(s) == pytest.approx(want, rel=1e-9)

    trace._records.clear()
    s = _records_of_a_run(monkeypatch, call, cuda=False)
    got = _reader(metric)(s)
    if kind == "device":
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-9)

    monkeypatch.delattr(tpupose_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "tpupose_torch.utils.trace", None)
    assert _reader(metric)(s) is None


def test_export_with_spans_enabled_holds_no_span(tmp_path):
    """With enable() on, the exported heatmap program has no profiler node
    and answers as the program exported without it; exporting records no
    span."""
    from tpupose_torch.engine import exporter

    ev = TopDownEvaluator(_model(), HM, flip_test=True, flip_pairs=PAIRS,
                          device="cpu")
    imgs, c, s = _crops()
    args = tuple(torch.from_numpy(a) for a in (imgs, c, s))
    plain = exporter.load_program(exporter.export_program(
        exporter.HeatmapProgram(ev), args, str(tmp_path / "plain.pt2")))
    trace.enable()
    path = exporter.export_program(exporter.HeatmapProgram(ev), args,
                                   str(tmp_path / "traced.pt2"))
    assert not trace._records
    gm = torch.export.load(path).graph_module
    targets = [str(n.target) for n in gm.graph.nodes
               if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t
                            or "record_function" in t]
    got = exporter.load_program(path)(*args)
    for a, b in zip(plain(*args), got):
        assert torch.equal(a, b)


def test_import_and_spans_load_no_dynamo():
    """The module and its spans, host part and device part, leave
    torch._dynamo unimported (its import costs seconds of set-up)."""
    code = "\n".join([
        "import sys",
        "from tpupose_torch.utils import trace",
        "for on in (False, True):",
        "    trace.enable(on)",
        "    with trace.root('r'):",
        "        with trace.span('s'):",
        "            trace.count('c', 1)",
        "print(trace.summary()['roots'], 'torch._dynamo' in sys.modules)"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["2", "False"]


def test_spans_nest_per_thread_and_lose_no_record():
    """More threads than cores, each opening roots with two spans and
    counts, a short switch interval: every record kept, each span under
    its own thread's root, every root's counts its own."""
    n_threads, n_roots = 2 * (os.cpu_count() or 4), 150

    def work():
        for _ in range(n_roots):
            with trace.root("r"):
                with trace.span("a"):
                    trace.count("c", 1)
                with trace.span("b"):
                    trace.count("c", 2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    recs = list(trace._records)
    assert len(recs) == 3 * n_threads * n_roots
    tree = _tree(recs, "r")
    assert len(tree) == n_threads * n_roots
    for root, kids in tree.values():
        assert [(k[0], k[2]) for k in kids] == [("a", "r"), ("b", "r")]
        assert root[7] == {"c": 3}
    assert trace.summary()["counts"] == {"c": 3}


def test_profile_dir_writes_one_step_trace(tmp_path):
    """train.profile_dir: step 10 of epoch 0 under torch.profiler, its
    chrome trace in the directory, with the step's tpupose.train.* spans
    among its ranges."""
    from tpupose_torch.engine.trainer import Trainer

    cfg = default_config()
    cfg.model.backbone = "resnet18"
    cfg.model.num_keypoints = K
    cfg.model.heatmap_size = HM
    cfg.model.deconv_channels = (16, 16, 16)
    cfg.data.image_size = HW
    cfg.data.device_affine = True
    cfg.data.num_workers = 0
    cfg.train.batch_size = 16
    cfg.train.epochs = 1
    cfg.train.warmup_epochs = 0
    cfg.train.mixed_precision = False
    cfg.train.log_interval = 100
    cfg.train.tensorboard = False
    cfg.train.output_dir = str(tmp_path / "out")
    cfg.train.profile_dir = str(tmp_path / "prof")
    tr = Trainer(cfg, device="cpu")
    assert tr.steps_per_epoch > 10
    tr.iter_one_epoch(0)
    (path,) = (tmp_path / "prof").iterdir()
    names = {e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"]}
    assert {"tpupose." + n for n in TRAIN} <= names
