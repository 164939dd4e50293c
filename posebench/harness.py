"""One run of one cell: find its files by name, set up, measure, trace,
check, and build the result line.

Everything a cell needs is found from BENCHMARK.json's names:
  posebench/workloads/<cell>.json      the cell: config, traffic, limits;
  posebench/configs/<config>.json      widths, the port's yaml, the
                                       model builder and its reference;
  posebench/traffic/<traffic>.json     the mix's parameters, naming its
                                       generator posebench/traffic/<g>.py;
  posebench/models/<module>.py         builds the port's model;
  posebench/reference/<module>.py      the plain float32 model;
  posebench/metrics/<metric>.py        one per-layer metric's reader.
Adding any of them needs no edit here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "posebench"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "tpupose")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """posebench/<kind>/<name>.py as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"posebench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded(modules=None) -> list:
    """Top-level names in `modules` (sys.modules) equal to a JAX name."""
    modules = sys.modules if modules is None else modules
    return sorted({k.split(".")[0] for k in modules}
                  & set(FORBIDDEN_MODULES))


class Cell:
    """The files of one cell, read by name, with `overrides` (tests:
    smaller widths, batches and pools) merged over them."""

    def __init__(self, name: str, overrides: dict | None = None):
        o = overrides or {}
        self.bench = load_json(ROOT / "BENCHMARK.json")
        entry = [w for w in self.bench["workloads"] if w["name"] == name]
        if not entry:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entry[0]
        self.name = name
        self.spec = load_json(HERE / "workloads" / f"{name}.json")
        self.config = load_json(HERE / "configs"
                                / f"{self.entry['config']}.json")
        self.config["widths"].update(o.get("widths", {}))
        self.traffic = load_json(HERE / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.traffic["params"].update(o.get("traffic", {}))
        self.port_overrides = o.get("port", {})
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in self.bench["per_layer"]
                          if name in m.get("workloads", [name])]

    @property
    def widths(self) -> dict:
        return self.config["widths"]

    @property
    def params(self) -> dict:
        return self.traffic["params"]

    def port_config(self):
        """The program's configuration: its yaml, as its CLI reads it,
        with the cell's and a test's overrides."""
        from tpupose_torch.configs.parser import load_config

        over = dict(self.config.get("port_overrides", {}))
        over.update(self.port_overrides)
        return load_config(str(ROOT / self.config["yaml"]), over)

    def generator_module(self):
        return load_module("traffic", self.traffic["generator"])

    def model_module(self):
        return load_module("models", self.config["model"])

    def reference_module(self):
        return importlib.import_module(
            f"posebench.reference.{self.config['reference']}")


def quantile(values, q: float) -> float:
    """The q-quantile (0 < q < 1) by statistics.quantiles' exclusive
    method on 100 cut points, q a multiple of 0.01."""
    if len(values) < 2:
        return float(values[0]) if values else float("nan")
    return statistics.quantiles(values, n=100)[round(q * 100) - 1]


def judge(compared: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number compared at or
    under its limit, none missing or NaN."""
    out, ok = {}, True
    for k, lim in limits.items():
        v = compared.get(k)
        good = v is not None and not math.isnan(v) and v <= lim
        ok = ok and good
        out[k] = {"value": v, "limit": lim}
    return ok, out


def device_info(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float | None = None, device=None,
             overrides: dict | None = None, fault: str | None = None,
             check_modules: bool = True, log=print) -> dict:
    """One run of cell `name`. device None: the card, refused (RuntimeError)
    where CUDA or enough cards are missing; tests pass device="cpu" and
    overrides. fault: a fault planted under the timed path (the traffic
    Session's FAULTS). Returns the result dict (the line's keys,
    "compared" last)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(name, overrides)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available")
        if torch.cuda.device_count() < cell.chips:
            raise RuntimeError(f"{cell.chips} cards wanted, "
                               f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
        # one process with few threads: the program's host work is
        # launches, not CPU tensor arithmetic
        torch.set_num_threads(1)
    device = torch.device(device)
    if device.type == "cuda":
        from tpupose_torch.ops import _build

        t0 = time.perf_counter()
        _build.build_all()
        log(f"kernels built or loaded in {time.perf_counter() - t0:.3f} s "
            f"(nvcc wall {_build.build_seconds:.3f} s)", file=sys.stderr)
    before_session_s = time.perf_counter() - t_start
    session = cell.generator_module().Session(cell, seed, device)
    if fault:
        session.plant(fault)
    session.warm_up()
    setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    lat, items, i = [], 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        ti = time.perf_counter()
        items += session.call(i)
        lat.append(time.perf_counter() - ti)
        i += 1
    session.finish()
    window_s = time.perf_counter() - t0
    attempted = session.window_calls = i
    device_rec = device_info(device, cell.chips)
    if device.type == "cuda":
        window_peak = torch.cuda.max_memory_allocated()
        device_rec["memory_peak_bytes"] = int(max(setup_peak, window_peak))
    else:
        window_peak = 0
    summary = None
    if trace:
        from posebench.trace import Summary, traced_segment

        summary = Summary(*traced_segment(session, attempted, cell), cell)
        summary.peak_window_bytes = window_peak
        summary.host_iters, summary.host_s = attempted, window_s
    bad = forbidden_loaded() if check_modules else []
    if bad:
        raise RuntimeError(f"modules of the JAX package loaded: {bad}")
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = load_module("metrics", m["name"]).read(summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = session.end_to_end(items, window_s, lat)
        e2e["setup_s"] = setup_s
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": e2e[k], "unit": units[k]}
                   for k in units if k in e2e}
    session.release()
    compared = session.check()
    correct, shown = judge(compared, cell.spec["limits"])
    correct = correct and attempted > 0
    res = {"correct": correct, "attempted": attempted, "failed": 0,
           "metrics": metrics, "device": device_rec}
    if summary is not None:
        res["device"]["busy_s"] = summary.busy_s
        res["device"]["window_s"] = summary.window_s
        res["breakdown"] = summary.breakdown()
    res["setup"] = {"setup_s": setup_s, "before_session_s": before_session_s,
                    "window_s": window_s,
                    "call_s_quartiles": statistics.quantiles(lat, n=4)
                    if len(lat) > 1 else lat,
                    "iterations": attempted, **session.notes(),
                    **({"launches_traced": summary.launches,
                        "traced_iter_s": summary.window_s / summary.iters,
                        "untraced_iter_s": summary.host_s
                        / max(summary.host_iters, 1)} if summary else {}),
                    **{k: v for k, v in compared.items() if k not in shown}}
    res["compared"] = shown
    return res
