"""Layer spans and counters inside the program, on the host's clock always
and on the device's while a profiler runs.

    from tpupose_torch.utils import trace

    with trace.root("serve.request"):           # one request or step
        with trace.span("serve.h2d"):           # one layer inside it
            trace.count("serve.h2d_pageable_bytes", n)
    trace.summary(last=100, profiled=False)

A span's host part is always on: `time.perf_counter_ns` at enter and at
exit, kept with the span's root, its parent and whether its device part
ran, in a bounded in-memory buffer (about a microsecond a span). Its
device part runs only while torch.profiler records or after `enable()`,
and never while a CUDA graph is captured (engine/step_graphs.py):
a `record_function("tpupose.<name>")` range, which puts the span on the
profiler's clock beside the kernels, and, where CUDA is in use, a pair of
timing events on the current stream, whose elapsed time is the layer's
device wall (its kernels and the gaps the host leaves inside it).

A root opens a request or a step. It is kept in memory only, with no
profiler range, so a trace shows its layer spans directly under whatever
range the caller wraps around it. Spans nest per thread: a server runs
the predictor on a thread of its own. Under torch.compile and
torch.export every call is a no-op, so a traced program holds no span.

This module imports nothing beyond torch's core and the port's
`_device` (torch._dynamo's import alone takes seconds).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import torch
from torch.autograd.profiler import record_function

from tpupose_torch._device import capturing

# records kept: a 20 s window of requests or steps holds ~10^4
CAPACITY = 1 << 16

# (name, root id, parent name, t0 ns, t1 ns, profiled, (start, end)
# events or None, the root's counts or None for a span); a deque's append
# is atomic, so the hot path takes no lock
_records: deque = deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_enabled = False
_clock = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled
_compiling = torch.compiler.is_compiling
_exporting = torch.compiler.is_exporting


class _Local(threading.local):
    def __init__(self):
        self.stack = []             # this thread's open spans


_local = _Local()


def _events():
    """A started pair of timing events on the current stream, or None
    where CUDA is not in use."""
    if not torch.cuda.is_initialized():
        return None
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    return start, torch.cuda.Event(enable_timing=True)


class span:
    """`with span(name):` times one layer of the open request or step."""

    __slots__ = ("name", "_rid", "_dev", "_t0", "_stack")
    _is_root = False

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _compiling() or _exporting():
            self._stack = None
            return self
        self._stack = stack = _local.stack
        if self._is_root:
            self._rid = next(_ids)
            self._counts = {}
        else:
            self._rid = stack[-1]._rid if stack else None
        stack.append(self)
        self._dev = (self._device_part()
                     if (_enabled or _profiling()) and not capturing()
                     else None)
        self._t0 = _clock()
        return self

    def _device_part(self):
        """(the open profiler range or None, the started events or None)."""
        rf = None
        if not self._is_root:
            rf = record_function("tpupose." + self.name)
            rf.__enter__()
        return rf, _events()

    def __exit__(self, et, ev, tb):
        t1 = _clock()
        stack = self._stack
        if stack is None:
            return False
        dev = self._dev
        if dev is not None:
            if dev[1] is not None:
                dev[1][1].record()
            if dev[0] is not None:
                dev[0].__exit__(et, ev, tb)
        stack.pop()
        _records.append((self.name, self._rid,
                         stack[-1].name if stack else None, self._t0, t1,
                         dev is not None, dev[1] if dev else None,
                         self._counts if self._is_root else None))
        return False


class root(span):
    """`with root(name):` opens a request or a step: a new root id, the
    counts of `count`, no profiler range."""

    __slots__ = ("_counts",)
    _is_root = True


def count(name: str, n) -> None:
    """Add `n` to the open root's count `name` (nothing outside a root)."""
    if _compiling() or _exporting():
        return
    for s in reversed(_local.stack):
        if s._is_root:
            s._counts[name] = s._counts.get(name, 0) + n
            return


def enable(on: bool = True) -> None:
    """Run the spans' device part without a profiler (ranges, events)."""
    global _enabled
    _enabled = bool(on)


def _device_ms(ev):
    if ev is None:
        return None
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1])


def summary(last: int | None = None, profiled: bool | None = None) -> dict:
    """Over the last `last` finished roots (all kept: None) whose device
    part ran (`profiled` True), did not (False) or either (None):
    {"roots": n, "host_ms": {name: ms}, "device_ms": {name: ms, None
    where a span had no events}, "counts": {name: count}}, each the mean
    a root. A root's several spans of one name add up; the root's own
    name is among the spans."""
    while True:
        try:
            recs = list(_records)
            break
        except RuntimeError:            # appended to while copied
            continue
    # a full buffer may have dropped the first root's first spans
    partial = recs[0][1] if len(recs) == CAPACITY else None
    by_root: dict = {}
    order = []
    for r in recs:
        if r[1] is None or r[1] == partial:
            continue
        by_root.setdefault(r[1], []).append(r)
        if r[7] is not None and (profiled is None or r[5] == profiled):
            order.append(r[1])
    if last is not None:
        order = order[max(0, len(order) - last):] if last > 0 else []
    host, dev, counts = {}, {}, {}
    for rid in order:
        for r in by_root[rid]:
            host[r[0]] = host.get(r[0], 0.0) + (r[4] - r[3]) * 1e-6
            ms = _device_ms(r[6])
            if r[0] not in dev or dev[r[0]] is not None:
                dev[r[0]] = None if ms is None else dev.get(r[0], 0.0) + ms
            for k, v in (r[7] or {}).items():
                counts[k] = counts.get(k, 0) + v
    n = len(order)
    return {"roots": n,
            "host_ms": {k: v / n for k, v in host.items()},
            "device_ms": {k: None if v is None else v / n
                          for k, v in dev.items()},
            "counts": {k: v / n for k, v in counts.items()}}
