"""The traced segment of a --trace 1 run and its summary: torch.profiler
(CPU and CUDA activities) over a fixed number of iterations after the
measured window, each inside a `posebench.iter` range, all inside
`posebench.window`, the card synchronised at both ends. Per-layer metric
readers (posebench/metrics/<name>.py) take the `Summary`."""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

# the program's launch counters: kernel -> (module, function)
COUNTERS = {
    "K1": ("tpupose_torch.ops.cuda_stem", "stem_pool"),
    "K2": ("tpupose_torch.ops.cuda_layer1", "layer1"),
    "K3": ("tpupose_torch.ops.cuda_bridge", "bridge"),
    "K4": ("tpupose_torch.ops.cuda_decode", "dark_decode"),
    "K5": ("tpupose_torch.ops.cuda_stages", "run_chunk"),
    "K6": ("tpupose_torch.ops.cuda_head", "run_deconv"),
    "K7": ("tpupose_torch.ops.cuda_warp", "affine_warp"),
    "K8": ("tpupose_torch.ops.cuda_attention", "flash_attention"),
    "K8b": ("tpupose_torch.ops.cuda_attention", "flash_attention_backward"),
}
LAUNCH = re.compile(r"^(cudaLaunch|cuLaunch|cudaGraphLaunch)")
COPY = re.compile(r"^(Memcpy|Memset)", re.I)
RUNTIME = re.compile(r"^(cuda|cu[A-Z])")


def launch_counts() -> dict:
    import importlib

    out = {}
    for k, (mod, fn) in COUNTERS.items():
        out[k] = getattr(getattr(importlib.import_module(mod), fn),
                         "launches", 0)
    return out


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


class Summary:
    """What a per-layer reader may read. Times in seconds; kernel
    intervals in profiler microseconds.

    iters, window_s, busy_s: the traced segment's; flip, train, widths,
    batch: the cell's; kernels [(name, start_us, end_us)] (copies
    apart in `copies`); enqueue_s [per iteration]; launches {K1..K8b:
    launches in the segment}; peak_window_bytes (the whole window's);
    host_iters, host_s: the measured window's iterations and seconds
    (untraced: the profiler's own host cost slows the traced ones)."""

    def __init__(self, prof, iters: int, launches: dict, cell):
        from torch.autograd import DeviceType

        self.iters = iters
        self.widths = cell.widths
        self.batch = int(cell.params["batch"])
        self.flip = bool(cell.params.get("flip_test", False))
        self.train = cell.traffic["generator"] == "train_steps"
        self.launches = launches
        self.peak_window_bytes = 0
        self.host_iters, self.host_s = 0, 0.0
        cpu, dev = [], []
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    dev.append((e.name, e.time_range.start, e.time_range.end))
            else:
                cpu.append(e)
        win = [e for e in cpu if e.name == "posebench.window"]
        if not win:
            raise RuntimeError("the trace holds no posebench.window range")
        self.w0, self.w1 = win[0].time_range.start, win[0].time_range.end
        self.window_s = (self.w1 - self.w0) * 1e-6
        inside = [(n, max(s, self.w0), min(e, self.w1)) for n, s, e in dev
                  if e > self.w0 and s < self.w1]
        if not inside:
            raise RuntimeError("the profiler recorded no device activity")
        self.copies = [x for x in inside if COPY.match(x[0])]
        self.kernels = [x for x in inside if not COPY.match(x[0])]
        self.busy_s = _union([(s, e) for _, s, e in inside]) * 1e-6
        iters_ev = sorted((e.time_range.start, e.time_range.end)
                          for e in cpu if e.name == "posebench.iter")
        launch_ends = sorted(e.time_range.end for e in cpu
                             if LAUNCH.match(e.name))
        self.enqueue_s = []
        for s, e in iters_ev:
            j = bisect.bisect_right(launch_ends, e) - 1
            if j >= 0 and launch_ends[j] >= s:
                self.enqueue_s.append((launch_ends[j] - s) * 1e-6)
        # host ops directly under an iteration: what the host did in a gap
        self._host = sorted(
            (e.time_range.start, e.time_range.end, e.name) for e in cpu
            if not e.name.startswith("posebench.")
            and not RUNTIME.match(e.name)
            and (e.cpu_parent is None
                 or e.cpu_parent.name.startswith("posebench.")))
        self._host_starts = [h[0] for h in self._host]

    def device_s(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.kernels if rx.search(n)) * 1e-6

    def device_s_excluding(self, *patterns: str) -> float:
        """Device seconds of the kernels matching none of `patterns`."""
        rx = [re.compile(p) for p in patterns]
        return sum(e - s for n, s, e in self.kernels
                   if not any(r.search(n) for r in rx)) * 1e-6

    def copy_s(self, pattern: str) -> float:
        """Device seconds of the copies whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.copies if rx.search(n)) * 1e-6

    def kernel_count(self, pattern: str = "") -> int:
        rx = re.compile(pattern)
        return sum(1 for n, _, _ in self.kernels if rx.search(n))

    def _gaps(self):
        ivs = sorted((s, e) for _, s, e in self.kernels + self.copies)
        cur = self.w0
        for s, e in ivs:
            if s > cur:
                yield cur, s
            cur = max(cur, e)
        if self.w1 > cur:
            yield cur, self.w1

    def _host_op(self, s: float, e: float) -> str:
        j = bisect.bisect_right(self._host_starts, e)
        best, name = 0.0, "host (no op traced)"
        for hs, he, hn in self._host[max(0, j - 64):j]:
            ov = min(he, e) - max(hs, s)
            if ov > best:
                best, name = ov, hn
        return name

    def breakdown(self) -> dict:
        by_kernel = defaultdict(float)
        for n, s, e in self.kernels + self.copies:
            by_kernel[n[:160]] += (e - s) * 1e-6
        by_host = defaultdict(float)
        for s, e in self._gaps():
            by_host[self._host_op(s, e)] += (e - s) * 1e-6
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, v] for n, v in top],
                "idle_gaps": [[n, v] for n, v in gaps]}


def traced_segment(session, i0: int, cell):
    """Iterations i0 .. i0 + n - 1, the n = `trace_iters` that follow the
    measured window, under the profiler. Returns (profiler, n, launches
    in the segment) for `Summary`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    n = int(cell.spec["trace_iters"])
    torch.cuda.synchronize()
    before = launch_counts()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    with record_function("posebench.window"):
        for k in range(n):
            with record_function("posebench.iter"):
                session.call(i0 + k)
        session.finish()
    prof.stop()
    after = launch_counts()
    return prof, n, {k: after[k] - before[k] for k in after}
