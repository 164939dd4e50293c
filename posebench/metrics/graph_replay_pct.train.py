"""Share of the measured window's steps that the program replayed from a
CUDA graph, in %: 100 x the program's `train.graph_replay` counter (one
on each replayed step's root), mean over the window's steps, which ran
without the profiler (tpupose_torch/utils/trace.py). None where the
program has no graphs (tpupose_torch/engine/step_graphs.py) and so no
such counter."""


def read(s):
    try:
        from tpupose_torch.engine import step_graphs  # noqa: F401
        from tpupose_torch.utils import trace
    except ImportError:
        return None
    if s.host_iters <= 0:
        return None
    return 100.0 * trace.summary(last=s.host_iters, profiled=False)[
        "counts"].get("train.graph_replay", 0)
