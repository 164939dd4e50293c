"""Replay a train step from a CUDA graph (`torch.cuda.CUDAGraph`).

An R50 heatmap train step at B = 64 is ~1450 kernel launches for ~21 ms
of an H100's time, and the host takes longer to issue them than the card
takes to run them. A graph records the step's launches once; a replay
issues them all with one call.

`StepGraphs` holds one step function's graphs, one for each input
signature (the keys, shapes, dtypes and devices of the batch and of the
draws, and whether the draws were given; the step function fixes the
rest, its teacher included). For a signature:

  - the first call runs the step eagerly on a side stream: the capture's
    warm-up, and a real step. The optimizer's state, cuDNN's choices and
    the libraries' handles are made there, outside any graph;
  - the second copies its inputs into static buffers, captures the whole
    step (augmentation, targets, forward, loss, backward, clip, update,
    EMA) into a graph and replays it;
  - every later call copies its inputs into those buffers and replays.

The random draws are made eagerly, outside the graph (a generator seeded
each step), and copied in like the batch. The update reads its schedules
(each group's lr, the EMA's decay) from device scalars, which
`TrainState.load_schedules` fills before every call of the body and
every replay, through torch.optim's fused update
(`TrainState.make_capturable`); the host's counters advance at each
replay (`count_replayed_update`). The kernel wrappers' launch counters
count launches from the host, so a replayed step adds nothing to them:
the profiler's kernel records count a replay's kernels. The outputs are
clones of the graph's static outputs, so a caller may read a step's
metrics after later steps ran.

A graph reads and writes the tensors it was captured on, and launches
what the model's Python settings chose at the capture. A state load
(`TrainState.load_state_dict`, `GroupedOptimizer.load_state_dict`: their
`reloads`), a change of `frozen_batch_stats()` or of a plain setting of
any of the model's modules (`routes`: a backbone's `remat`, an
attention's `impl`) drops every graph, and the next call runs eagerly
again. What the step reads from outside the state's model, such as a
module-level function swapped for another or the teacher's settings,
is not seen: a caller that changes it calls `drop()`. At most `LIMIT`
signatures are kept, the graphs sharing one memory pool, least recently
used dropped first: the Trainer's short last batch of an epoch is a
second signature.

`graph_blocker` says from the state alone whether its step may run from
a graph: one process's whole model on the card, updating at every step
through Adam, AdamW or SGD. Everything else (data or tensor parallelism,
gradient accumulation, the OptaxRule optimizers, the CPU) runs the same
step eagerly.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict

import torch

from tpupose_torch.models.remat import batch_stats_frozen
from tpupose_torch.parallel.tensor_parallel import shard_of
from tpupose_torch.utils import trace

LIMIT = 2

# optimizers whose torch.optim update a graph can hold
# (GroupedOptimizer.make_capturable)
GRAPHABLE = (torch.optim.Adam, torch.optim.AdamW, torch.optim.SGD)


def graph_blocker(state) -> str | None:
    """Why `state`'s train step cannot run from a CUDA graph, or None. It
    reads the optimizer's list of the model's parameters, not the module
    tree, which is slow to walk at every step."""
    opt = state.optimizer
    if state.dp_world != 1 or state.ddp is not None:
        return "data parallel"
    if any(shard_of(p) is not None for p in opt.params):
        return "tensor parallel"
    if opt.accum_steps != 1:
        return "gradient accumulation"
    if type(opt.inner) not in GRAPHABLE:
        return "optimizer"
    if not all(p.is_cuda for p in opt.params):
        return "not on CUDA"
    return None


_PLAIN = (bool, int, float, str)


def routes(model) -> tuple:
    """The plain settings (bool, int, float, str) of every module of
    `model`, `training` aside: what its Python reads to choose the
    kernels a step launches (a backbone's `remat`, an attention's
    `impl`), which a graph captured under other settings would not
    follow."""
    return tuple(v for m in model.modules() for k, v in vars(m).items()
                 if k[0] != "_" and k != "training" and type(v) in _PLAIN)


def signature(batch: dict, draws: dict | None) -> tuple:
    """What a graph is captured for: the keys, shapes, dtypes and devices
    of the batch and of the draws, and whether the draws were given."""
    def desc(t):
        return tuple(t.shape), t.dtype, t.device

    return (tuple((k, desc(v)) for k, v in sorted(batch.items())),
            None if draws is None else
            tuple((k, tuple(desc(t) for t in v))
                  for k, v in sorted(draws.items())))


class _Graph:
    """One captured step: the graph, its static inputs and outputs."""

    def __init__(self, graph, batch, draws, out):
        self.graph, self.batch, self.draws, self.out = graph, batch, draws, out


class StepGraphs:
    """The graphs of one step function (module docstring)."""

    def __init__(self):
        self.graphs: OrderedDict = OrderedDict()    # signature -> _Graph
        self._pool = None
        self._key = None

    def drop(self):
        self.graphs.clear()
        self._pool = None

    def __call__(self, state, batch: dict, draws: dict | None, draws_for,
                 body) -> dict:
        """`body(state, batch, draws)` (the eager step; it makes the draws
        itself when `draws` is None) as an eager warm-up, a capture and
        replay, or a replay. `draws_for`: the step's draw function for
        `state.local_draws`."""
        key = (state.reloads, state.optimizer.reloads, batch_stats_frozen(),
               routes(state.model))
        if self._key is None or self._key[0]() is not state \
                or self._key[1] != key:
            self.drop()
            self._key = (weakref.ref(state), key)
        sig = signature(batch, draws)
        if sig not in self.graphs:
            self._admit(sig, None)
            state.make_capturable()
            state.load_schedules()
            return self._warm_up(state, batch, draws, body)
        self.graphs.move_to_end(sig)
        g = self.graphs[sig]
        replayed = g is not None
        with trace.span("train.input"):
            if draws is None:
                images = batch["images"]
                draws = state.local_draws(draws_for, images.shape[0],
                                          images.device)
            if replayed:
                for k, v in batch.items():
                    g.batch[k].copy_(v, non_blocking=True)
                for k, v in draws.items():
                    for s, t in zip(g.draws[k], v):
                        s.copy_(t, non_blocking=True)
        if not replayed:
            g = self._capture(state, sig, batch, draws, body)
        with trace.span("train.replay"):
            if replayed:
                state.load_schedules()
            g.graph.replay()
            trace.count("train.graph_replay", 1)
        if replayed:
            # a capture ran the step's host code once: counters advanced
            state.count_replayed_update()
        return {k: v.clone() for k, v in g.out.items()}

    def _admit(self, sig, g):
        self.graphs[sig] = g
        while len(self.graphs) > LIMIT:
            self.graphs.popitem(last=False)

    def _warm_up(self, state, batch, draws, body) -> dict:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = body(state, batch, draws)
        torch.cuda.current_stream().wait_stream(side)
        return out

    def _capture(self, state, sig, batch, draws, body) -> _Graph:
        """Capture `body` on static copies of the inputs. The body's host
        code runs once here, its counters advancing for the update that
        the first replay makes; the schedules are filled before, at the
        counters the update starts from."""
        batch = {k: v.clone() for k, v in batch.items()}
        draws = {k: tuple(t.clone() for t in v) for k, v in draws.items()}
        state.load_schedules()
        graph, out = self._record(lambda: body(state, batch, draws))
        g = _Graph(graph, batch, draws, out)
        self.graphs[sig] = g
        return g

    def _record(self, fn):
        """(a graph of `fn()`'s launches, fn's output), in this object's
        memory pool."""
        graph = torch.cuda.CUDAGraph()
        # thread_local: a loader's pin-memory thread may allocate host
        # memory during the capture
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            out = fn()
        self._pool = graph.pool()
        return graph, out
