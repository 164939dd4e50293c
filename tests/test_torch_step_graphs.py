"""The heatmap train step's CUDA graph (tpupose_torch/engine/step_graphs.py)
on the CPU: when it engages (`graph_blocker`, one case per condition),
how a step function goes from an eager warm-up to a capture and to
replays and when it drops its graphs, with the capture stood in for by a
recording that runs the captured body again at each replay; the device
scalars (lr, EMA decay) the graph reads; the eager step unchanged; the
checkpoint format; the spans' device part; the benchmark's reader of the
replay counter. The graphs themselves run on the card
(tests/test_torch_cuda.py).

Bounds: every comparison of a path against the same update computed
another way is bit for bit, except the device-scalar lr and EMA decay
against the float ones: a float32 lr or decay is the float's rounding
(half an ulp, 6e-8 relative), and an update scaled by it differs by as
much, hence 1e-6 relative on a few plain updates (no network in between
to amplify it).
"""

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tpupose_torch._device
import tpupose_torch.engine
import tpupose_torch.engine.train_state as train_state
from posebench.harness import load_module
from tpupose_torch.configs.default import OptimizerConfig
from tpupose_torch.engine.optimizers import make_optimizer
from tpupose_torch.engine.step_graphs import (StepGraphs, graph_blocker,
                                              routes)
from tpupose_torch.engine.train_state import (TrainState,
                                              make_heatmap_train_step)
from tpupose_torch.losses.heatmap import joints_mse_loss
from tpupose_torch.models.remat import frozen_batch_stats
from tpupose_torch.models.simple_baseline import SimpleBaseline
from tpupose_torch.parallel.tensor_parallel import SHARD_ATTR, Shard
from tpupose_torch.utils import trace

from torch_threads import one_torch_thread  # noqa: F401

K, HW, HM = 4, (64, 64), (16, 16)


@pytest.fixture(autouse=True)
def fresh_records():
    trace._records.clear()
    yield
    trace._records.clear()


def _state(name="adam", ema=0.0, accum=1, seed=0, schedule=None):
    torch.manual_seed(seed)
    model = SimpleBaseline("resnet18", K, (16, 16, 16), dtype=torch.float32,
                           device="cpu", param_dtype=torch.float32)
    opt = make_optimizer(OptimizerConfig(name=name, lr=1e-3,
                                         weight_decay=1e-2),
                         model.named_parameters(), grad_clip_norm=1.0,
                         grad_accum_steps=accum, schedule=schedule)
    return TrainState(model, opt, ema_decay=ema)


def _batches(n, b=2, seed=1):
    rs = np.random.default_rng(seed)
    return [{"images": torch.from_numpy(rs.integers(0, 256, (b, *HW, 3),
                                                    dtype=np.uint8)),
             "joints": torch.from_numpy(
                 rs.uniform(1, 15, (b, K, 2)).astype(np.float32)),
             "visibility": torch.from_numpy(
                 (rs.uniform(size=(b, K)) < 0.8).astype(np.float32))}
            for _ in range(n)]


def _step_fn(udp=False, jitter=0.2):
    return make_heatmap_train_step(
        joints_mse_loss, color_jitter_strength=jitter, jitter_seed=5,
        heatmap_size=HM, affine_rotation=30.0, affine_scale=0.25, udp=udp)


# -- when the graph engages ---------------------------------------------------

def _shard_one(state):
    p = next(state.model.parameters())
    setattr(p, SHARD_ATTR, Shard(0, 0, 2, 2 * p.shape[0], None))


BLOCKERS = {   # case -> (make the state, what it changes, the reason)
    "cuda": ({}, None, "not on CUDA"),
    "dp_world": ({}, lambda s: setattr(s, "dp_world", 2), "data parallel"),
    "ddp": ({}, lambda s: setattr(s, "ddp", object()), "data parallel"),
    "sharded": ({}, _shard_one, "tensor parallel"),
    "accumulation": ({"accum": 2}, None, "gradient accumulation"),
    "optimizer_lamb": ({"name": "lamb"}, None, "optimizer"),
    "optimizer_adamax": ({"name": "adamax"}, None, "optimizer"),
    "optimizer_nadam": ({"name": "nadam"}, None, "optimizer"),
    "adamw": ({"name": "adamw"}, None, "not on CUDA"),
    "sgd": ({"name": "sgd"}, None, "not on CUDA"),
    "nesterov": ({"name": "nesterov"}, None, "not on CUDA"),
}


@pytest.mark.parametrize("case", sorted(BLOCKERS))
def test_graph_blocker_names_each_condition(case):
    """Each condition alone blocks the graph, and says so; Adam, AdamW,
    SGD and Nesterov on the CPU are blocked by the CPU alone (the graph
    needs the card, one process, the whole model, an update every step,
    a torch.optim update it can hold)."""
    kw, change, reason = BLOCKERS[case]
    state = _state(**kw)
    if change is not None:
        change(state)
    assert graph_blocker(state) == reason


# -- the step function's graphs, the capture stood in for --------------------

class _Recording:
    """A captured step's stand-in: the capture ran the body once, which
    also made the first replay's update on the CPU; a later replay runs
    the body again on the static inputs, into the static outputs, and
    leaves the host's counters as a graph's replay leaves them."""

    def __init__(self, fn, out, state):
        self.fn, self.out, self.state, self.replays = fn, out, state, 0

    def replay(self):
        self.replays += 1
        if self.replays == 1:
            return
        st = self.state
        counters = st.step, st.optimizer.count
        out = self.fn()
        st.step, st.optimizer.count = counters
        for k, v in out.items():
            self.out[k].copy_(v)


@pytest.fixture
def recorded(monkeypatch):
    """Graphs on the CPU: the blocker passes the CPU, the warm-up runs on
    the one stream, the capture is a `_Recording`. Yields the calls made:
    ("eager" | "capture")."""
    calls = []
    capture = StepGraphs._capture

    def blocker(state):
        reason = graph_blocker(state)
        return None if reason == "not on CUDA" else reason

    def warm_up(self, state, batch, draws, body):
        calls.append("eager")
        return body(state, batch, draws)

    def capture_of(self, state, *a):
        self.test_state = state
        return capture(self, state, *a)

    def record(self, fn):
        calls.append("capture")
        out = fn()
        return _Recording(fn, out, self.test_state), out

    monkeypatch.setattr(train_state, "graph_blocker", blocker)
    monkeypatch.setattr(StepGraphs, "_warm_up", warm_up)
    monkeypatch.setattr(StepGraphs, "_capture", capture_of)
    monkeypatch.setattr(StepGraphs, "_record", record)
    yield calls


def _replays_per_root():
    return [r[7].get("train.graph_replay", 0) for r in trace._records
            if r[7] is not None]


def test_first_call_eager_then_capture_then_replays(recorded):
    """A signature's first call is the eager warm-up, its second the
    capture (and its first replay), later ones replays; each counts one
    update on the host; the counter is one on each root that replayed; a
    new signature starts eager again; the least recently used of three
    signatures is dropped (two kept)."""
    state = _state()
    step = _step_fn()
    b2, b3, b1 = _batches(1, 2)[0], _batches(1, 3)[0], _batches(1, 1)[0]
    for b in (b2, b2, b2, b3, b3, b2, b1, b3):
        m = step(state, b)
        assert set(m) == {"loss", "grad_norm"}
    assert recorded == ["eager", "capture", "eager", "capture", "eager",
                        "eager"]
    assert _replays_per_root() == [0, 1, 1, 0, 1, 1, 0, 0]
    assert state.step == 8 and state.optimizer.count == 8
    assert len(step.graphs.graphs) == 2


@pytest.mark.parametrize("event", ["state_load", "optimizer_load",
                                   "frozen_batch_stats", "new_state"])
def test_graphs_dropped_when_their_tensors_may_change(recorded, event):
    """A state load, an optimizer load, a change of frozen_batch_stats()
    or another TrainState drops every graph: the next call is eager."""
    state = _state()
    step = _step_fn()
    b = _batches(1)[0]
    for _ in range(3):
        step(state, b)
    assert recorded == ["eager", "capture"]
    if event == "state_load":
        state.load_state_dict(state.state_dict())
    elif event == "optimizer_load":
        state.optimizer.load_state_dict(state.optimizer.state_dict())
    elif event == "new_state":
        state = _state(seed=1)
    if event == "frozen_batch_stats":
        with frozen_batch_stats():
            step(state, b)
    else:
        step(state, b)
    assert recorded == ["eager", "capture", "eager"]
    assert len(step.graphs.graphs) == 1


ROUTE_CHANGES = {    # case -> a change of the model's Python settings
    "remat": lambda m: setattr(m.backbone, "remat", True),
    "conv_padding_mode": lambda m: setattr(m.backbone.conv1, "padding_mode",
                                           "reflect"),
    "bn_momentum": lambda m: setattr(m.backbone.bn1, "momentum", 0.5),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CHANGES))
def test_graphs_dropped_when_the_model_route_changes(recorded, case):
    """A change of a plain setting of any module of the model (what its Python
    reads to choose the kernels, here a backbone's remat, a convolution's
    padding mode, a BatchNorm's momentum) drops every graph: the next call
    is eager, the one after captures. Steps and validation-style mode
    switches alone drop nothing."""
    state = _state()
    step = _step_fn()
    b = _batches(1)[0]
    for _ in range(3):
        step(state, b)
        state.model.eval()              # as a validation between steps
    assert recorded == ["eager", "capture"]
    before = routes(state.model)
    ROUTE_CHANGES[case](state.model)
    assert routes(state.model) != before
    for _ in range(3):
        step(state, b)
    assert recorded == ["eager", "capture", "eager", "capture"]
    assert _replays_per_root() == [0, 1, 1, 0, 1, 1]


def _run(state, step, batches, draws_given, before=None):
    """`step` over `batches`; `before(state)` runs before each call."""
    metrics = []
    for k, b in enumerate(batches):
        if before is not None:
            before(state)
        d = step.draws_for(k, b["images"].shape[0], torch.device("cpu")) \
            if draws_given else None
        metrics.append(step(state, b, d))
    return metrics


def _assert_states_equal(a, b):
    for (n, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), n
    for x, y in zip(a.ema or [], b.ema or []):
        assert torch.equal(x, y)
    sa, sb = a.optimizer.inner.state, b.optimizer.inner.state
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert sa[p].keys() == sb[q].keys()
        for k in sa[p]:
            assert torch.equal(torch.as_tensor(sa[p][k]),
                               torch.as_tensor(sb[q][k])), k
    assert (a.step, a.optimizer.count) == (b.step, b.optimizer.count)


def _warmup(t):
    return 1e-3 * min(1.0, (t + 1) / 4.0)


@pytest.mark.parametrize("name,ema,draws_given", [
    ("adam", 0.999, True), ("adamw", 0.0, True), ("nesterov", 0.0, True),
    ("adam", 0.0, False)], ids=["adam_warmup_ema", "adamw", "nesterov",
                                "adam_own_draws"])
def test_graph_path_equals_the_eager_body_bit_for_bit(monkeypatch, recorded,
                                                      name, ema, draws_given):
    """Six steps through the graph path (warm-up, capture, four replays
    of the static inputs, a warm-up lr schedule read from the device
    scalar filled before each call) against the same steps run eagerly
    on a state made capturable alike, its schedules filled before each
    step as the graph path fills them: parameters, BatchNorm statistics,
    EMA, optimizer state, counters, losses and grad norms equal."""
    batches = _batches(6)
    graphed = _state(name, ema, schedule=_warmup)
    got = _run(graphed, _step_fn(), batches, draws_given)
    assert recorded == ["eager", "capture"]

    monkeypatch.setattr(train_state, "graph_blocker", graph_blocker)
    eager = _state(name, ema, schedule=_warmup)
    eager.make_capturable()
    want = _run(eager, _step_fn(), batches, draws_given,
                TrainState.load_schedules)
    _assert_states_equal(graphed, eager)
    for g, w in zip(got, want):
        for k in w:
            assert torch.equal(g[k], w[k]), k
    lr = graphed.optimizer.inner.param_groups[0]["lr"]
    assert torch.is_tensor(lr) and float(lr) == np.float32(_warmup(5))


@pytest.mark.parametrize("udp,jitter", [(False, 0.2), (True, 0.2),
                                         (False, 0.0)],
                         ids=["jitter", "jitter_udp", "normalize_only"])
def test_eager_step_bit_equal_to_the_tensors_made_from_lists(monkeypatch,
                                                             udp, jitter):
    """The eager step (the CPU's path) with its constants cached on the
    device equals the body that made them from Python lists at every
    step (ImageNet's mean and std, the warp's centre, the heatmap's
    centre; without jitter, normalize_images itself), bit for bit over
    three Adam steps with the EMA."""
    batches = _batches(3)
    a = _state(ema=0.99)
    _run(a, _step_fn(udp, jitter), batches, True)
    monkeypatch.setattr(
        tpupose_torch._device, "constant",
        lambda values, device: torch.tensor(list(values), device=device))
    monkeypatch.setattr(train_state, "constant",
                        tpupose_torch._device.constant)
    import tpupose_torch.ops.affine as affine

    monkeypatch.setattr(affine, "constant", tpupose_torch._device.constant)
    monkeypatch.setattr(train_state, "_augment", _augment_from_lists)
    b = _state(ema=0.99)
    _run(b, _step_fn(udp, jitter), batches, True)
    _assert_states_equal(a, b)


def _augment_from_lists(images, joints, vis, draws, use_affine, grid_hw,
                        udp, jitter):
    """The step's augmentation as it read before its statistics were kept
    on the device: the plain path through normalize_images."""
    from tpupose_torch.ops.affine import random_affine_augment
    from tpupose_torch.ops.preprocess import (IMAGENET_MEAN, IMAGENET_STD,
                                              color_jitter, normalize_images)

    if use_affine:
        mult, rot = draws["affine"]
        images, joints, vis = random_affine_augment(
            images, joints, vis, mult, rot, tuple(grid_hw), udp=udp)
    if jitter > 0:
        x = color_jitter(images.to(torch.float32) * (1.0 / 255.0),
                         draws["jitter"])
        m = torch.tensor(IMAGENET_MEAN, device=x.device)
        s = torch.tensor(IMAGENET_STD, device=x.device)
        return ((x - m) / s).to(torch.bfloat16), joints, vis
    return normalize_images(images), joints, vis


# -- the device scalars -------------------------------------------------------

@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "nesterov"])
def test_tensor_lr_and_ema_decay_match_the_floats(name):
    """Eight updates of a small model from the same gradients under a
    warm-up schedule with an EMA of 0.99: made capturable (lr and EMA
    decay 0-dim tensors, filled from the host's counters), the
    parameters and the EMA agree with the float updates to 1e-6 relative
    (module docstring), and each group's lr tensor holds its schedule's
    value at the update count. Before each update the caller fills the
    schedules (`load_schedules`, nothing on the float state)."""
    torch.manual_seed(2)
    states = []
    for capturable in (False, True):
        torch.manual_seed(2)
        model = torch.nn.Sequential(torch.nn.Linear(8, 8),
                                    torch.nn.Linear(8, 3))
        opt = make_optimizer(OptimizerConfig(name=name, lr=1e-3,
                                             weight_decay=1e-2),
                             model.named_parameters(), schedule=_warmup)
        st = TrainState(model, opt, ema_decay=0.99)
        if capturable:
            st.make_capturable()
        states.append(st)
    g = torch.Generator().manual_seed(3)
    for t in range(8):
        grads = [torch.randn(p.shape, generator=g)
                 for p in states[0].model.parameters()]
        for st in states:
            for p, gr in zip(st.model.parameters(), grads):
                p.grad = gr.clone()
            st.load_schedules()
            st.apply_gradients()
        lr = states[1].optimizer.inner.param_groups[0]["lr"]
        assert float(lr) == np.float32(_warmup(t))
    a, b = states
    for x, y in zip(list(a.model.parameters()) + a.ema,
                    list(b.model.parameters()) + b.ema):
        torch.testing.assert_close(y, x, rtol=1e-6, atol=1e-9)
    assert (b.step, b.optimizer.count) == (8, 8)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_state_dict_keeps_the_eager_format(name):
    """A capturable optimizer's state_dict is the eager one's: lr floats,
    the groups' settings at the constructor's, step counts on the host;
    it loads into an eager optimizer, and a load counts in `reloads`."""
    batches = _batches(2)
    dicts = []
    for capturable in (False, True):
        st = _state(name)
        if capturable:
            st.make_capturable()
        _run(st, _step_fn(), batches, True, TrainState.load_schedules)
        dicts.append(st.optimizer.state_dict())
    want, got = dicts
    assert got["count"] == want["count"]
    for gw, gg in zip(want["inner"]["param_groups"],
                      got["inner"]["param_groups"]):
        assert type(gg["lr"]) is float
        assert gg["lr"] == pytest.approx(gw["lr"], rel=1e-7)
        assert {**gg, "lr": 0.0} == {**gw, "lr": 0.0}
    for i, sw in want["inner"]["state"].items():
        sg = got["inner"]["state"][i]
        assert sw.keys() == sg.keys()
        for k in sw:
            assert torch.as_tensor(sg[k]).device.type == "cpu"
            assert torch.as_tensor(sg[k]).dtype == \
                torch.as_tensor(sw[k]).dtype
    fresh = _state(name)
    fresh.optimizer.load_state_dict(got)
    assert fresh.optimizer.reloads == 1
    assert not torch.is_tensor(fresh.optimizer.inner.param_groups[0]["lr"])


# -- the spans and the benchmark's reader -------------------------------------

def test_span_device_part_off_while_capturing(monkeypatch):
    """With the device part enabled, a span opened while a graph is
    captured keeps its host part only: no profiler range, no events."""
    trace.enable(True)
    try:
        monkeypatch.setattr(trace, "capturing", lambda: True)
        with trace.root("train.step"):
            with trace.span("train.forward"):
                pass
    finally:
        trace.enable(False)
    assert [(r[0], r[5], r[6]) for r in trace._records] == [
        ("train.forward", False, None), ("train.step", False, None)]


def test_graph_replay_reader(monkeypatch):
    """`graph_replay_pct.train` is 100 x the replayed share of the window's
    untraced steps (not the warm-up's, not the traced ones): 3 of 4 read
    75; 0 where none replayed; None where the program has no graphs."""
    read = load_module("metrics", "graph_replay_pct.train").read

    def steps(replays):
        for n in replays:
            with trace.root("train.step"):
                if n:
                    trace.count("train.graph_replay", n)

    steps([0, 1])                               # warm-up
    steps([1, 0, 1, 1])                         # the window
    s = SimpleNamespace(host_iters=4, iters=2)
    assert read(s) == pytest.approx(75.0)
    trace._records.clear()
    steps([0, 0, 0, 0])
    assert read(s) == 0.0
    monkeypatch.delattr(tpupose_torch.engine, "step_graphs")
    monkeypatch.setitem(sys.modules, "tpupose_torch.engine.step_graphs",
                        None)
    assert read(s) is None
