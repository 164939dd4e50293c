"""The port's optimizer chain (engine/optimizers.py) against tpupose's
optax chain on the CPU, on seeded numpy gradients:

  - the seven rules optax builds from the lr (and weight_decay) alone
    (lamb, lars, lion, fromage, yogi, adamaxw, nadamw) over 5 updates
    under warmup + cosine schedules, the head/base split, a frozen
    backbone and global-norm clipping;
  - gradient accumulation (optax.MultiSteps around the whole chain) at
    k = 2 and 3: the clip on the window's mean, zero updates on the
    mini-steps, the schedules in update units, the EMA per mini-step,
    the mini-batch's own gradient norm as the step's grad_norm, a resume
    inside a window;
  - Builder.lr_scheduler in update units under grad_accum_steps.

Tolerance: each parameter tensor within 1e-6 of its largest |value|
(relative to the tensor): the same float32 update arithmetic in another
order (fused multiply-adds, the trust ratio's norms) moves a parameter
by a few float32 ulps (6e-8 to 1.2e-7 of the tensor's scale) over 5
updates. The bias corrections are float32 in both (optax's 1 - 0.999^t
in float32 is 2e-5 off the exact value at t = 1).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpupose.configs.default import OptimizerConfig as JOptimizerConfig
from tpupose.configs.default import SchedulerConfig as JSchedulerConfig
from tpupose.engine.builder import is_backbone_path as j_is_backbone
from tpupose.engine.optimizers import make_optimizer as j_make_optimizer
from tpupose.engine.schedulers import make_schedule as j_make_schedule
from tpupose.engine.train_state import TrainState as JState
from tpupose_torch.configs.default import OptimizerConfig, SchedulerConfig
from tpupose_torch.engine.builder import is_backbone_path
from tpupose_torch.engine.optimizers import (OPTAX_DEFAULTS, make_optimizer)
from tpupose_torch.engine.schedulers import make_schedule
from tpupose_torch.engine.train_state import TrainState
from torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy
RULES = tuple(OPTAX_DEFAULTS)
TOL = 1e-6


def _tree(seed=8):
    """Weights and 1-D leaves in both groups, and an all-zero leaf: the
    trust ratio's zero-norm guard (ratio 1) on it."""
    rs = np.random.RandomState(seed)
    shapes = {"backbone": {"w": (5, 3), "b": (3,)},
              "head": {"w": (3, 4), "b": (4,)}}
    tree = {g: {k: rs.normal(0, 1, s).astype(np.float32)
                for k, s in d.items()} for g, d in shapes.items()}
    tree["head"]["z"] = np.zeros(2, np.float32)
    return tree


def _grads(rs, tree, scale=20.0):
    """Normal gradients (norms ~30-90 against a clip of 10), away from 0
    so that no float32 rounding can flip lion's sign."""
    out = {}
    for g, d in tree.items():
        out[g] = {}
        for k, v in d.items():
            x = rs.normal(0, scale, v.shape).astype(np.float32)
            out[g][k] = np.where(np.abs(x) < 0.5, np.sign(x) + x, x) \
                .astype(np.float32)
    return out


def _schedules(lr, head_lr, total, warmup, per_epoch=1):
    scfg = dict(name="cosine", min_lr=1e-4)
    return ((j_make_schedule(JSchedulerConfig(**scfg), lr, total, warmup,
                             per_epoch),
             j_make_schedule(JSchedulerConfig(**scfg), head_lr, total,
                             warmup, per_epoch)),
            (make_schedule(SchedulerConfig(**scfg), lr, total, warmup,
                           per_epoch),
             make_schedule(SchedulerConfig(**scfg), head_lr, total, warmup,
                           per_epoch)))


def _assert_close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max(), err_msg=name)


class _Chains:
    """JAX's make_optimizer and the port's on one config and tree."""

    def __init__(self, name, frozen=False, accum=1, total=8, warmup=2,
                 clip=10.0, lr=1e-2, head_lr=5e-2):
        self.tree = _tree()
        kw = dict(name=name, lr=lr, head_lr=head_lr, weight_decay=1e-2)
        (jb, jh), (tb, th) = _schedules(lr, head_lr, total, warmup)
        self.tx = j_make_optimizer(
            JOptimizerConfig(**kw), schedule=jb, head_schedule=jh,
            params=self.tree, is_head=lambda p: not j_is_backbone(p),
            is_frozen=j_is_backbone if frozen else None,
            grad_clip_norm=clip, grad_accum_steps=accum)
        self.params = jax.tree_util.tree_map(jnp.asarray, self.tree)
        self.opt_state = self.tx.init(self.params)
        self.tparams = {f"{g}.{k}": torch.nn.Parameter(T(v.copy()))
                        for g, d in self.tree.items() for k, v in d.items()}
        self.opt = make_optimizer(
            OptimizerConfig(**kw), list(self.tparams.items()), schedule=tb,
            head_schedule=th, is_head=lambda n: not is_backbone_path(n),
            is_frozen=is_backbone_path if frozen else None,
            grad_clip_norm=clip, grad_accum_steps=accum)

    def step(self, grads):
        """One update (or mini-step) of both; returns (JAX's gradient
        norm, the port's returned norm)."""
        upd, self.opt_state = self.tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), self.opt_state,
            self.params)
        self.params = optax.apply_updates(self.params, upd)
        for n, p in self.tparams.items():
            g, k = n.split(".")
            p.grad = T(grads[g][k].copy())
        return float(optax.global_norm(grads)), self.opt.step().item()

    def assert_equal(self):
        for n, p in self.tparams.items():
            g, k = n.split(".")
            _assert_close(p.detach().numpy(), self.params[g][k], n)

    def port_params(self):
        return {n: p.detach().clone() for n, p in self.tparams.items()}


CASES = [(n, False) for n in RULES] + [("lamb", True), ("lars", True)]


@pytest.mark.parametrize("name,frozen", CASES,
                         ids=[f"{n}{'_frozen' if f else ''}"
                              for n, f in CASES])
def test_rule_matches_optax(name, frozen):
    """5 updates with clipping, warmup + cosine per group, optionally a
    frozen backbone (zero updates, its gradients still in the clip norm):
    every parameter within 1e-6 of optax's after each update."""
    ch = _Chains(name, frozen=frozen)
    rs = np.random.RandomState(9)
    for _ in range(5):
        want_norm, norm = ch.step(_grads(rs, ch.tree))
        assert want_norm > 10.0
        np.testing.assert_allclose(norm, want_norm, rtol=1e-6)
        ch.assert_equal()
    moved = [n for n, p in ch.tparams.items()
             if not np.array_equal(p.detach().numpy(),
                                   ch.tree[n.split(".")[0]][n.split(".")[1]])]
    if frozen:
        assert not any(n.startswith("backbone.") for n in moved)
    assert "head.w" in moved and "head.b" in moved


@pytest.mark.parametrize("name", RULES)
def test_group_update_equals_per_tensor_updates(name):
    """OptaxRule updates a whole group at once; a tensor whose gradient
    is missing on a step skips it and falls behind the others' update
    count. Three steps over one group, `b` without a gradient on the
    first, equal bit for bit to one optimizer a tensor."""
    from tpupose_torch.engine.optimizers import OptaxRule

    rs = np.random.RandomState(4)
    init = {n: rs.normal(0, 1, s).astype(np.float32)
            for n, s in (("a", (5, 3)), ("b", (4,)), ("c", (3, 2)))}
    grads = [{n: rs.normal(0, 1, v.shape).astype(np.float32)
              for n, v in init.items()} for _ in range(3)]
    kw = dict(OPTAX_DEFAULTS[name], lr=3e-2)
    if name not in ("fromage", "yogi"):
        kw["weight_decay"] = 1e-2
    group = {n: torch.nn.Parameter(T(v.copy())) for n, v in init.items()}
    alone = {n: torch.nn.Parameter(T(v.copy())) for n, v in init.items()}
    opt = OptaxRule(list(group.values()), name, **kw)
    opts = {n: OptaxRule([p], name, **kw) for n, p in alone.items()}
    for t, g in enumerate(grads):
        for n in init:
            missing = n == "b" and t == 0
            group[n].grad = None if missing else T(g[n].copy())
            alone[n].grad = None if missing else T(g[n].copy())
            if not missing:
                opts[n].step()
        opt.step()
    assert opt.state[group["b"]]["count"] == 2
    for n in init:
        assert torch.equal(group[n], alone[n]), n


def test_fromage_decay_stays_at_the_first_update_under_a_schedule():
    """optax 0.2.6's add_decayed_weights never advances the count of its
    schedule state, so fromage's decay (m - 1) stays at update 0 while
    its lr scale follows the schedule. Pinned here: the decay at update
    t would move the parameters by more than 1e-3."""
    state = optax.fromage(lambda c: 0.1 * (c + 1)).init({"w": jnp.ones(3)})
    assert int(state[-1].count) == 0
    ch = _Chains("fromage", clip=0.0, warmup=0, lr=0.3, head_lr=0.5)
    rs = np.random.RandomState(3)
    for _ in range(4):
        ch.step(_grads(rs, ch.tree))
    ch.assert_equal()


# the inner rules: sgd, and two of optax's own; torch.optim.Adam takes
# its bias corrections in float64, 1e-5 off optax's float32 ones (held at
# 1e-5 in tests/test_torch_train.py)
@pytest.mark.parametrize("name", ["sgd", "lamb", "nadamw"])
@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_multisteps(name, k):
    """grad_accum_steps=k against optax.MultiSteps around the chain, over
    3 windows and one mini-step more: the parameters after every
    mini-step within 1e-6 of optax's, bit-unchanged on the k - 1 mini-
    steps of a window, the returned norm the mini-batch's own. The
    mini-batches' norms are above the clip and the window's mean below
    it: clipping each mini-batch instead of the mean would be caught."""
    ch = _Chains(name, accum=k, total=4, warmup=0)
    rs = np.random.RandomState(11)
    base = _grads(rs, ch.tree, scale=1.0)
    for t in range(3 * k + 1):
        # each mini-batch: a shared part plus a large one the window
        # averages away (alternating signs, so the mean's norm is small)
        sign = 1.0 if t % 2 == 0 else -1.0
        noise = _grads(rs, ch.tree, scale=6.0) if t % 2 == 0 else noise
        grads = {g: {n: base[g][n] + sign * noise[g][n] for n in d}
                 for g, d in base.items()}
        before = ch.port_params()
        want_norm, norm = ch.step(grads)
        assert want_norm > 10.0
        np.testing.assert_allclose(norm, want_norm, rtol=1e-6)
        ch.assert_equal()
        emit = (t + 1) % k == 0
        same = [torch.equal(before[n], p.detach())
                for n, p in ch.tparams.items()]
        assert all(same) is not emit, t
        assert ch.opt.count == (t + 1) // k
        assert ch.opt.mini_step == (t + 1) % k


@pytest.mark.parametrize("name", ["adam", "lars"])
def test_accumulation_resumes_inside_a_window(name):
    """k = 3: a state_dict taken after 4 mini-steps (one inside the
    second window), written and read by torch.save / torch.load, loaded
    into a fresh optimizer: 5 more mini-steps give bit-equal parameters
    to the run that never stopped."""
    runs = [_Chains(name, accum=3), _Chains(name, accum=3)]
    rs = np.random.RandomState(5)
    grads = [_grads(rs, runs[0].tree) for _ in range(9)]
    for g in grads[:4]:
        runs[0].step(g)
    buf = io.BytesIO()
    torch.save({"opt": runs[0].opt.state_dict(),
                "params": runs[0].port_params()}, buf)
    buf.seek(0)
    sd = torch.load(buf, weights_only=True)
    with torch.no_grad():
        for n, p in runs[1].tparams.items():
            p.copy_(sd["params"][n])
    runs[1].opt.load_state_dict(sd["opt"])
    assert runs[1].opt.mini_step == 1 and runs[1].opt.count == 1
    for g in grads[4:]:
        for r in runs:
            for n, p in r.tparams.items():
                a, b = n.split(".")
                p.grad = T(g[a][b].copy())
            r.opt.step()
    for n, p in runs[0].tparams.items():
        assert torch.equal(p.detach(), runs[1].tparams[n].detach()), n


class _Net(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        for g, d in tree.items():
            m = torch.nn.Module()
            for k, v in d.items():
                m.register_parameter(k, torch.nn.Parameter(T(v.copy())))
            self.add_module(g, m)


@pytest.mark.parametrize("k", [2, 3])
def test_ema_moves_on_every_mini_step(k):
    """TrainState.apply_gradients under grad_accum_steps=k against JAX's
    TrainState over MultiSteps: the step and the EMA advance on every
    mini-step (decay min(d, (1 + t) / (10 + t)) at the mini-step count,
    toward parameters that move only at a window's end); the returned
    grad_norm is the mini-batch's norm (JAX's metric), not the norm of
    the mean that the clip sees."""
    tree = _tree()
    kw = dict(name="nadamw", lr=1e-2, head_lr=5e-2)
    (jb, jh), (tb, th) = _schedules(1e-2, 5e-2, 4, 1)
    tx = j_make_optimizer(JOptimizerConfig(**kw), schedule=jb,
                          head_schedule=jh, params=tree,
                          is_head=lambda p: not j_is_backbone(p),
                          grad_clip_norm=10.0, grad_accum_steps=k)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    js = JState(step=jnp.zeros((), jnp.int32), params=params,
                batch_stats={}, opt_state=tx.init(params), apply_fn=None,
                tx=tx, ema_params=jax.tree_util.tree_map(jnp.array, params),
                ema_decay=0.9)
    net = _Net(tree)
    opt = make_optimizer(OptimizerConfig(**kw), net.named_parameters(),
                         schedule=tb, head_schedule=th,
                         is_head=lambda n: not is_backbone_path(n),
                         grad_clip_norm=10.0, grad_accum_steps=k)
    ts = TrainState(net, opt, ema_decay=0.9)
    rs = np.random.RandomState(2)
    names = [n for n, _ in net.named_parameters()]
    for t in range(2 * k + 1):
        grads = _grads(rs, tree)
        js = js.apply_gradients(jax.tree_util.tree_map(jnp.asarray, grads))
        for n, p in net.named_parameters():
            a, b = n.split(".")
            p.grad = T(grads[a][b].copy())
        norm = ts.apply_gradients()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(
            grads)), rtol=1e-6)
        assert ts.step == int(js.step) == t + 1
        for n, e in zip(names, ts.ema):
            a, b = n.split(".")
            _assert_close(e.numpy(), js.ema_params[a][b], n)
            _assert_close(dict(net.named_parameters())[n].detach().numpy(),
                          js.params[a][b], n)


def test_lr_scheduler_counts_updates_under_accumulation():
    """Builder.lr_scheduler with grad_accum_steps=4 against JAX's: the
    warmup and the decay in update units (steps_per_epoch // 4 a epoch),
    for both groups, over every update of the run and past its end."""
    from tpupose.configs import default_config as j_default
    from tpupose.engine.builder import Builder as JBuilder
    from tpupose_torch.configs import default_config
    from tpupose_torch.engine.builder import Builder

    got_want = []
    for mod_cfg, mk in ((default_config(), lambda c: Builder(c, "cpu")),
                        (j_default(), JBuilder)):
        c = mod_cfg
        c.train.grad_accum_steps = 4
        c.train.epochs = 5
        c.train.warmup_epochs = 2
        c.optimizer.lr, c.optimizer.head_lr = 1e-3, 5e-3
        c.lr_scheduler.name = "cosine"
        got_want.append(mk(c).lr_scheduler(steps_per_epoch=10))
    (pb, ph), (jb, jh) = got_want
    # 10 mini-steps an epoch = 2 updates: warmup ends at update 4, the
    # run at update 10 (not 40)
    assert float(jb(4)) == pytest.approx(1e-3, rel=1e-6)
    for t in range(14):
        np.testing.assert_allclose(pb(t), float(jb(t)), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(ph(t), float(jh(t)), rtol=1e-6, atol=1e-9)
