"""Optimizer registry over torch.optim (counterpart of
tpupose/engine/optimizers.py, which builds an optax chain).

`make_optimizer` returns a `GroupedOptimizer` with the JAX chain's
semantics:

  - global-norm clipping first, over ALL gradients, frozen ones included
    (optax.clip_by_global_norm: g * max_norm / norm when norm >= max_norm;
    the division is by the norm itself, not norm + 1e-6 as in torch's
    clip_grad_norm_), computed on the device without a host sync;
  - three groups (optax.multi_transform): `head` at the head schedule,
    `base` at the base schedule, `frozen` untouched (set_to_zero); a
    frozen label wins over head;
  - each group's lr is its own schedule evaluated at the update count
    before every update (engine/schedulers.py);
  - with grad_accum_steps k > 1, optax.MultiSteps around the whole chain:
    the gradients of k mini-steps are averaged (a running mean), the
    clip and the update run once on the mean at every k-th mini-step,
    the other mini-steps leave the parameters as they are, and the
    update count (so every schedule) advances once per k mini-steps.

Update rules follow optax. `sgd`, `nesterov`, `adam`, `adamw`, `adamax`
and `adadelta` are torch.optim's classes, whose rules equal optax's;
`nadam`, `radam`, `rmsprop` and `adagrad` differ in torch.optim (NAdam's
momentum decay, RAdam's and RMSprop's eps placement, RMSprop's momentum
on the unscaled step, Adagrad's initial accumulator), and `lamb`,
`lars`, `lion`, `fromage`, `yogi`, `adamaxw` and `nadamw` have no
torch.optim class, so `OptaxRule` implements optax's rules for them. The
JAX registry builds the last seven from the lr (and weight_decay) alone:
every other constant is optax 0.2.6's default (OPTAX_DEFAULTS), and
cfg.betas / cfg.eps do not reach them.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import numpy as np
import torch

# optax 0.2.6's defaults of the rules the JAX registry builds from the lr
# (and weight_decay) alone (optax/_src/alias.py)
OPTAX_DEFAULTS = {
    "lamb": dict(b1=0.9, b2=0.999, eps=1e-6),
    "lars": dict(trust_coefficient=1e-3, eps=0.0, momentum=0.9),
    "lion": dict(b1=0.9, b2=0.99),
    "fromage": dict(min_norm=1e-6),
    "yogi": dict(b1=0.9, b2=0.999, eps=1e-3, initial_acc=1e-6),
    "adamaxw": dict(b1=0.9, b2=0.999, eps=1e-8),
    "nadamw": dict(b1=0.9, b2=0.999, eps=1e-8),
}
_RULES = ("nadam", "radam", "rmsprop", "adagrad") + tuple(OPTAX_DEFAULTS)


def _trust_ratio(us, ps, coeff=1.0, eps=0.0, min_norm=0.0):
    """optax.scale_by_trust_ratio on each leaf of a list: u * coeff * |p|
    / (|u| + eps), the norms clipped below at min_norm, and a ratio of 1
    where either norm is zero (the leaf would never move otherwise). The
    ratios stay on the device: no host sync."""
    pn = torch.stack(torch._foreach_norm(ps)).clamp_min(min_norm)
    un = torch.stack(torch._foreach_norm(us)).clamp_min(min_norm)
    r = coeff * pn / (un + eps)
    r = torch.where((pn == 0) | (un == 0), torch.ones_like(r), r)
    return torch._foreach_mul(us, list(r.unbind()))


def _bias_correction(decay: float, t: int) -> float:
    """1 - decay^t as optax computes it: the float32 decay's power,
    rounded to float32 (XLA's float32 pow is correctly rounded up to
    t ~ 3000), subtracted in float32. At small t, 1 - 0.999^t in float32
    is ~1e-5 off its exact value, so an exact correction would leave
    optax's update by as much."""
    p = np.float32(float(np.float32(decay)) ** t)
    return float(np.float32(1.0) - p)


class OptaxRule(torch.optim.Optimizer):
    """optax's nadam, radam, rmsprop (with momentum), adagrad, lamb,
    lars, lion, fromage, yogi, adamaxw and nadamw as a torch optimizer:
    p += -lr * update(g) with the update of optax.scale_by_adam(nesterov=
    True), scale_by_radam, scale_by_rms + trace, scale_by_rss; lamb:
    scale_by_adam + decayed weights + trust ratio; lars: decayed weights
    + trust ratio (coefficient 1e-3) then -lr, then a momentum trace;
    lion: the sign of (1 - b1) g + b1 m, + decayed weights; fromage: the
    trust ratio (min norm 1e-6) scaled by lr(t) m(t), m = 1 / sqrt(1 +
    lr^2), plus (m - 1) p; yogi: scale_by_yogi; adamaxw: scale_by_adamax
    + decayed weights; nadamw: nadam + decayed weights. Decay and trust
    ratio reach every parameter, 1-D ones included (optax's default
    masks). A group's `lr0` is its lr at update 0: under a schedule
    optax 0.2.6's add_decayed_weights evaluates fromage's decay (m - 1)
    at the count of a state it never advances, so at update 0 for ever.
    Each group is updated at once by torch._foreach_* ops (a few
    launches an op for all of its tensors, not one a tensor)."""

    def __init__(self, params, rule: str, lr: float, b1=0.9, b2=0.999,
                 eps=1e-8, momentum=0.9, decay=0.9, initial_acc=0.1,
                 threshold=5.0, weight_decay=0.0, trust_coefficient=1.0,
                 min_norm=0.0):
        if rule not in _RULES:
            raise ValueError(f"unknown rule {rule!r}")
        super().__init__(params, dict(
            lr=lr, lr0=lr, b1=b1, b2=b2, eps=eps, momentum=momentum,
            decay=decay, initial_acc=initial_acc, threshold=threshold,
            weight_decay=weight_decay, trust_coefficient=trust_coefficient,
            min_norm=min_norm))
        self.rule = rule

    def _init_state(self, st, p, grp):
        st["count"] = 0
        if self.rule in ("nadam", "radam", "lamb", "nadamw", "adamaxw"):
            st["mu"] = torch.zeros_like(p)
            st["nu"] = torch.zeros_like(p)
        elif self.rule == "yogi":
            st["mu"] = torch.full_like(p, grp["initial_acc"])
            st["nu"] = torch.full_like(p, grp["initial_acc"])
        elif self.rule == "rmsprop":
            st["nu"] = torch.zeros_like(p)
            st["trace"] = torch.zeros_like(p)
        elif self.rule == "lars":
            st["trace"] = torch.zeros_like(p)
        elif self.rule == "lion":
            st["mu"] = torch.zeros_like(p)
        elif self.rule == "adagrad":
            st["sum"] = torch.full_like(p, grp["initial_acc"])

    @torch.no_grad()
    def step(self, closure=None):
        for grp in self.param_groups:
            # one update of the whole group in torch._foreach_* ops, its
            # parameters bucketed by update count (which differs only
            # where a gradient was missing on some step)
            buckets: dict = {}
            for p in grp["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    self._init_state(st, p, grp)
                st["count"] += 1
                buckets.setdefault(st["count"], []).append(p)
            for t, ps in buckets.items():
                self._update(ps, [p.grad for p in ps],
                             [self.state[p] for p in ps], t, grp)

    def _update(self, ps, gs, sts, t, grp):
        lr, b1, b2, eps = grp["lr"], grp["b1"], grp["b2"], grp["eps"]
        wd = grp["weight_decay"]
        rule = self.rule
        def state(key):
            return [st[key] for st in sts]

        def ema(xs, ys, decay):                 # xs = decay xs + (1-decay) ys
            torch._foreach_mul_(xs, decay)
            torch._foreach_add_(xs, ys, alpha=1 - decay)

        if rule in ("nadam", "radam", "lamb", "nadamw"):
            mu, nu = state("mu"), state("nu")
            ema(mu, gs, b1)
            ema(nu, torch._foreach_mul(gs, gs), b2)
            if rule == "radam":
                nu_hat = torch._foreach_div(nu, 1 - b2 ** t)
                u = torch._foreach_div(mu, 1 - b1 ** t)
                ro_inf = 2.0 / (1.0 - b2) - 1.0
                b2t = b2 ** t
                ro = ro_inf - 2 * t * b2t / (1 - b2t)
                if ro >= grp["threshold"]:
                    r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                  / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                    den = torch._foreach_sqrt(nu_hat)
                    torch._foreach_add_(den, eps)
                    torch._foreach_mul_(u, r)
                    torch._foreach_div_(u, den)
            else:
                den = torch._foreach_div(nu, _bias_correction(b2, t))
                torch._foreach_sqrt_(den)
                torch._foreach_add_(den, eps)
                if rule == "lamb":
                    u = torch._foreach_div(mu, _bias_correction(b1, t))
                else:                                   # Nesterov
                    u = torch._foreach_div(mu, _bias_correction(b1, t + 1))
                    torch._foreach_mul_(u, b1)
                    gb = torch._foreach_div(gs, _bias_correction(b1, t))
                    torch._foreach_mul_(gb, 1 - b1)
                    torch._foreach_add_(u, gb)
                torch._foreach_div_(u, den)
                if rule != "nadam":
                    torch._foreach_add_(u, ps, alpha=wd)
                if rule == "lamb":
                    u = _trust_ratio(u, ps)
            torch._foreach_add_(ps, u, alpha=-lr)
        elif rule == "rmsprop":
            nu, trace = state("nu"), state("trace")
            ema(nu, torch._foreach_mul(gs, gs), grp["decay"])
            inv = torch._foreach_add(nu, eps)
            torch._foreach_rsqrt_(inv)
            u = torch._foreach_mul(gs, inv)
            torch._foreach_mul_(u, -lr)
            torch._foreach_mul_(trace, grp["momentum"])
            torch._foreach_add_(trace, u)
            torch._foreach_add_(ps, trace)
        elif rule == "adagrad":
            s = state("sum")
            torch._foreach_add_(s, torch._foreach_mul(gs, gs))
            inv = torch._foreach_add(s, eps)
            torch._foreach_rsqrt_(inv)
            # optax takes 0 where the sum is 0 (so is g there): an inf
            # from eps = 0 is clamped to a finite value that g zeroes
            torch._foreach_clamp_max_(inv, torch.finfo(torch.float32).max)
            u = torch._foreach_mul(inv, gs)
            torch._foreach_add_(ps, u, alpha=-lr)
        elif rule == "lars":
            trace = state("trace")
            u = _trust_ratio(torch._foreach_add(gs, ps, alpha=wd), ps,
                             grp["trust_coefficient"], eps)
            torch._foreach_mul_(trace, grp["momentum"])
            torch._foreach_add_(trace, u, alpha=-lr)
            torch._foreach_add_(ps, trace)
        elif rule == "lion":
            mu = state("mu")
            u = torch._foreach_mul(mu, b1)
            torch._foreach_add_(u, gs, alpha=1 - b1)
            torch._foreach_sign_(u)
            ema(mu, gs, b2)
            torch._foreach_add_(u, ps, alpha=wd)
            torch._foreach_add_(ps, u, alpha=-lr)
        elif rule == "fromage":
            mult = 1.0 / math.sqrt(1.0 + lr * lr)
            mult0 = 1.0 / math.sqrt(1.0 + grp["lr0"] ** 2)
            u = _trust_ratio(gs, ps, min_norm=grp["min_norm"])
            torch._foreach_mul_(u, -(mult * lr))
            torch._foreach_add_(u, ps, alpha=mult0 - 1.0)
            torch._foreach_add_(ps, u)
        elif rule == "yogi":
            mu, nu = state("mu"), state("nu")
            ema(mu, gs, b1)
            g2 = torch._foreach_mul(gs, gs)
            d = torch._foreach_sub(nu, g2)
            torch._foreach_sign_(d)
            torch._foreach_mul_(d, g2)
            torch._foreach_mul_(d, 1 - b2)
            torch._foreach_sub_(nu, d)
            den = torch._foreach_div(nu, _bias_correction(b2, t))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            u = torch._foreach_div(mu, _bias_correction(b1, t))
            torch._foreach_div_(u, den)
            torch._foreach_add_(ps, u, alpha=-lr)
        else:                                           # adamaxw
            mu, nu = state("mu"), state("nu")
            ema(mu, gs, b1)
            a = torch._foreach_abs(gs)
            torch._foreach_add_(a, eps)
            torch._foreach_mul_(nu, b2)
            torch._foreach_maximum_(nu, a)
            u = torch._foreach_div(mu, _bias_correction(b1, t))
            torch._foreach_div_(u, nu)
            torch._foreach_add_(u, ps, alpha=wd)
            torch._foreach_add_(ps, u, alpha=-lr)


def _torch_optimizer(name: str, groups, cfg) -> torch.optim.Optimizer:
    b1, b2 = cfg.betas
    if name in ("sgd", "nesterov"):
        return torch.optim.SGD(groups, lr=0.0, momentum=cfg.momentum,
                               nesterov=(name == "nesterov"))
    if name == "adam":
        return torch.optim.Adam(groups, lr=0.0, betas=(b1, b2), eps=cfg.eps)
    if name == "adamw":
        return torch.optim.AdamW(groups, lr=0.0, betas=(b1, b2), eps=cfg.eps,
                                 weight_decay=cfg.weight_decay)
    if name == "adamax":
        return torch.optim.Adamax(groups, lr=0.0, betas=(b1, b2),
                                  eps=cfg.eps)
    if name == "adadelta":
        return torch.optim.Adadelta(groups, lr=0.0, rho=0.9, eps=cfg.eps)
    if name in ("nadam", "radam"):
        return OptaxRule(groups, name, 0.0, b1=b1, b2=b2, eps=cfg.eps)
    if name == "rmsprop":
        return OptaxRule(groups, name, 0.0, eps=cfg.eps,
                         momentum=cfg.momentum)
    if name == "adagrad":
        return OptaxRule(groups, name, 0.0, eps=cfg.eps)
    wd = {} if name in ("fromage", "yogi") else dict(
        weight_decay=cfg.weight_decay)
    return OptaxRule(groups, name, 0.0, **OPTAX_DEFAULTS[name], **wd)


OPTIMIZERS = ("sgd", "nesterov", "adam", "adamw", "adamax", "nadam", "radam",
              "rmsprop", "adagrad", "adadelta") + tuple(OPTAX_DEFAULTS)


class GroupedOptimizer:
    """[MultiSteps ->] clip_by_global_norm -> {base, head, frozen} groups
    -> update.

    `step()` reads every parameter's .grad and returns the global norm of
    those gradients (a 0-dim device tensor). Without accumulation it
    clips them in place, sets each group's lr from its schedule at the
    current update count, updates, and counts the update. With
    accumulation (grad_accum_steps k > 1) it adds them to the running
    mean of the window and returns; at the k-th mini-step the mean takes
    the gradients' place, is clipped, and updates. The mean, the
    mini-step count and the update count are in `state_dict()`, so a
    resume inside a window goes on exactly."""

    def __init__(self, named_params, inner_factory, schedules: dict,
                 labels: dict, grad_clip_norm: float = 0.0,
                 grad_accum_steps: int = 1):
        self.params = [p for _, p in named_params]
        groups = []
        for label in ("base", "head"):
            ps = [p for n, p in named_params if labels[n] == label]
            if ps:
                groups.append({"params": ps, "label": label,
                               "lr0": float(schedules[label](0))})
        self.schedules = schedules
        self.grad_clip_norm = float(grad_clip_norm or 0.0)
        self.inner = inner_factory(groups) if groups else None
        self.count = 0
        self.accum_steps = max(int(grad_accum_steps or 1), 1)
        self.mini_step = 0
        self.acc = None

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def global_norm(self) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        if not grads:
            return torch.zeros(())
        return torch.linalg.vector_norm(torch.stack(
            [n.float() for n in torch._foreach_norm(grads)]))

    def lrs(self) -> dict:
        """Each group's lr for the next update."""
        return {k: float(s(self.count)) for k, s in self.schedules.items()}

    def _accumulate(self) -> bool:
        """Add this mini-step's gradients to the window's running mean
        (optax.MultiSteps: acc += (g - acc) / (n + 1); a parameter without
        a gradient adds zeros). True at the window's last mini-step, with
        the mean in every .grad and the window reset."""
        if self.acc is None:
            self.acc = [torch.zeros_like(p) for p in self.params]
        n = self.mini_step
        gs = [p.grad if p.grad is not None else torch.zeros_like(a)
              for a, p in zip(self.acc, self.params)]
        d = torch._foreach_sub(gs, self.acc)
        torch._foreach_div_(d, n + 1)
        torch._foreach_add_(self.acc, d)
        self.mini_step = (n + 1) % self.accum_steps
        if self.mini_step:
            return False
        for a, p in zip(self.acc, self.params):
            p.grad = a.clone()
        torch._foreach_zero_(self.acc)
        return True

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        norm = self.global_norm()
        if self.accum_steps > 1 and not self._accumulate():
            return norm
        clip_norm = norm if self.accum_steps == 1 else self.global_norm()
        if self.grad_clip_norm > 0:
            grads = [p.grad for p in self.params if p.grad is not None]
            scale = torch.where(clip_norm < self.grad_clip_norm,
                                torch.ones_like(clip_norm),
                                self.grad_clip_norm / clip_norm)
            torch._foreach_mul_(grads, scale)
        if self.inner is not None:
            lrs = self.lrs()
            for grp in self.inner.param_groups:
                grp["lr"] = lrs[grp["label"]]
            self.inner.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count,
                "inner": self.inner.state_dict() if self.inner else None,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, sd: dict):
        mini_step = int(sd.get("mini_step", 0))
        if mini_step >= self.accum_steps:
            raise ValueError(f"the state is at mini-step {mini_step} of its "
                             f"window; it does not load with "
                             f"grad_accum_steps={self.accum_steps}")
        self.count = int(sd["count"])
        if self.inner is not None:
            self.inner.load_state_dict(sd["inner"])
        self.mini_step = mini_step
        acc = sd.get("acc")
        self.acc = None if acc is None else [
            a.to(p.device, p.dtype).clone() for a, p in zip(acc, self.params)]


def make_optimizer(cfg, named_params: Iterable, schedule: Callable = None,
                   head_schedule: Callable = None,
                   is_head: Optional[Callable[[str], bool]] = None,
                   is_frozen: Optional[Callable[[str], bool]] = None,
                   grad_clip_norm: float = 0.0,
                   grad_accum_steps: int = 1) -> GroupedOptimizer:
    """cfg: an OptimizerConfig; named_params: (name, Parameter) pairs
    (model.named_parameters()). `is_head(name)` / `is_frozen(name)` label
    the groups (frozen wins); without is_head every unfrozen parameter is
    `base`. `schedule` / `head_schedule` map the update count to the lr
    (default: constant cfg.lr / cfg.head_lr). grad_accum_steps > 1
    averages that many mini-steps' gradients into one update."""
    name = cfg.name.lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.name!r}; have "
                         f"{sorted(OPTIMIZERS)}")
    named_params = list(named_params)
    labels = {}
    for n, _ in named_params:
        if is_frozen is not None and is_frozen(n):
            labels[n] = "frozen"
        elif is_head is not None and is_head(n):
            labels[n] = "head"
        else:
            labels[n] = "base"
    base = schedule if schedule is not None else (lambda t: cfg.lr)
    head = head_schedule if head_schedule is not None \
        else (lambda t: cfg.head_lr)
    return GroupedOptimizer(named_params,
                            lambda groups: _torch_optimizer(name, groups,
                                                            cfg),
                            {"base": base, "head": head}, labels,
                            grad_clip_norm, grad_accum_steps)
