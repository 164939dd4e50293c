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
    before every update (engine/schedulers.py).

Update rules follow optax. `sgd`, `nesterov`, `adam`, `adamw`, `adamax`
and `adadelta` are torch.optim's classes, whose rules equal optax's;
`nadam`, `radam`, `rmsprop` and `adagrad` differ in torch.optim (NAdam's
momentum decay, RAdam's and RMSprop's eps placement, RMSprop's momentum
on the unscaled step, Adagrad's initial accumulator), so `OptaxRule`
implements optax's rules for them. Names the JAX registry has and the
port does not raise ValueError, as does gradient accumulation.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

UNPORTED = ("lamb", "lars", "lion", "fromage", "yogi", "adamaxw", "nadamw")
_NOT_PORTED = ("not ported yet (ROADMAP Queue A item 5, left out of the "
               "training slice)")


class OptaxRule(torch.optim.Optimizer):
    """optax's nadam, radam, rmsprop (with momentum) and adagrad as a
    torch optimizer: p += -lr * update(g), with the update of
    optax.scale_by_adam(nesterov=True), scale_by_radam, scale_by_rms +
    trace, and scale_by_rss respectively. Per-parameter loops; not on
    the main path (which uses Adam)."""

    def __init__(self, params, rule: str, lr: float, b1=0.9, b2=0.999,
                 eps=1e-8, momentum=0.9, decay=0.9, initial_acc=0.1,
                 threshold=5.0):
        if rule not in ("nadam", "radam", "rmsprop", "adagrad"):
            raise ValueError(f"unknown rule {rule!r}")
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      momentum=momentum, decay=decay,
                                      initial_acc=initial_acc,
                                      threshold=threshold))
        self.rule = rule

    @torch.no_grad()
    def step(self, closure=None):
        for grp in self.param_groups:
            lr, b1, b2, eps = grp["lr"], grp["b1"], grp["b2"], grp["eps"]
            for p in grp["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    if self.rule in ("nadam", "radam"):
                        st["mu"] = torch.zeros_like(p)
                        st["nu"] = torch.zeros_like(p)
                    elif self.rule == "rmsprop":
                        st["nu"] = torch.zeros_like(p)
                        st["trace"] = torch.zeros_like(p)
                    else:
                        st["sum"] = torch.full_like(p, grp["initial_acc"])
                st["count"] += 1
                t = st["count"]
                if self.rule in ("nadam", "radam"):
                    mu, nu = st["mu"], st["nu"]
                    mu.mul_(b1).add_(g, alpha=1 - b1)
                    nu.mul_(b2).add_(g * g, alpha=1 - b2)
                    nu_hat = nu / (1 - b2 ** t)
                    if self.rule == "nadam":
                        mu_hat = (b1 * (mu / (1 - b1 ** (t + 1)))
                                  + (1 - b1) * (g / (1 - b1 ** t)))
                        u = mu_hat / (nu_hat.sqrt() + eps)
                    else:
                        mu_hat = mu / (1 - b1 ** t)
                        ro_inf = 2.0 / (1.0 - b2) - 1.0
                        b2t = b2 ** t
                        ro = ro_inf - 2 * t * b2t / (1 - b2t)
                        if ro >= grp["threshold"]:
                            r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                          / ((ro_inf - 4.0) * (ro_inf - 2.0)
                                             * ro))
                            u = r * mu_hat / (nu_hat.sqrt() + eps)
                        else:
                            u = mu_hat
                    p.add_(u, alpha=-lr)
                elif self.rule == "rmsprop":
                    d = grp["decay"]
                    st["nu"].mul_(d).add_(g * g, alpha=1 - d)
                    u = -lr * (g * torch.rsqrt(st["nu"] + eps))
                    st["trace"].mul_(grp["momentum"]).add_(u)
                    p.add_(st["trace"])
                else:
                    st["sum"].add_(g * g)
                    s = st["sum"]
                    inv = torch.where(s > 0, torch.rsqrt(s + eps),
                                      torch.zeros_like(s))
                    p.add_(inv * g, alpha=-lr)


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
    raise AssertionError(name)


OPTIMIZERS = ("sgd", "nesterov", "adam", "adamw", "adamax", "nadam", "radam",
              "rmsprop", "adagrad", "adadelta")


class GroupedOptimizer:
    """clip_by_global_norm -> {base, head, frozen} groups -> update.

    `step()` reads every parameter's .grad, returns the global norm
    before clipping (a 0-dim device tensor), clips in place, sets each
    group's lr from its schedule at the current update count, updates,
    and counts the update."""

    def __init__(self, named_params, inner_factory, schedules: dict,
                 labels: dict, grad_clip_norm: float = 0.0):
        self.params = [p for _, p in named_params]
        groups = []
        for label in ("base", "head"):
            ps = [p for n, p in named_params if labels[n] == label]
            if ps:
                groups.append({"params": ps, "label": label})
        self.schedules = schedules
        self.grad_clip_norm = float(grad_clip_norm or 0.0)
        self.inner = inner_factory(groups) if groups else None
        self.count = 0

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

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        norm = self.global_norm()
        if self.grad_clip_norm > 0:
            grads = [p.grad for p in self.params if p.grad is not None]
            scale = torch.where(norm < self.grad_clip_norm,
                                torch.ones_like(norm),
                                self.grad_clip_norm / norm)
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
                "inner": self.inner.state_dict() if self.inner else None}

    def load_state_dict(self, sd: dict):
        self.count = int(sd["count"])
        if self.inner is not None:
            self.inner.load_state_dict(sd["inner"])


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
    (default: constant cfg.lr / cfg.head_lr)."""
    name = cfg.name.lower()
    if name in UNPORTED:
        raise ValueError(f"optimizer {cfg.name!r} is {_NOT_PORTED}")
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.name!r}; have "
                         f"{sorted(OPTIMIZERS)}")
    if grad_accum_steps and grad_accum_steps > 1:
        raise ValueError(f"gradient accumulation (grad_accum_steps="
                         f"{grad_accum_steps}) is {_NOT_PORTED}")
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
                            grad_clip_norm)
