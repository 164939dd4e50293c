"""Learning-rate schedules as pure functions of the update count
(counterpart of tpupose/engine/schedulers.py, whose schedules are optax's).

`make_schedule(cfg, base_lr, total_steps, warmup_steps, steps_per_epoch)`
returns `lr(t)`, the learning rate of update t, where t counts the
updates made before it from 0, with optax's semantics:

  - warmup: `join_schedules([linear(0 -> base, warmup), main], [warmup])`,
    so the first update has lr 0 and the main schedule sees t - warmup;
  - `multistep` scales by gamma at every milestone t >= boundary;
  - `cosine` decays to alpha * base with alpha = min_lr / base_lr, so two
    groups with different base lrs have different alphas.

The optimizer (engine/optimizers.py) evaluates each group's own schedule
before each update; a torch LambdaLR built from one lambda would get the
warmup and the per-group alpha wrong. Values are computed in float64;
optax computes in float32, so the two agree to float32 rounding.
"""

from __future__ import annotations

import math


def _polynomial(init, end, power, transition_steps):
    if transition_steps <= 0:
        return lambda t: init

    def lr(t):
        c = min(max(t, 0), transition_steps)
        return (init - end) * (1.0 - c / transition_steps) ** power + end
    return lr


def _linear(init, end, transition_steps):
    return _polynomial(init, end, 1.0, transition_steps)


def _cosine_decay(init, decay_steps, alpha=0.0):
    def lr(t):
        c = min(t, decay_steps)
        return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(
            math.pi * c / decay_steps)) + alpha)
    return lr


def _exponential_decay(init, transition_steps, decay_rate, staircase=False):
    if transition_steps <= 0 or decay_rate == 0:
        return lambda t: init

    def lr(t):
        if t <= 0:
            return init
        p = t / transition_steps
        if staircase:
            p = math.floor(p)
        return init * decay_rate ** p
    return lr


def _piecewise_constant(init, boundaries_and_scales):
    items = sorted(boundaries_and_scales.items())

    def lr(t):
        v = init
        for b, s in items:
            if t >= b:
                v *= s
        return v
    return lr


def _cosine_onecycle(transition_steps, peak, pct_start=0.3, div_factor=25.0,
                     final_div_factor=1e4):
    """optax.cosine_onecycle_schedule: a cosine-interpolated piecewise
    schedule from peak/div_factor up to peak at pct_start, then down to
    peak/(div_factor*final_div_factor) at transition_steps."""
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    values = [peak / div_factor]
    for s in (div_factor, 1.0 / (div_factor * final_div_factor)):
        values.append(values[-1] * s)

    def lr(t):
        for i in range(2):
            if bounds[i] <= t < bounds[i + 1]:
                pct = (t - bounds[i]) / (bounds[i + 1] - bounds[i])
                a, b = values[i], values[i + 1]
                return b + (a - b) / 2.0 * (math.cos(math.pi * pct) + 1.0)
        return values[-1] if t >= bounds[-1] else 0.0
    return lr


def _cosine(cfg, base_lr, total_steps, steps_per_epoch=1):
    return _cosine_decay(base_lr, max(total_steps, 1),
                         alpha=cfg.min_lr / max(base_lr, 1e-12))


def _step(cfg, base_lr, total_steps, steps_per_epoch=1):
    return _exponential_decay(base_lr, cfg.step_size * steps_per_epoch,
                              cfg.gamma, staircase=True)


def _multistep(cfg, base_lr, total_steps, steps_per_epoch=1):
    return _piecewise_constant(base_lr, {int(m * steps_per_epoch): cfg.gamma
                                         for m in cfg.milestones})


def _exponential(cfg, base_lr, total_steps, steps_per_epoch=1):
    return _exponential_decay(base_lr, max(steps_per_epoch, 1), cfg.gamma)


def _linear_sched(cfg, base_lr, total_steps, steps_per_epoch=1):
    return _linear(base_lr, cfg.min_lr, max(total_steps, 1))


def _constant(cfg, base_lr, total_steps, steps_per_epoch=1):
    return lambda t: base_lr


def _onecycle(cfg, base_lr, total_steps, steps_per_epoch=1):
    return _cosine_onecycle(max(total_steps, 1), base_lr)


SCHEDULERS = {
    "cosine": _cosine,
    "step": _step,
    "multistep": _multistep,
    "exponential": _exponential,
    "linear": _linear_sched,
    "constant": _constant,
    "onecycle": _onecycle,
}


def make_schedule(cfg, base_lr: float, total_steps: int,
                  warmup_steps: int = 0, steps_per_epoch: int = 1):
    """lr(t) for update t (t = earlier updates), with linear warmup from
    0 prepended. cfg: a SchedulerConfig (name, min_lr, step_size, gamma,
    milestones)."""
    name = cfg.name.lower()
    if name not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {cfg.name!r}; have "
                         f"{sorted(SCHEDULERS)}")
    if name in ("cosine", "linear", "onecycle"):
        main = SCHEDULERS[name](cfg, base_lr,
                                max(total_steps - warmup_steps, 1))
    else:
        main = SCHEDULERS[name](cfg, base_lr, total_steps, steps_per_epoch)
    if warmup_steps <= 0:
        return main
    warm = _linear(0.0, base_lr, warmup_steps)
    return lambda t: warm(t) if t < warmup_steps else main(t - warmup_steps)
