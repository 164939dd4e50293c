"""The training comparison: the plain float32 reference follows the
program's first steps from the same weights, crops, joints and draws,
and three kinds of number are taken, each a gap of norms measured by the
worst leaf (tensor):

  loss_gap    max over the steps of |loss - reference loss| / |ref loss|;
  grad_gap    the first update's clipped gradient as the optimizer took
              it: max over leaves of |norm - ref norm| / max(ref norm,
              the median leaf's ref norm);
  change_gap  each parameter's change over the steps, measured alike;

and, where a gap of norms cannot tell the program from the control (a
random-init ResNet's training step in bf16 is off float64 by about 1% a
leaf and by 20-40% on a few early BatchNorm leaves, in the program and in
the plain reference under bf16 autocast alike), the same worst and median
leaf measures of the difference itself, |g - g_ref| / max(|g_ref|, the
median leaf's |g_ref|): grad_err, grad_err_median, change_err,
change_err_median; and the decoder's leaves alone (every tensor outside
`backbone.`, whose gradient does not pass back through the backbone):
head_grad_gap, head_grad_err and their medians.

Leaves whose reference gradient at the first step is under a thousandth
of the median leaf's move by round-off alone under Adam; they are left
out of change_gap by that rule, whatever their names.
"""

from __future__ import annotations

import statistics

import torch

from posebench.reference import common as R
from posebench.reference.serve_check import no_tf32

BUFFER_KINDS = ("bn_mean", "bn_var", "count")
NEGLIGIBLE = 1e-3


def reference_run(ref_module, P: dict, widths: dict, cfg, steps, hm_hw,
                  quant: bool = False) -> dict:
    """Follow `steps` [(device batch, draws)] from weights P. Returns
    {"losses": [...], "grads": {name: the first update's clipped
    gradient}, "changes": {name: the change over the steps}} over the
    trainable tensors (every spec but BatchNorm's running statistics).
    cfg: the program's configuration (optimizer, clipping, augmentation
    factors, target sigma)."""
    o = cfg.optimizer
    if o.name not in ("adam", "adamw"):
        raise ValueError(f"the reference follows adam and adamw, not "
                         f"{o.name!r}")
    kinds = {n: k for n, _, k in ref_module.param_specs(widths)}
    names = [n for n, k in kinds.items() if k not in BUFFER_KINDS]
    bufs = {n: P[n] for n, k in kinds.items() if k in BUFFER_KINDS}
    params = {n: P[n].detach().clone().requires_grad_(True) for n in names}
    p0 = {n: P[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(P[n]) for n in names}
    v = {n: torch.zeros_like(P[n]) for n in names}
    lr = {n: (o.lr if n.startswith("backbone.") else o.head_lr)
          for n in names}
    b1, b2 = o.betas
    hw = tuple(widths["image_size"])
    losses, first = [], None
    with no_tf32():
        for t, (batch, draws) in enumerate(steps, start=1):
            mult, rot = draws["affine"]
            img = R.warp_bilinear(batch["images"],
                                  R.augment_matrices(mult, rot, hw), hw)
            joints, vis = R.move_joints(batch["joints"], batch["visibility"],
                                        mult, rot, hm_hw)
            x = R.jitter_normalize(img / 255.0, *draws["jitter"])
            target, tw = R.gaussian_targets(joints, vis, hm_hw,
                                            cfg.data.sigma)
            pred = ref_module.forward({**params, **bufs}, x, widths,
                                      train=True, quant=quant)
            if cfg.loss.use_target_weight:
                loss = R.joints_mse(pred, target, tw)
            else:
                loss = 0.5 * ((pred - target) ** 2).mean()
            grads = torch.autograd.grad(loss, [params[n] for n in names])
            grads, _ = R.clip_global(grads, cfg.train.grad_clip_norm)
            losses.append(float(loss.detach()))
            if first is None:
                first = {n: g.detach() for n, g in zip(names, grads)}
            with torch.no_grad():
                for n, g in zip(names, grads):
                    p, m[n], v[n] = R.adam_update(
                        params[n], g, m[n], v[n], t, lr[n], b1, b2, o.eps,
                        o.weight_decay, decoupled=(o.name == "adamw"))
                    params[n] = p.requires_grad_(True)
    change = {n: params[n].detach() - p0[n] for n in names}
    return {"losses": losses, "grads": first, "changes": change}


def _leaf_gaps(ref: dict, got: dict, keep) -> list:
    """Each kept leaf's gap of norms, over its reference norm or the
    median leaf's, whichever is larger."""
    norm = {n: float(ref[n].norm()) for n in keep}
    med = statistics.median(norm.values())
    return [abs(float(got[n].norm()) - norm[n]) / max(norm[n], med, 1e-30)
            for n in keep]


def _leaf_errors(ref: dict, got: dict, keep) -> list:
    """Each kept leaf's |got - ref| over the same denominator."""
    norm = {n: float(ref[n].norm()) for n in keep}
    med = statistics.median(norm.values())
    return [float((got[n].to(ref[n].device) - ref[n]).norm())
            / max(norm[n], med, 1e-30) for n in keep]


def compare(ref: dict, losses, grads: dict, changes: dict) -> dict:
    """A side's numbers (its losses, {name: first gradient}, {name: change
    over the steps}, tensors on any device; a missing gradient counts as
    zero) against the reference run."""
    rg = ref["grads"]
    grads = {n: grads.get(n, torch.zeros_like(rg[n])) for n in rg}
    changes = {n: changes.get(n, torch.zeros_like(rg[n])) for n in rg}
    rl = ref["losses"]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(losses, rl)) if len(losses) == len(rl) \
        else float("nan")
    norms = {n: float(g.norm()) for n, g in rg.items()}
    med = statistics.median(norms.values())
    moved = [n for n in rg if norms[n] >= NEGLIGIBLE * med]
    out = {"loss_gap": loss_gap,
           "first_loss_gap": abs(losses[0] - rl[0]) / max(abs(rl[0]), 1e-30)}
    head = [n for n in rg if not n.startswith("backbone.")]
    for name, fn, r, got, keep in (
            ("head_grad_gap", _leaf_gaps, rg, grads, head),
            ("head_grad_err", _leaf_errors, rg, grads, head),
            ("grad_gap", _leaf_gaps, rg, grads, list(rg)),
            ("change_gap", _leaf_gaps, ref["changes"], changes, moved),
            ("grad_err", _leaf_errors, rg, grads, list(rg)),
            ("change_err", _leaf_errors, ref["changes"], changes, moved)):
        v = fn(r, got, keep)
        out[name] = max(v)
        out[name + "_median"] = statistics.median(v)
    out.update(leaves=len(rg), leaves_negligible=len(rg) - len(moved))
    return out
