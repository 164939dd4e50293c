"""Checkpointing: periodic + best, with exact resume (counterpart of
tpupose/engine/checkpoint.py, which stores orbax checkpoints).

The same policy: periodic saves every `interval` EPOCHS (callers pass the
epoch index; gating on the step is the fallback for epoch-less callers)
keeping the newest `max_to_keep`; a single best-by-metric slot (lower is
better) in its own directory, which the periodic clean-up never touches,
with its metric and step in `best_meta.json` so they survive restarts;
`restore(best=)` and `restore_path("<dir>@best")`; `average_checkpoints`
(SWA over the periodic checkpoints).

Files are `torch.save` of TrainState.state_dict(): {step, model (state
dict with the BatchNorm statistics), optimizer (update count and
torch.optim state), ema}, written to a temporary name and renamed, as
`<dir>/periodic/<step>.pt` and `<dir>/best/<step>.pt`. Under a process
group every rank takes part in building that dict (under tensor
parallelism it gathers the sharded tensors, so a file is the
one-process format at any model axis) and rank 0 writes it.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from tpupose_torch.utils.logging import is_master, printS, printT, printW


def _steps(d: str) -> list:
    if not os.path.isdir(d):
        return []
    return sorted(int(f[:-3]) for f in os.listdir(d)
                  if f.endswith(".pt") and f[:-3].isdigit())


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5,
                 interval: int = 1):
        self.directory = os.path.abspath(directory)
        self.interval = max(int(interval), 1)
        self.max_to_keep = max_to_keep
        self._periodic = os.path.join(self.directory, "periodic")
        self._best = os.path.join(self.directory, "best")
        self._meta_path = os.path.join(self.directory, "best_meta.json")
        os.makedirs(self._periodic, exist_ok=True)
        os.makedirs(self._best, exist_ok=True)
        self.best_metric = float("inf")
        self.best_step = -1
        if os.path.exists(self._meta_path):
            try:
                with open(self._meta_path) as f:
                    meta = json.load(f)
                self.best_metric = float(meta.get("metric", float("inf")))
                self.best_step = int(meta.get("step", -1))
            except (ValueError, OSError):
                pass

    @staticmethod
    def _write(sd: dict, path: str):
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(sd, tmp)
        os.replace(tmp, path)

    def save(self, step: int, state, metric: Optional[float] = None,
             force: bool = False, epoch: Optional[int] = None):
        """Best slot when `metric` improves; periodic when the epoch (or
        step) is due or `force`. Every rank calls it with the same
        arguments; rank 0 writes."""
        best = metric is not None and metric < self.best_metric
        due = ((epoch + 1) % self.interval == 0 if epoch is not None
               else step % self.interval == 0)
        # every rank builds the dict (a collective under tensor
        # parallelism), then rank 0 writes it
        sd = state.state_dict() if best or force or due else None
        if best:
            self.best_metric = float(metric)
            self.best_step = step
            if is_master():
                for old in _steps(self._best):
                    os.remove(os.path.join(self._best, f"{old}.pt"))
                self._write(sd, os.path.join(self._best, f"{step}.pt"))
                with open(self._meta_path, "w") as f:
                    json.dump({"metric": self.best_metric,
                               "step": self.best_step}, f)
            printT(f"best checkpoint saved @ step {step} "
                   f"(metric {self.best_metric:.5f})")
        if force or due:
            if is_master():
                self._write(sd, os.path.join(self._periodic, f"{step}.pt"))
                for old in _steps(self._periodic)[:-self.max_to_keep]:
                    os.remove(os.path.join(self._periodic, f"{old}.pt"))
            printT(f"checkpoint saved @ step {step}")

    def restore(self, state, step: Optional[int] = None, best: bool = False):
        """Load a checkpoint into `state` (in place, onto its devices).
        Returns (state, step); (state, 0) with a warning when there is
        none."""
        d = self._best if best else self._periodic
        if step is None:
            steps = _steps(d)
            if not steps:
                printW(f"no checkpoint found under {self.directory}; "
                       "continuing with current (possibly random) parameters")
                return state, 0
            step = steps[-1]
        dev = next(state.model.parameters()).device
        sd = torch.load(os.path.join(d, f"{step}.pt"), map_location=dev,
                        weights_only=True)
        state.load_state_dict(sd)
        printS(f"restored {'best ' if best else ''}checkpoint @ step {step}")
        return state, int(step)

    def latest_step(self):
        steps = _steps(self._periodic)
        return steps[-1] if steps else None


def average_checkpoints(directory: str, state, steps=None, last: int = 0):
    """SWA-style weight averaging (Izmailov et al., UAI 2018): `state`
    (a TrainState) carrying the uniform average of several periodic
    checkpoints' parameters and BatchNorm statistics (every floating
    tensor of the model's state dict, averaged in float32 and cast back
    to its dtype; an integer buffer such as num_batches_tracked is the
    newest checkpoint's), and of their stored EMA where `state` tracks
    one. The optimizer state is not averaged: the result is an
    evaluation and serving artifact, its step the newest step used.

    steps: an explicit step list; by default the `last` newest periodic
    steps (all kept steps when last <= 0). Returns (state, used_steps).
    """
    d = os.path.join(os.path.abspath(directory), "periodic")
    avail = _steps(d)
    if not avail:
        raise FileNotFoundError(f"no periodic checkpoints in {directory}")
    if steps is None:
        steps = avail[-last:] if last > 0 else avail
    steps = [int(s) for s in steps]
    missing = [s for s in steps if s not in avail]
    if missing:
        raise ValueError(f"steps {missing} not in {avail}")
    has_ema = state.ema is not None
    dev = next(state.model.parameters()).device
    ref = state.model.state_dict()
    acc_m, acc_e, newest = None, None, None
    for s in steps:
        sd = torch.load(os.path.join(d, f"{s}.pt"), map_location=dev,
                        weights_only=True)
        if has_ema and sd.get("ema") is None:
            raise ValueError(
                f"checkpoint step {s} has no EMA but the template state "
                f"tracks one; restrict the steps to the EMA-era checkpoints "
                f"or average the raw parameters with a state without EMA")
        m = {k: v.float() for k, v in sd["model"].items()
             if v.is_floating_point()}
        e = [v.float() for v in sd["ema"]] if has_ema else None
        if acc_m is None:
            acc_m, acc_e = m, e
        else:
            for k, v in m.items():
                acc_m[k] += v
            if has_ema:
                torch._foreach_add_(acc_e, e)
        if s == max(steps):
            newest = sd["model"]
    n = float(len(steps))
    avg = {k: (acc_m[k] / n).to(v.dtype) if k in acc_m else newest[k]
           for k, v in ref.items()}
    state.model.load_state_dict(avg)
    if has_ema:
        with torch.no_grad():
            for dst, a in zip(state.ema, acc_e):
                dst.copy_((a / n).to(dst.dtype))
    state.step = max(steps)
    printS(f"averaged {len(steps)} checkpoints {steps} from {directory}")
    return state, steps


def restore_path(state, path: str):
    """Restore `state` from a checkpoint directory, honouring the
    `<dir>@best` suffix (the durable best slot instead of the latest
    periodic step). Returns (state, step)."""
    best = path.endswith("@best")
    if best:
        path = path[: -len("@best")]
    return CheckpointManager(path).restore(state, best=best)


def restore_for_eval(builder, model, path: str):
    """`model` (made by `builder`) with the weights of the checkpoint
    `path` (a directory, `<dir>@best` for the best slot), ready for
    evaluation: the EMA parameters where the run kept them."""
    from tpupose_torch.engine.train_state import TrainState

    state = TrainState(model, builder.optimizer(model, 1),
                       ema_decay=builder.cfg.train.ema_decay)
    state, _ = restore_path(state, path)
    return state.for_eval()
