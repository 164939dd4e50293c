"""Heatmap training steps on a device batch, as the port's Trainer runs
them with `data.device_affine`: a pool of seeded canonical uint8 crops,
joints (heatmap pixels) and visibilities in pinned host memory, copied
each step with non_blocking copies (the Trainer's prefetch_to_device),
and the step of `make_heatmap_train_step` on a TrainState: the K7 warp of
the step's scale / rotation draw, colour jitter, Gaussian targets, the
forward under the yaml's autocast, JointsMSE, the backward, global-norm
clipping and the yaml's optimizer. Losses reach the host every
`log_interval` steps, as the Trainer logs them.

Parameters (posebench/traffic/<mix>.json "params"): batch, pool_batches,
visible (share of labelled joints), check_steps (steps the reference
follows: set-up runs them through the window's own call, on distinct
pool batches, before the window).

The step takes its random draws from the benchmark (`draws=`, which the
step's signature offers), so both sides augment alike; they follow the
distributions of the program's own `draw_affine_augment` and
`draw_color_jitter` with the yaml's factors.
"""

from __future__ import annotations

import time

import torch

from posebench.seeds import generator, make_weights


class Session:
    # faults a test or the calibration plants under the timed path, each
    # of which the comparison must turn into `correct: false`
    FAULTS = ("unchanged", "half_batch")

    def __init__(self, cell, seed: int, device):
        t0 = time.perf_counter()
        from tpupose_torch.engine.builder import Builder, is_backbone_path
        from tpupose_torch.engine.optimizers import make_optimizer
        from tpupose_torch.engine.train_state import (TrainState,
                                                      make_heatmap_train_step)

        self.timings = {"imports_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        self.cell, self.seed, self.device = cell, seed, device
        p = cell.params
        self.B, self.P = int(p["batch"]), int(p["pool_batches"])
        self.cfg = cfg = cell.port_config()
        w = cell.widths
        self.hw, self.hm = tuple(w["image_size"]), tuple(w["heatmap_size"])
        self.ref = cell.reference_module()
        self.specs = self.ref.param_specs(w)
        weights = make_weights(self.specs, seed, device)
        self.model = cell.model_module().build(cfg, weights, device)
        del weights
        self.timings["model_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # the yaml's optimizer at its lr: constant, as after warmup
        opt = make_optimizer(cfg.optimizer, self.model.named_parameters(),
                             is_head=lambda n: not is_backbone_path(n),
                             grad_clip_norm=cfg.train.grad_clip_norm)
        self.state = TrainState(self.model, opt,
                                ema_decay=cfg.train.ema_decay)
        d = cfg.data
        self.step_fn = make_heatmap_train_step(
            Builder(cfg, device).loss(), color_jitter_strength=d.color_jitter,
            heatmap_size=self.hm, sigma=d.sigma,
            affine_rotation=d.rotation_factor, affine_scale=d.scale_factor,
            udp=d.udp)
        self.timings["step_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        self._make_pool()
        self.timings["pool_s"] = time.perf_counter() - t1
        self.n_check = int(p["check_steps"])
        self.losses, self.grads, self.changes = [], {}, {}
        self.metrics = None

    def _make_pool(self):
        p, cfg, (H, W), (Hh, Wh) = self.cell.params, self.cfg, self.hw, self.hm
        g = generator(self.seed, "batches", self.device)
        B, P, K = self.B, self.P, self.cell.widths["num_keypoints"]
        pin = self.device.type == "cuda"
        imgs = torch.randint(0, 256, (P, B, H, W, 3), generator=g,
                             device=self.device, dtype=torch.uint8)
        lo = torch.tensor([2.0, 2.0], device=self.device)
        span = torch.tensor([Wh - 5.0, Hh - 5.0], device=self.device)
        joints = lo + span * torch.rand(P, B, K, 2, generator=g,
                                        device=self.device)
        vis = (torch.rand(P, B, K, generator=g, device=self.device)
               < float(p["visible"])).float() * 2.0
        self.pool = {k: (v.cpu().pin_memory() if pin else v.cpu())
                     for k, v in (("images", imgs), ("joints", joints),
                                  ("visibility", vis))}
        del imgs
        # the step's draws, one set a pool batch
        d = cfg.data
        n = lambda: torch.randn(P, B, generator=g, device=self.device)
        u = lambda: torch.rand(P, B, generator=g, device=self.device)
        sf, rf = d.scale_factor, d.rotation_factor
        mult = (1.0 + n() * sf).clamp(1.0 - sf, 1.0 + sf)
        rot = (n() * rf).clamp(-2.0 * rf, 2.0 * rf)
        rot = torch.where(u() < 0.6, rot, torch.zeros_like(rot))
        jit = [1.0 + (u() * 2.0 - 1.0) * d.color_jitter for _ in range(3)]
        self.draws = [{"affine": (mult[j], rot[j]),
                       "jitter": tuple(t[j] for t in jit)} for j in range(P)]

    def batch(self, j: int) -> dict:
        return {k: v[j].to(self.device, non_blocking=True)
                for k, v in self.pool.items()}

    def _step(self, j: int):
        return self.step_fn(self.state, self.batch(j), self.draws[j])

    def plant(self, fault: str):
        """unchanged: the step returns the state unchanged (the optimizer's
        update skipped); half_batch: half of the batch left out, the
        loss's mean taken over the rest."""
        if fault not in self.FAULTS:
            raise ValueError(f"no fault {fault!r} in training")
        if fault == "unchanged":
            self.state.optimizer.inner.step = lambda *a, **k: None
            return
        step = self.step_fn

        def half(state, batch, draws):
            h = batch["images"].shape[0] // 2
            return step(state, {k: v[:h] for k, v in batch.items()},
                        {k: tuple(t[:h] for t in v)
                         for k, v in draws.items()})

        self.step_fn = half

    def warm_up(self):
        """The first `check_steps` steps, through the window's own call on
        distinct pool batches; what the reference will follow is read on
        the way: each step's loss, the gradient the optimizer took at the
        first (from its first moment), the parameters' change after the
        last."""
        t0 = time.perf_counter()
        named = list(self.model.named_parameters())
        p0 = [p.detach().clone() for _, p in named]
        for k in range(self.n_check):
            m = self._step(k % self.P)
            self.losses.append(float(m["loss"]))
            if k == 0:
                self.grads = self.first_gradients()
        self.changes = {n: (p.detach() - q).cpu()
                        for (n, p), q in zip(named, p0)}
        del p0
        self.finish()
        self.timings["warm_up_s"] = time.perf_counter() - t0

    def first_gradients(self) -> dict:
        """{name: gradient} as the optimizer took it at the first update,
        from its first moment m1 = (1 - b1) g (Adam, AdamW), kept in host
        memory; a parameter without state took none (left out)."""
        inner = self.state.optimizer.inner
        b1 = float(self.cfg.optimizer.betas[0])
        out = {}
        for n, p in self.model.named_parameters():
            st = inner.state.get(p, {})
            if "exp_avg" in st:
                out[n] = (st["exp_avg"] / (1.0 - b1)).cpu()
        return out

    def call(self, i: int) -> int:
        self.metrics = self._step((self.n_check + i) % self.P)
        if (i + 1) % int(self.cfg.train.log_interval) == 0:
            float(self.metrics["loss"])
        return self.B

    def finish(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def end_to_end(self, items: int, window_s: float, lat: list) -> dict:
        return {"train_img_s": items / window_s}

    def notes(self) -> dict:
        return {"losses": self.losses, **self.timings}

    def release(self):
        del self.state, self.model, self.step_fn, self.metrics
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, quant: bool = False) -> dict:
        """The reference follows the first `check_steps` steps in float32
        (quant: the control, in fp8) and the gaps are taken (see
        posebench/reference/train_check.py)."""
        from posebench.reference.train_check import compare, reference_run

        P = make_weights(self.specs, self.seed, self.device)
        steps = [(self.batch(k % self.P), self.draws[k % self.P])
                 for k in range(self.n_check)]
        ref = reference_run(self.ref, P, self.cell.widths, self.cfg, steps,
                            self.hm)
        if quant:
            ctl = reference_run(self.ref, P, self.cell.widths, self.cfg,
                                steps, self.hm, quant=True)
            return compare(ref, ctl["losses"], ctl["grads"], ctl["changes"])
        return compare(ref, self.losses, self.grads, self.changes)
