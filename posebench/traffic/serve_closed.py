"""Closed-loop serving of crop batches: one client sends a batch of uint8
crops with their boxes, waits for the keypoints, sends the next.

Parameters (posebench/traffic/<mix>.json "params"): batch (crops a
request), pool_batches (distinct batches, cycled), flip_test, decode,
box_scale [lo, hi] (a crop's source box is that many times the crop's
size), source_span (source centres drawn in [0, span) pixels),
warmup_calls, sample_requests (the requests compared after the window).

The program's entry is HeatmapPredictor.__call__ (uint8 crops on the
host in, source-coordinate keypoints and scores on the host out), built
as the port's `cli.serve` builds it: the configuration's yaml, float32
master weights under its autocast policy.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from posebench.harness import quantile
from posebench.reference import common as R
from posebench.seeds import generator, make_weights, sub_seed


class Session:
    # faults a test or the calibration plants under the timed path, each
    # of which the comparison must turn into `correct: false`
    FAULTS = ("answer_altered", "half_batch")

    def __init__(self, cell, seed: int, device):
        t0 = time.perf_counter()
        from tpupose_torch.engine.predictor import HeatmapPredictor

        self.timings = {"imports_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        self.cell, self.seed, self.device = cell, seed, device
        p = cell.params
        self.B, self.P = int(p["batch"]), int(p["pool_batches"])
        w = cell.widths
        self.hw = tuple(w["image_size"])
        self.hm = tuple(w["heatmap_size"])
        self.ref = cell.reference_module()
        self.specs = self.ref.param_specs(w)
        weights = make_weights(self.specs, seed, device)
        self.model = cell.model_module().build(cell.port_config(), weights,
                                               device)
        del weights
        self.timings["model_s"] = time.perf_counter() - t0
        self.predictor = HeatmapPredictor(
            self.model, self.hm, decode=p["decode"],
            flip_test=bool(p["flip_test"]), device=device)
        t1 = time.perf_counter()
        self._make_pool()
        self.timings["pool_s"] = time.perf_counter() - t1
        self.outputs = {}
        self.forward = None         # a fault may replace the call

    def _make_pool(self):
        """P batches of B seeded uint8 crops in host memory, their centres
        and scales; drawn on the device, one batch at a time."""
        p, H, W = self.cell.params, *self.hw
        g = generator(self.seed, "crops", self.device)
        self.crops = []
        for _ in range(self.P):
            t = torch.randint(0, 256, (self.B, H, W, 3), generator=g,
                              device=self.device, dtype=torch.uint8)
            self.crops.append(t.cpu().numpy())
        lo, hi = p["box_scale"]
        s = lo + (hi - lo) * torch.rand(self.P, self.B, 1, generator=g,
                                        device=self.device)
        scales = s * torch.tensor([float(W), float(H)], device=self.device)
        centers = torch.rand(self.P, self.B, 2, generator=g,
                             device=self.device) * float(p["source_span"])
        self.scales = scales.cpu().numpy().astype(np.float32)
        self.centers = centers.cpu().numpy().astype(np.float32)

    def _serve(self, j: int):
        return self.predictor(self.crops[j], self.centers[j], self.scales[j])

    def plant(self, fault: str):
        """answer_altered: one crop's joint 0 answered with joint 1's
        location, where the answers are produced; half_batch: half of a
        request's crops computed, the other half given their answers."""
        def altered(j):
            coords, scores = self._serve(j)
            coords = coords.copy()
            coords[0, 0] = coords[0, 1]
            return coords, scores

        def half(j):
            h = self.B // 2
            coords, scores = self.predictor(self.crops[j][:h],
                                            self.centers[j][:h],
                                            self.scales[j][:h])
            return (coords.repeat(2, 0)[:self.B],
                    scores.repeat(2, 0)[:self.B])

        if fault not in self.FAULTS:
            raise ValueError(f"no fault {fault!r} in serving")
        self.forward = altered if fault == "answer_altered" else half

    def warm_up(self):
        t0 = time.perf_counter()
        for k in range(int(self.cell.params["warmup_calls"])):
            (self.forward or self._serve)(k % self.P)
        self.finish()
        self.timings["warm_up_s"] = time.perf_counter() - t0

    def call(self, i: int) -> int:
        coords, scores = (self.forward or self._serve)(i % self.P)
        self.outputs[i] = (coords, scores)
        return self.B

    def finish(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def end_to_end(self, items: int, window_s: float, lat: list) -> dict:
        return {"serve_img_s": items / window_s,
                "serve_p95_ms": quantile(lat, 0.95) * 1e3}

    def notes(self) -> dict:
        return {"requests_done": len(self.outputs), **self.timings}

    def release(self):
        """Free the program's state before the reference runs."""
        del self.predictor, self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison -------------------------------------------------------
    def sample(self) -> list:
        """The requests compared: `sample_requests` of those finished in
        the window, drawn from the seed, the last one always among them."""
        done = sorted(i for i in self.outputs
                      if i < getattr(self, "window_calls", len(self.outputs)))
        n = min(int(self.cell.params["sample_requests"]), len(done))
        rng = np.random.default_rng(sub_seed(self.seed, "sample"))
        pick = set(rng.choice(done[:-1], size=n - 1, replace=False).tolist()
                   ) if n > 1 else set()
        return sorted(pick | {done[-1]})

    def check(self, quant: bool = False) -> dict:
        """The numbers compared: the program's answers against the plain
        float32 reference's, on the sampled requests (see
        posebench/reference/serve_check.py). quant: the control, the
        reference in fp8 in the program's place."""
        from posebench.reference.serve_check import compare, reference_heatmaps

        P = make_weights(self.specs, self.seed, self.device)
        acc = None
        for i in self.sample():
            j = i % self.P
            imgs = torch.as_tensor(self.crops[j], device=self.device)
            ctr = torch.as_tensor(self.centers[j], device=self.device)
            scl = torch.as_tensor(self.scales[j], device=self.device)
            ref = reference_heatmaps(self.ref, P, self.cell.widths, imgs,
                                     bool(self.cell.params["flip_test"]))
            if quant:
                hq = reference_heatmaps(self.ref, P, self.cell.widths, imgs,
                                        bool(self.cell.params["flip_test"]),
                                        quant=True)
                c, s = R.dark_decode(hq)
                coords, scores = R.to_source(c, ctr, scl, self.hm), s
            else:
                coords = torch.as_tensor(self.outputs[i][0],
                                         device=self.device)
                scores = torch.as_tensor(self.outputs[i][1],
                                         device=self.device)
            acc = compare(ref, coords, scores, ctr, scl, self.hm, acc)
        return acc.result()
