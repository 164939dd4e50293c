"""The int8 serving engine of SimpleBaseline-R50 256x192: uint8 crops ->
float32 heatmaps through hand-written kernels only (counterpart of
tpupose/ops/pallas_engine.py `PallasServingEngine`).

The chain:

  center_raw            (torch elementwise: x - 255*mean, to bf16)
  -> stem + max-pool    (csrc/stem.cu, bf16; 1/(255*std) folded in)
  -> quantize           (torch elementwise, a division by s_stem)
  -> 16 bottlenecks     (csrc/int8_bottleneck.cu, one launch each)
  -> 3 deconvs          (csrc/int8_deconv.cu, the final conv fused)

Quantization follows the JAX engine: the folded graph and the float32
calibration forward of ops/int8_engine.py give per-tensor activation
scales (amax / 127, the running max over the calibration batches,
floored at 1e-6); weights are per-output-channel symmetric int8. The
TPU-only knobs of the JAX engine (image groups, `max_weight_bytes`,
`interpret`) have no counterpart: there is one launch per bottleneck and
per deconv.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

from tpupose_torch._device import resolve_device
from tpupose_torch.ops.cuda_head import (DeconvSpec, build_deconv_spec,
                                         deconv_reference, run_deconv)
from tpupose_torch.ops.cuda_stages import (Int8Block, build_stage,
                                           chunk_reference, run_chunk)
from tpupose_torch.ops.cuda_stem import (center_raw, fold_stem_weights,
                                         stem_pool, stem_pool_reference)
from tpupose_torch.ops.int8_engine import _forward_calib, fold_simple_baseline
from tpupose_torch.ops.preprocess import IMAGENET_STD
from tpupose_torch.ops.quant import QMAX

# R50 stage table: (block ids, stride of the first block)
_R50_STAGES = ((range(0, 3), 1), (range(3, 7), 2), (range(7, 13), 2),
               (range(13, 16), 2))
INPUT_HW = (256, 192)


def _check_model(model):
    if getattr(model, "backbone_name", None) != "resnet50":
        raise ValueError("CudaServingEngine serves SimpleBaseline-R50 only")


@dataclass
class CudaServingEngine:
    """Built once from a SimpleBaseline-R50; `forward` (and calling the
    engine) maps uint8 NHWC crops (B, 256, 192, 3) to float32 heatmaps
    (B, 64, 48, K) on the engine's device."""

    stem_w: Dict[str, torch.Tensor]
    s_stem: float
    blocks: List[Int8Block]
    deconvs: List[DeconvSpec]
    num_joints: int
    device: torch.device

    @classmethod
    @torch.no_grad()
    def build(cls, model, calib=(), device="cuda"):
        """model: the port's SimpleBaseline("resnet50", ...) in any dtype
        (folded from its float32 values); calib: one uint8 (B, 256, 192, 3)
        batch or an iterable of them. Calibrates and serves on `device`."""
        dev = resolve_device(device)
        _check_model(model)
        if hasattr(calib, "shape"):
            calib = [calib]
        calib = list(calib)
        if not calib:
            # a silent random-noise calibration would give arbitrary scales
            raise ValueError("need >=1 uint8 calibration batch")
        nodes, weights, stem_pad, in_pad = fold_simple_baseline(model)
        wdev = {k: (w.to(dev), b.to(dev)) for k, (w, b) in weights.items()}
        amax = None
        for batch in calib:
            imgs = torch.as_tensor(batch).to(dev)
            got = torch.stack(_forward_calib(nodes, wdev, stem_pad, in_pad,
                                             imgs)[1]).cpu().tolist()
            amax = got if amax is None else [max(a, g)
                                             for a, g in zip(amax, got)]
        return cls.from_amax(model, amax, device=dev)

    @classmethod
    @torch.no_grad()
    def from_amax(cls, model, amax, device="cuda"):
        """Build from a calibration already taken: `amax`, the max-|x| of
        every quantized tensor in the order `_forward_calib` records them
        (floored at 1e-6 here)."""
        dev = resolve_device(device)
        _check_model(model)
        nodes, weights, _, _ = fold_simple_baseline(model)
        amax = [max(float(a), 1e-6) for a in amax]

        conv_scale: Dict[str, float] = {}
        add_scales: Dict[int, float] = {}
        it = iter(amax)
        block_no = 0
        for nd in nodes:
            if nd.quant and nd.kind in ("conv", "add"):
                a = next(it, None)
                if a is None:
                    raise AssertionError(
                        "calibration amax list exhausted early: "
                        "_forward_calib's recording rule drifted from "
                        "this walk")
                s = a / QMAX
                if nd.kind == "conv":
                    conv_scale[nd.spec.name] = s
                else:
                    add_scales[block_no] = s
                    block_no += 1
        leftover = sum(1 for _ in it)
        if leftover:
            raise AssertionError(
                f"calibration amax list has {leftover} unconsumed entries: "
                "_forward_calib's recording rule drifted from this walk")

        blocks: List[Int8Block] = []
        s = conv_scale["stem"]
        for ids, stride in _R50_STAGES:
            bs, s = build_stage(weights, conv_scale, add_scales, ids, s,
                                stride)
            blocks.extend(b.to(dev) for b in bs)

        deconvs: List[DeconvSpec] = []
        n_dec = sum(1 for k in weights if k.startswith("deconv"))
        for i in range(n_dec):
            k, b = weights[f"deconv{i}"]
            s_out = conv_scale[f"deconv{i}"]
            final = weights["final"] + (s_out,) if i == n_dec - 1 else None
            deconvs.append(build_deconv_spec(k, b, s, s_out, final)
                           .to(dev))
            s = s_out

        stem_w = fold_stem_weights(
            model.backbone, torch.bfloat16,
            input_scale=[1.0 / (255.0 * sd) for sd in IMAGENET_STD])
        stem_w = {k: v.to(dev) for k, v in stem_w.items()}
        return cls(stem_w, conv_scale["stem"], blocks, deconvs,
                   int(weights["final"][0].shape[0]), dev)

    def _run(self, images, stem, chunk, deconv):
        if not (isinstance(images, torch.Tensor)
                and images.device == self.device):
            images = torch.as_tensor(images, device=self.device)
        if images.dim() != 4 or tuple(images.shape[1:]) != (*INPUT_HW, 3):
            raise ValueError(f"CudaServingEngine expects (B, 256, 192, 3) "
                             f"crops, got {tuple(images.shape)}")
        x = center_raw(images).to(torch.bfloat16)
        f = stem(x, self.stem_w)
        # a true division, as the JAX engine quantizes (not a multiply by
        # the reciprocal, which torch uses for a scalar divisor on the card)
        s = torch.full((1,), self.s_stem, dtype=torch.float32,
                       device=f.device)
        y = torch.clamp(torch.round(f.float() / s), 0.0, QMAX) \
            .to(torch.int8)
        for blk in self.blocks:
            y = chunk(y, blk)
        for d in self.deconvs:
            y = deconv(y, d)
        return y.narrow(-1, 0, self.num_joints)

    @torch.no_grad()
    def forward(self, images) -> torch.Tensor:
        """uint8 (B, 256, 192, 3) -> float32 heatmaps (B, 64, 48, K): the
        kernels on the card, their plain versions on the CPU."""
        return self._run(images, stem_pool, run_chunk, run_deconv)

    @torch.no_grad()
    def forward_reference(self, images) -> torch.Tensor:
        """The same chain through every kernel's plain version."""
        return self._run(images, stem_pool_reference, chunk_reference,
                         deconv_reference)

    def __call__(self, images):
        return self.forward(images)
