"""Exporter: serialize a model for deployment (counterpart of
tpupose/engine/exporter.py).

- `export_npz(model, path)` / `load_npz(path)`: flat weights in a `.npz`.
  The port writes `params/<name>` for each parameter and
  `batch_stats/<name>` for each buffer (BatchNorm's running statistics
  and its batch count), under the port's state_dict names
  (`params/backbone.conv1.weight`). `load_npz` returns the nested
  {"params": ..., "batch_stats": ...} tree of JAX's `load_npz`, split at
  "/", so a `.npz` that JAX's `export_npz` wrote loads into the port
  through `load_npz` and the `from_flax_*` converters of utils/convert.py;
  `npz_state_dict` turns the port's own file back into a state_dict.
- `export_program(module, example_args, path)` / `load_program(path)`:
  the analog of JAX's `export_stablehlo` / `load_stablehlo`. torch.export
  (non-strict, at the ATen level, autocast baked in as casts) traces
  `module` on `example_args` into an ExportedProgram saved as `.pt2`; `load_program` returns its
  runnable module, without the model's code. The hand kernels on such a
  path (K1-K4, K8's forward) are torch.library ops
  (`tpupose_torch::stem_pool`, `layer1`, `bridge`, `dark_decode`,
  `flash_attention`), so the program records them as ops and launches
  them where it runs; `load_program` imports their registrations first.
  A program is traced for the device its example arguments lie on and
  runs there: the R50 kernel route and the K4 decode are chosen in Python
  at tracing.
- `HeatmapProgram`, `YoloProgram`, `BottomUpProgram`: the modules
  cli/export.py traces, wrapping TopDownEvaluator.step (the heatmap and
  SimCC families), YoloPosePredictor._infer and
  BottomUpPredictor.dispatch. The R50 route's folded kernel weights are
  buffers of HeatmapProgram, so the program holds them as state, not as
  untracked constants.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def export_npz(model: torch.nn.Module, path: str) -> str:
    """model -> `.npz` of `params/<name>` (parameters) and
    `batch_stats/<name>` (buffers), the port's state_dict names."""
    flat = {f"params/{k}": v.detach().float().cpu().numpy()
            if v.dtype == torch.bfloat16 else v.detach().cpu().numpy()
            for k, v in model.named_parameters()}
    flat.update({f"batch_stats/{k}": v.detach().cpu().numpy()
                 for k, v in model.named_buffers()})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    return path


def load_npz(path: str) -> dict:
    """A `.npz` of slash-joined keys -> the nested tree JAX's `load_npz`
    returns ({"params": ..., "batch_stats": ...})."""
    tree: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[key]
    return tree


def npz_state_dict(tree: dict) -> dict:
    """`load_npz` of a file the port's `export_npz` wrote -> a state_dict
    (torch tensors) for `model.load_state_dict`."""
    out = {}
    for group in ("params", "batch_stats"):
        out.update({k: torch.from_numpy(np.asarray(v))
                    for k, v in tree.get(group, {}).items()})
    return out


def _register_ops():
    """Import the modules that register the kernels' torch.library ops."""
    from tpupose_torch.ops import (cuda_attention, cuda_bridge,  # noqa: F401
                                   cuda_decode, cuda_layer1, cuda_stem)


# torch.export's ATen-level tracing entry point is private
# (torch.export._trace._export with pre_dispatch=False); the versions it
# has been run with here. `aten_export` checks the signature it relies on
# before each use, so another torch fails at once, by name.
ATEN_EXPORT_TESTED = ("2.11", "2.13")


def aten_export():
    """torch.export._trace._export, after checking that it still takes the
    `strict` and `pre_dispatch` keywords export_program passes; raises
    RuntimeError naming the torch version otherwise."""
    import inspect

    from torch.export import _trace

    fn = getattr(_trace, "_export", None)
    params = inspect.signature(fn).parameters if callable(fn) else {}
    if not {"strict", "pre_dispatch"} <= set(params):
        raise RuntimeError(
            f"torch {torch.__version__}: torch.export._trace._export with "
            f"strict= and pre_dispatch= is gone (export_program traces at "
            f"the ATen level through it; run with torch "
            f"{' or '.join(ATEN_EXPORT_TESTED)}, or port export_program)")
    return fn


def export_program(module: torch.nn.Module, example_args, path: str) -> str:
    """Trace `module` on `example_args` with torch.export (non-strict, ATen
    level) and save the ExportedProgram to `path` (`.pt2`)."""
    export = aten_export()
    _register_ops()
    # An inference program, traced without autograd (so the no_grad
    # regions of the evaluator and predictors change no grad mode) and at
    # the ATen level, below autocast: a model's autocast regions become
    # explicit casts. The public torch.export.export gives the
    # pre-dispatch IR, which keeps each region as a wrap_with_autocast
    # higher-order op; its run_decompositions() fails on a DINOv3 ViT
    # program (its float32 islands nested in the bf16 region) with a
    # dtype mismatch (torch 2.13).
    with torch.no_grad():
        ep = export(module, tuple(example_args), strict=False,
                    pre_dispatch=False)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(ep, path)
    return path


def load_program(path: str) -> torch.nn.Module:
    """The runnable module of a saved program (the kernels' ops
    registered first), its weights frozen: an inference program, run
    without autograd."""
    _register_ops()
    return torch.export.load(path).module().requires_grad_(False)


def program_ops(program) -> list:
    """The `tpupose_torch::` ops a program's graph calls, in order (an
    ExportedProgram or the module of one)."""
    gm = getattr(program, "graph_module", program)
    return [str(n.target) for n in gm.graph.nodes if n.op == "call_function"
            and str(n.target).startswith("tpupose_torch.")]


class HeatmapProgram(torch.nn.Module):
    """TopDownEvaluator.step as a module: (uint8 crops (B, H, W, 3),
    centers (B, 2), scales (B, 2)) -> (source coords (B, K, 2), scores
    (B, K)), with the evaluator's normalize, forward (the R50 kernel
    route where the evaluator took it), flip merge, decode and
    back-projection."""

    def __init__(self, evaluator):
        super().__init__()
        self.model = evaluator.model
        self._ev = evaluator
        # the folded weights, {"stem": dict, "layer1": [dict] * 3,
        # "bridge": dict}, as buffers fast_<part>_<block>_<key>; the
        # bridge's host-side tensor maps stay as they are (the op encodes
        # the maps of the weights it is given)
        self._fast = evaluator.fast_weights
        for part, blocks in self._blocks():
            for i, d in enumerate(blocks):
                for k, t in d.items():
                    if k != "tmaps":
                        self.register_buffer(f"fast_{part}_{i}_{k}", t)

    def _blocks(self):
        for part, v in (self._fast or {}).items():
            yield part, (v if isinstance(v, list) else [v])

    def forward(self, images, centers, scales):
        if self._fast is not None:
            w = {}
            for part, blocks in self._blocks():
                got = [{k: t if k == "tmaps" else
                        getattr(self, f"fast_{part}_{i}_{k}")
                        for k, t in d.items()} for i, d in enumerate(blocks)]
                w[part] = got if isinstance(self._fast[part], list) \
                    else got[0]
            kept, self._ev.fast_weights = self._ev.fast_weights, w
            try:
                return self._ev.step(images, centers, scales)
            finally:
                self._ev.fast_weights = kept
        return self._ev.step(images, centers, scales)


class YoloProgram(torch.nn.Module):
    """YoloPosePredictor._infer as a module: uint8 frames (B, H, W, 3) ->
    (boxes, scores, classes, keypoints, valid), decode and NMS
    included."""

    def __init__(self, predictor):
        super().__init__()
        self.model = predictor.model
        self._pred = predictor

    def forward(self, images):
        return self._pred._infer(images)


class BottomUpProgram(torch.nn.Module):
    """BottomUpPredictor.dispatch as a module: uint8 frames (B, H, W, 3)
    -> (coords (B, P, K, 2), scores (B, P, K), person_scores (B, P),
    person_mask (B, P)), AE grouping included."""

    KEYS = ("coords", "scores", "person_scores", "person_mask")

    def __init__(self, predictor):
        super().__init__()
        self.model = predictor.model
        self._pred = predictor

    def forward(self, images):
        out = self._pred.dispatch(images)
        return tuple(out[k] for k in self.KEYS)
