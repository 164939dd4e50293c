"""Model FLOPs of one crop's forward pass, from a configuration's widths
(posebench/configs/<config>.json "widths"), the same whatever implements
the model: convolutions, transposed convolutions (over input pixels),
linears and attention's two products, 2 per multiply-add. Normalisation,
activations, pooling and softmax are not counted. The count of a family
is `flops(widths)` in posebench/counts/<family>.py."""

from __future__ import annotations

import importlib


def forward_flops(w: dict) -> int:
    """One crop's forward FLOPs for widths `w`, by its "family"."""
    return importlib.import_module(f"posebench.counts.{w['family']}").flops(w)
