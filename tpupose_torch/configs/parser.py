"""CLI argument parsing + YAML merge (the port's copy of
tpupose/configs/parser.py; reference: HPE/configs/parser.py:3-28,
pose/configs/parser.py:4-43 `parse_args` / `update_config`).

Same UX: `--cfg experiment.yaml`, `--ckpt`, `--test`, the mesh flags
(`--mesh-data`, `--mesh-model`: cfg.mesh, the (data, model) layout of
the processes torchrun starts), dotted overrides, freeze, print; and
`--device` (default "cuda"; "cpu" runs on the CPU).
"""

from __future__ import annotations

import argparse
import json

from tpupose_torch.configs.default import Config, default_config
from tpupose_torch.utils.logging import printT


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="tpupose_torch")
    p.add_argument("--cfg", type=str, default="", help="YAML experiment config")
    p.add_argument("--ckpt", type=str, default="", help="checkpoint to load")
    p.add_argument("--test", action="store_true", help="eval-only mode")
    p.add_argument("--mesh-data", type=int, default=None,
                   help="data-parallel axis size (-1 = all)")
    p.add_argument("--mesh-model", type=int, default=None,
                   help="model-parallel axis size")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument(
        "opts", nargs="*", default=[],
        help="dotted overrides, e.g. train.batch_size=32 optimizer.lr=1e-4",
    )
    return p.parse_args(argv)


def _load_yaml(path: str) -> dict:
    try:
        import yaml  # type: ignore

        with open(path) as f:
            return yaml.safe_load(f) or {}
    except ImportError:
        # zero-dep fallback: accept JSON-formatted config files too
        with open(path) as f:
            return json.load(f)


def load_config(cfg_path: str = "", overrides: dict | None = None) -> Config:
    cfg = default_config()
    if cfg_path:
        cfg.merge_dict(_load_yaml(cfg_path))
    if overrides:
        cfg.merge_dotted(overrides)
    return cfg


def update_config(cfg: Config, args: argparse.Namespace) -> Config:
    """Defrost → merge YAML → apply CLI → freeze → print
    (reference semantics: pose/configs/parser.py:31-43)."""
    if args.cfg:
        cfg.merge_dict(_load_yaml(args.cfg))
    if args.ckpt:
        cfg.model.checkpoint = args.ckpt
    if getattr(args, "mesh_data", None) is not None:
        cfg.mesh.data = args.mesh_data
    if getattr(args, "mesh_model", None) is not None:
        cfg.mesh.model = args.mesh_model
    dotted = {}
    for item in args.opts:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        k, v = item.split("=", 1)
        dotted[k] = v
    cfg.merge_dotted(dotted)
    cfg.freeze()
    printT(json.dumps(cfg.to_dict(), indent=2, default=str))
    return cfg
