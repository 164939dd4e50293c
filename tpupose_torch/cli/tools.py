"""Checkpoint and data tools (counterpart of tpupose/cli/tools.py).

    python -m tpupose_torch.cli.tools average-ckpts --cfg <model yaml> \
        --ckpt <run>/ckpt --out <dir> [--last N | --steps S ...] \
        [--device cuda]

`average-ckpts` (SWA): the uniform average of several periodic
checkpoints of one run (engine/checkpoint.average_checkpoints), saved as
a checkpoint directory of its own that loads wherever a checkpoint does
(`model.checkpoint`, `--ckpt`, `restore_for_eval`). The template state
tracks no EMA, so the raw parameters are averaged, as in JAX. The data
tools (`check-data`, `check-labels`, `resize`, `convert-coco`) are not
ported yet (ROADMAP Queue A item 12b) and raise.
"""

from __future__ import annotations

import argparse

from tpupose_torch.utils.logging import printS

_DATA_TOOLS = ("check-data", "check-labels", "resize", "convert-coco")


def average_ckpts(cfg_path: str, ckpt_dir: str, out_dir: str,
                  last: int = 0, steps=None, device="cuda"):
    """Average the parameters and BatchNorm statistics of periodic
    checkpoints of `ckpt_dir` into a checkpoint under `out_dir`, saved at
    the newest step used."""
    from tpupose_torch.configs import load_config
    from tpupose_torch.engine.builder import Builder
    from tpupose_torch.engine.checkpoint import (CheckpointManager,
                                                 average_checkpoints)
    from tpupose_torch.engine.train_state import TrainState

    cfg = load_config(cfg_path)
    builder = Builder(cfg, device)
    model = builder.model()
    state = TrainState(model, builder.optimizer(model, 1))
    avg, used = average_checkpoints(ckpt_dir, state, steps=steps, last=last)
    CheckpointManager(out_dir).save(int(avg.step), avg, force=True)
    printS(f"averaged checkpoint ({len(used)} steps) saved to {out_dir}")
    return used


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in _DATA_TOOLS:
        sub.add_parser(name, add_help=False)
    e = sub.add_parser("average-ckpts")
    e.add_argument("--cfg", required=True, help="model config YAML")
    e.add_argument("--ckpt", required=True, help="checkpoint dir to average")
    e.add_argument("--out", required=True, help="output checkpoint dir")
    e.add_argument("--last", type=int, default=0,
                   help="average the newest N periodic steps (0 = all)")
    e.add_argument("--steps", type=int, nargs="*", default=None,
                   help="explicit step list (overrides --last)")
    e.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    args, rest = p.parse_known_args(argv)
    if args.cmd in _DATA_TOOLS:
        raise ValueError(f"cli.tools {args.cmd} is not ported to "
                         f"tpupose_torch yet (ROADMAP Queue A item 12b)")
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    average_ckpts(args.cfg, args.ckpt, args.out, args.last, args.steps,
                  device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
