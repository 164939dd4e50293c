"""Config-driven training CLI (counterpart of tpupose/cli/train.py):
parse args -> merge YAML -> Trainer.train().

    python -m tpupose_torch.cli.train \
        --cfg tpupose/configs/method/simple_baseline.yaml \
        data.device_affine=true [--device cuda] [key=value ...]
    python -m tpupose_torch.cli.train \
        --cfg tpupose/configs/method/vitpose_s.yaml [train.remat=true]

`--device` defaults to cuda (raises where CUDA is absent); `--device cpu`
trains on the CPU. `--test` runs the loss-only `validate()` (the metric
`evaluate()` is not ported yet).
"""

from __future__ import annotations

from tpupose_torch.configs import default_config, parse_args, update_config
from tpupose_torch.engine.trainer import Trainer
from tpupose_torch.utils.logging import printE, printS


def main(argv=None):
    args = parse_args(argv)
    cfg = update_config(default_config(), args)
    try:
        trainer = Trainer(cfg, device=args.device)
        if args.test:
            printS(f"validation loss: {trainer.validate():.5f}")
            return 0
        trainer.train()
        return 0
    except Exception as e:
        printE(f"training failed: {e}")
        raise


if __name__ == "__main__":
    raise SystemExit(main())
