"""Config-driven training CLI (counterpart of tpupose/cli/train.py):
parse args -> merge YAML -> Trainer.train().

    python -m tpupose_torch.cli.train \
        --cfg tpupose_torch/configs/method/simple_baseline.yaml \
        data.device_affine=true [--device cuda] [key=value ...]
    python -m tpupose_torch.cli.train \
        --cfg tpupose_torch/configs/method/vitpose_s.yaml [train.remat=true]
    python -m tpupose_torch.cli.train \
        --cfg tpupose_torch/configs/method/dinov3_vitpose.yaml \
        [model.freeze_backbone=false] [data.mosaic_prob=0.5]

    python -m tpupose_torch.cli.train \
        --cfg tpupose_torch/configs/method/fskd_small.yaml
    python -m tpupose_torch.cli.train --cfg tpupose_torch/configs/method/fcmae.yaml

    torchrun --nproc_per_node=4 -m tpupose_torch.cli.train \
        --cfg tpupose_torch/configs/method/simple_baseline.yaml \
        data.device_affine=true

model.name fskd trains with the EpisodicTrainer, fcmae with the
MAETrainer (engine/episodic_trainer.py), every other model with Trainer.
`--device` defaults to cuda (raises where CUDA is absent); `--device cpu`
trains on the CPU. `--test` runs the loss-only `validate()`, then the
metric `evaluate()` (heatmap family: PCK, MPJPE and COCO OKS-AP by
default, eval.metrics; DINOv3Pose: val_loss and evaluate_yolo's OKS-AP),
and prints both. Under torchrun (WORLD_SIZE / RANK set) Trainer trains
data-parallel, a device a process (engine/trainer.py, parallel/);
train.batch_size stays the global batch.
"""

from __future__ import annotations

from tpupose_torch.configs import default_config, parse_args, update_config
from tpupose_torch.engine.trainer import Trainer
from tpupose_torch.utils.logging import printE, printS


def main(argv=None):
    args = parse_args(argv)
    cfg = update_config(default_config(), args)
    try:
        if cfg.model.name == "fskd":
            from tpupose_torch.engine.episodic_trainer import EpisodicTrainer

            EpisodicTrainer(cfg, device=args.device).train()
            return 0
        if cfg.model.name == "fcmae":
            from tpupose_torch.engine.episodic_trainer import MAETrainer

            MAETrainer(cfg, device=args.device).train()
            return 0
        trainer = Trainer(cfg, device=args.device)
        if args.test:
            loss = trainer.validate()
            metrics = trainer.evaluate()
            printS(f"validation loss: {loss:.5f} | "
                   + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
            return 0
        trainer.train()
        return 0
    except Exception as e:
        printE(f"training failed: {e}")
        raise


if __name__ == "__main__":
    raise SystemExit(main())
