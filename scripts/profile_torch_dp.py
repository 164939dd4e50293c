"""Where a data-parallel SimpleBaseline-R50 train step's time goes on one
card (world size 1, NCCL over a FileStore): the steady step ms of the
trainer without a process group, then under DistributedDataParallel with
SyncBatchNorm2d (with and without find_unused_parameters), with
SyncBatchNorm2d alone and with DDP alone, and torch.profiler's table of
the DDP + SyncBatchNorm2d step. B = 64 at 256x192 with the device affine,
simple_baseline.yaml's recipe.

With --grads it instead compares the first step's gradients (as they
enter the update) of each variant with those of a plain run, in bf16
autocast and in float32: a second plain run (the floor run-to-run),
SyncBatchNorm2d alone, DDP alone, and DDP + SyncBatchNorm2d (the
Trainer's data-parallel step). For each: |norm ratio - 1|, the whole
difference over the plain norm, the worst leaf's, and the five worst
leaves by name.

    python3 scripts/profile_torch_dp.py [--steps 6] [--grads]
"""

import argparse
import datetime
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tpupose_torch.configs import load_config  # noqa: E402
from tpupose_torch.engine.trainer import Trainer  # noqa: E402
from tpupose_torch.models.backbones.resnet import BatchNorm2d  # noqa: E402
from tpupose_torch.parallel.sync_bn import (  # noqa: E402
    convert_sync_batchnorm)


def step_ms(tr, n):
    """n steps alternating over the loader's first two batches, each
    timed on the host clock after a synchronize (ms)."""
    it = iter(tr._prefetched(tr.train_loader))
    batches = [next(it) for _ in range(2)]
    out = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(tr.state, batches[i % 2])
        torch.cuda.synchronize()
        out.append(round(1e3 * (time.perf_counter() - t0), 1))
    return out


def first_grads(tr):
    """The first step's gradients of `tr` (float32, parameter order, as
    the optimizer receives them) and the parameter names."""
    opt, seen = tr.state.optimizer, []
    step = opt.step

    def record(*a, **k):
        seen.append([torch.zeros(p.shape, device=p.device) if p.grad is None
                     else p.grad.detach().float().clone()
                     for p in tr.model.parameters()])
        return step(*a, **k)

    opt.step = record
    batch = next(iter(tr._prefetched(tr.train_loader)))
    tr.train_step(tr.state, batch)
    opt.step = step
    return seen[0], [n for n, _ in tr.model.named_parameters()]


def grad_gap(got, want, names):
    gn = torch.stack([g.norm() for g in got])
    wn = torch.stack([w.norm() for w in want])
    dn = torch.stack([(g - w).norm() for g, w in zip(got, want)])
    keep = wn >= 1e-3 * wn.max()
    rel = torch.where(keep, dn / wn.clamp_min(1e-30), torch.zeros_like(dn))
    worst = torch.argsort(rel, descending=True)[:5].tolist()
    return {"norm": abs(float(gn.norm() / wn.norm()) - 1.0),
            "whole": float(dn.norm() / wn.norm()),
            "leaf": float(rel.max()),
            "worst": [(names[i], round(float(rel[i]), 4),
                       float(wn[i])) for i in worst]}


def compare_grads(cfg, tmp):
    """The first step's gradients of each variant against a plain run's,
    in bf16 autocast and in float32 (train.mixed_precision)."""
    for mp in ("true", "false"):
        c = cfg.clone()
        c.merge_dotted({"train.mixed_precision": mp})
        want, names = first_grads(Trainer(c, device="cuda"))
        got = {"plain again": first_grads(Trainer(c, device="cuda"))[0]}
        dist.init_process_group("nccl", store=dist.FileStore(
            str(tmp / f"store_{mp}"), 1), rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=120))
        try:
            tr = Trainer(c, device="cuda")
            got["DDP + SyncBatchNorm2d"] = first_grads(tr)[0]
            tr = Trainer(c, device="cuda")
            tr.state.ddp = None
            got["SyncBatchNorm2d, no DDP"] = first_grads(tr)[0]
            tr = Trainer(c, device="cuda")
            for m in tr.model.modules():
                if isinstance(m, BatchNorm2d):
                    m.__class__ = BatchNorm2d
            got["DDP, plain BatchNorm2d"] = first_grads(tr)[0]
        finally:
            dist.destroy_process_group()
        for k, g in got.items():
            print(f"mixed_precision={mp} {k}: "
                  f"{grad_gap(g, want, names)}", flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--grads", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = Path(tempfile.mkdtemp())
    cfg = load_config(str(ROOT / "tpupose_torch/configs/method/"
                          "simple_baseline.yaml"),
                      {"data.device_affine": "true", "train.epochs": "1",
                       "train.output_dir": str(tmp / "run")})
    print(torch.cuda.get_device_name(0), flush=True)
    if args.grads:
        compare_grads(cfg, tmp)
        return
    print("no group", step_ms(Trainer(cfg, device="cuda"), args.steps),
          flush=True)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp / "store"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=120))
    try:
        tr = Trainer(cfg, device="cuda")
        ddp = tr.state.ddp
        print("DDP + SyncBatchNorm2d (find_unused_parameters)",
              step_ms(tr, args.steps), flush=True)
        tr.state.ddp = torch.nn.parallel.DistributedDataParallel(
            tr.model, device_ids=[torch.cuda.current_device()],
            broadcast_buffers=False, find_unused_parameters=False)
        print("DDP + SyncBatchNorm2d", step_ms(tr, args.steps), flush=True)
        tr.state.ddp = None
        print("SyncBatchNorm2d, no DDP", step_ms(tr, args.steps), flush=True)
        for m in tr.model.modules():
            if isinstance(m, BatchNorm2d):
                m.__class__ = BatchNorm2d
        tr.state.ddp = ddp
        print("DDP, plain BatchNorm2d", step_ms(tr, args.steps), flush=True)
        convert_sync_batchnorm(tr.model)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step_ms(tr, 2)
        print(prof.key_averages().table(sort_by="cpu_time_total",
                                        row_limit=20), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
