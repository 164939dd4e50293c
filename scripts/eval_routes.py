"""How far apart the SimpleBaseline-R50 evaluation routes are, on the card.

    python3 scripts/eval_routes.py [--crops 2048] [--fit-steps 0]
        [--lr 1e-3] [--fit-batch 64] [--float32-fit]

Builds the simple_baseline config's model through Trainer (flax init,
float32 masters under bf16 autocast), optionally fits it for
--fit-steps train steps to the first 64 synthetic valid crops (batches
of --fit-batch, color jitter off; --float32-fit trains without autocast),
then evaluates --crops synthetic crops (seed 1, B=64, flip) on three
routes: the kernel route (K1-K3 + the model's autocast tail), the
model's own autocast forward, and a float32 copy (TF32 off). Prints each
route's PCK, MPJPE and mAP on the first 64 crops and on all of them, and
how many visible joints each pair of routes puts more than 1 px apart.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--crops", type=int, default=2048)
    ap.add_argument("--fit-steps", type=int, default=0)
    ap.add_argument("--lr", type=str, default="1e-3")
    ap.add_argument("--fit-batch", type=int, default=64)
    ap.add_argument("--float32-fit", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("eval_routes: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpupose_torch.data.loader import to_device
    from tpupose_torch.data.synthetic import SyntheticTopDownDataset
    from tpupose_torch.engine.evaluator import TopDownEvaluator

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out_dir = str(ROOT / "build" / "eval_routes")
    fit = {"train.output_dir": out_dir, "optimizer.lr": args.lr,
           "optimizer.head_lr": args.lr, "data.color_jitter": "0.0",
           "train.warmup_epochs": "0",
           "train.mixed_precision": str(not args.float32_fit).lower()}
    tr = cs._eval_trainer(fit)
    if args.fit_steps:
        batch = list(tr.valid_loader)[0]
        bs = args.fit_batch
        dbs = [to_device({k: batch[k][i:i + bs] for k in
                          ("images", "joints", "visibility")}, "cuda")
               for i in range(0, 64, bs)]
        t0 = time.perf_counter()
        for i in range(args.fit_steps):
            m = tr.train_step(tr.state, dbs[i % len(dbs)])
            if (i + 1) % max(args.fit_steps // 5, 1) == 0:
                print(f"fit step {i + 1}: loss {float(m['loss']):.6f} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
    model = tr.state.for_eval()
    tr32 = cs._eval_trainer({"train.output_dir": out_dir,
                             "train.mixed_precision": "false"})
    tr32.model.load_state_dict(model.state_dict())
    tr.valid_ds = SyntheticTopDownDataset(args.crops, (256, 192), (64, 48),
                                          17, seed=1)
    tr.valid_loader = tr.builder.dataloader(tr.valid_ds, "valid")
    batches = list(tr._eval_batches())
    routes = {"kernel": TopDownEvaluator(model, (64, 48)),
              "autocast": TopDownEvaluator(model, (64, 48), fast_r50=False),
              "float32": TopDownEvaluator(tr32.model, (64, 48))}
    coords = {}
    for name, ev in routes.items():
        coords[name] = np.concatenate([
            ev.step(b["images"], b["center"], b["scale"])[0].cpu().numpy()
            for b in batches])
        for n in sorted({64, args.crops}):
            m = ev.run(batches[:n // 64], tr._build_eval_metrics())
            print(f"{name} route, {n} crops: pck {m['pck']:.6f} mpjpe "
                  f"{m['mpjpe']:.4f} mAP {m['mAP']:.6f}", flush=True)
    vis = np.concatenate([b["visibility"] for b in batches]) > 0
    for a, b in (("kernel", "float32"), ("autocast", "float32"),
                 ("kernel", "autocast")):
        d = np.linalg.norm(coords[a] - coords[b], axis=-1)[vis]
        print(f"{a} vs {b}: {int((d > 1).sum())} of {d.size} visible "
              f"joints more than 1 px apart", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
