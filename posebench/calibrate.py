"""Readings for the limits of a cell's comparison, many seeds in one
process (set-up is paid once for the kernels and cuDNN's choices):

    python3 posebench/calibrate.py --workload <cell> --seeds 1,2,3
        [--seconds 2] [--control] [--fault <name>] [--out <file.jsonl>]

For each seed: the cell's set-up, a window of --seconds at the cell's own
load, then the program's numbers against the plain reference; with
--control also the control's (the reference in fp8 in the program's
place); with --fault the program with that fault planted
(the traffic Session's FAULTS). One JSON line a seed. The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from posebench.run import cache_env

    cache_env(ROOT)
    import torch

    from posebench.harness import Cell
    from tpupose_torch.ops import _build

    if not torch.cuda.is_available():
        print("calibrate: CUDA is not available", file=sys.stderr)
        return 2
    _build.build_all()
    cell = Cell(args.workload)
    gen = cell.generator_module()
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        s = gen.Session(cell, seed, dev)
        if args.fault:
            s.plant(args.fault)
        s.warm_up()
        i, tw = 0, time.perf_counter()
        while (time.perf_counter() - tw < args.seconds
               or i < int(cell.params.get("sample_requests", 1))):
            s.call(i)
            i += 1
        s.finish()
        s.release()
        rec = {"workload": args.workload, "seed": seed, "fault": args.fault,
               "iterations": i, "program": s.check()}
        if args.control:
            rec["control"] = s.check(quant=True)
        rec["seconds"] = time.perf_counter() - t0
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del s
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
