"""Run one cell of BENCHMARK.json once and print its result line.

    python3 posebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints one JSON object as the last line of
standard output: correct, attempted, failed, metrics (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
device, breakdown (--trace 1), and last `compared`, each number the
correctness check compared beside its limit, which also end standard
error. Exits non-zero, printing no result, where CUDA or the cell's cards
are missing, where a module of the JAX package is loaded once the window
has closed, or where the program is not beside the benchmark.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def cache_env(root: Path):
    """Every compiler cache at a fixed path inside the checkout, so that
    only a checkout's first run builds; nothing loads JAX through a
    library that would."""
    cache = root / "build" / "posebench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv_compute")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    sys.path.insert(0, str(ROOT))
    from posebench.harness import run_cell

    try:
        res = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), t_start=T_START)
    except (RuntimeError, ImportError, FileNotFoundError, KeyError) as e:
        print(f"posebench: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    for k, v in res["compared"].items():
        print(f"compared {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
