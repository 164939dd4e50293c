"""Rank-0 colored logging kit (the port's copy of tpupose/utils/logging.py;
reference: HPE/utils/deco.py:5-53, HPE/utils/color.py,
pose/pose/utils/__init__.py:10-74): colored printS/printE/printW/printT/
printM and the append-only `FileLogger` (the JAX module's decorators
are not used by the port and are left out).

"Master" is rank 0 of `torch.distributed` once a process group is
initialised, and every process before that.
"""

from __future__ import annotations

import sys
import time
import traceback


class _C:
    RED = "\033[91m"
    GREEN = "\033[92m"
    YELLOW = "\033[93m"
    BLUE = "\033[94m"
    MAGENTA = "\033[95m"
    CYAN = "\033[96m"
    BOLD = "\033[1m"
    END = "\033[0m"


def is_master() -> bool:
    """True on rank 0 of an initialised torch.distributed group, else
    True (single process)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def _emit(tag: str, color: str, *args, file=None):
    if not is_master():
        return
    msg = " ".join(str(a) for a in args)
    print(f"{color}{_C.BOLD}[{tag}]{_C.END}{color} {msg}{_C.END}", file=file or sys.stdout)


def printS(*args):
    """Success (green)."""
    _emit("SUCCESS", _C.GREEN, *args)


def printE(*args):
    """Error (red) + traceback if inside an exception handler
    (reference: HPE/utils/deco.py printE includes traceback)."""
    _emit("ERROR", _C.RED, *args, file=sys.stderr)
    if is_master() and sys.exc_info()[0] is not None:
        traceback.print_exc()


def printW(*args):
    """Warning (yellow)."""
    _emit("WARNING", _C.YELLOW, *args)


def printT(*args):
    """Trace/info (cyan)."""
    _emit("TRACE", _C.CYAN, *args)


def printM(*args):
    """Milestone/message (magenta)."""
    _emit("MESSAGE", _C.MAGENTA, *args)


class FileLogger:
    """Append-only persistent training log (the log.txt epoch lines of the
    reference, HPE/engine/trainer.py:32-38). Master-only, timestamped,
    flushed per line so tails survive crashes."""

    def __init__(self, path: str):
        self.path = path
        if is_master():
            import os

            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, text: str):
        if not is_master():
            return
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        with open(self.path, "a") as f:
            f.write(f"[{stamp}] {text}\n")
