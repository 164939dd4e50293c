"""Build and load the hand-written Hopper kernels.

Every source in tpupose_torch/csrc/*.cu is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into its own shared library under `<repo>/build/tpupose_torch/`, one nvcc
process per source, all started together. Each library exposes a plain C
interface and is loaded with ctypes (no PyTorch headers, so a build takes
seconds). A library's file name carries the hash of its source, the
common header and the flags, so an edited source is rebuilt.

C entry points take `void*` pointers (tensor.data_ptr()), int sizes and
the CUDA stream (torch.cuda.current_stream().cuda_stream) last; they
launch on that stream, allocate nothing, do not synchronise, and return
`cudaGetLastError()`, which `check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpupose_torch"
SOURCES = ("stem.cu", "bottleneck.cu", "bridge.cu", "dark_decode.cu",
           "int8_bottleneck.cu", "int8_deconv.cu", "warp.cu",
           "flash_attention.cu", "flash_attention_bwd.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}
_bound: dict = {}
build_seconds: float | None = None     # wall time of the last build_all()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and under CUDA_HOME "
                       "or /usr/local/cuda): the CUDA kernels cannot be built")


def _target(src: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / src]:
        h.update(p.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{Path(src).stem}_{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every stale source (in parallel) and load all libraries.
    Returns {source name: ctypes.CDLL}. Raises with nvcc's output if a
    build fails."""
    global build_seconds
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in SOURCES:
            out = _target(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for src, out, tmp, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"nvcc {src} failed ({p.returncode}):\n"
                              + log.decode(errors="replace"))
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for src in SOURCES:
            _libs[src] = ctypes.CDLL(str(_target(src)))
        build_seconds = time.perf_counter() - t0
        return _libs


def library(src: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<src> (builds all on first use)."""
    return build_all()[src]


PTR, INT, I64, FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)


def bind(src: str, name: str, argtypes):
    """The C function `name` of csrc/<src> with the given argtypes (PTR for
    pointers and the stream, INT, I64, FLOAT); returns an int error
    code."""
    key = (src, name)
    if key not in _bound:
        fn = getattr(library(src), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _bound[key] = fn
    return _bound[key]


def check(err: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        lib = library(SOURCES[0])
        lib.tp_error_string.restype = ctypes.c_char_p
        lib.tp_error_string.argtypes = [ctypes.c_int]
        msg = lib.tp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def op_or_body(op, body):
    """What a kernel's wrapper calls: its torch.library op while
    torch.export or torch.compile traces the caller, so the program
    records the kernel as an op; otherwise the op's body itself. The
    body is what the op runs, so an eager call launches the same kernel
    and counts the same launch, without the op's dispatch, which costs
    tens of microseconds of host time a call on an H100 (PERF.md)."""
    tracing = torch.compiler.is_compiling() or torch.compiler.is_exporting()
    return op if tracing else body


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream handle for tensor t's device, as an int.
    Makes t's device the current one first: the C entry points launch,
    and key their launch setup, on the current device."""
    torch.cuda.set_device(t.device)
    return torch.cuda.current_stream(t.device).cuda_stream
