"""ctypes bindings for the port's host-IO runtime (the port's copy of
tpupose/data/native_io.py, for tpupose_torch/native/io.cc).

`get_lib()` builds the library on first use with `make` and `g++` into
`<repo>/build/tpupose_torch/native/` (its file name carries the hash of
io.cc and the Makefile, so an edited source is rebuilt) and loads it, or
returns None where the toolchain or libjpeg's header is missing: callers
then take the PIL path, as the JAX package does. This is host code, not a
kernel: it decodes JPEGs and crops or stretch-resizes them on a
std::thread pool, and parses YOLO-pose label files.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import threading
from pathlib import Path

import numpy as np

from tpupose_torch.utils.logging import printT, printW

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpupose_torch" \
    / "native"
# the entry points this module binds; a library lacking one (or carrying
# another ABI version) is not used
NEEDED = ("tp_decode_jpeg_resize", "tp_decode_jpeg_batch",
          "tp_parse_yolo_label", "tp_decode_warp_batch",
          "tp_decode_prescaled_batch", "tp_warp_batch", "tp_io_version")
IO_VERSION = 4
_lock = threading.Lock()
_lib = None
_tried = False


def _so_path() -> Path:
    h = hashlib.sha256()
    for name in ("io.cc", "Makefile"):
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libtpupose_io_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    try:
        subprocess.run(["make", "-C", str(NATIVE_DIR), f"SO={so}"],
                       check=True, capture_output=True, timeout=120)
        return True
    except Exception as e:  # missing g++/libjpeg -> fall back
        printW(f"native io build failed ({e}); using PIL fallback")
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _so_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            printW(f"native io load failed ({e}); using PIL fallback")
            return None
        if not all(hasattr(lib, n) for n in NEEDED) \
                or lib.tp_io_version() != IO_VERSION:
            printW(f"native io library {so.name} lacks an entry point or "
                   f"has another ABI version; using PIL fallback")
            return None
        lib.tp_decode_jpeg_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.tp_decode_jpeg_resize.restype = ctypes.c_int
        lib.tp_decode_jpeg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.tp_decode_jpeg_batch.restype = ctypes.c_int
        lib.tp_parse_yolo_label.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int]
        lib.tp_parse_yolo_label.restype = ctypes.c_int
        lib.tp_decode_warp_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.tp_decode_warp_batch.restype = ctypes.c_int
        _u8p = ctypes.POINTER(ctypes.c_uint8)
        _i32p = ctypes.POINTER(ctypes.c_int)
        lib.tp_decode_prescaled_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.POINTER(_u8p), ctypes.POINTER(ctypes.c_long),
            _i32p, _i32p, _i32p, _i32p, ctypes.c_int, _u8p]
        lib.tp_decode_prescaled_batch.restype = ctypes.c_int
        lib.tp_warp_batch.argtypes = [
            ctypes.POINTER(_u8p), _i32p, _i32p, _i32p, _i32p,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _u8p, ctypes.c_int]
        lib.tp_warp_batch.restype = ctypes.c_int
        _lib = lib
        printT(f"native io runtime loaded ({so.name})")
        return _lib


def decode_jpeg_batch(paths, out_h: int, out_w: int,
                      num_threads: int = 8) -> np.ndarray:
    """Decode and stretch-resize JPEGs to (N, out_h, out_w, 3) uint8: the
    native threaded path (DCT-prescaled decode, then a bilinear resize;
    a file that fails is zero-filled) where the library loads, else PIL's
    decode and `resize`. The two paths give different pixels, as in the
    JAX package."""
    lib = get_lib()
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    if lib is not None and n:
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        fails = lib.tp_decode_jpeg_batch(
            arr, n, out_h, out_w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads)
        if fails:
            printW(f"native decode: {fails}/{n} failures (zero-filled)")
        return out
    from PIL import Image

    for i, p in enumerate(paths):
        with Image.open(p) as im:
            out[i] = np.asarray(im.convert("RGB").resize((out_w, out_h)),
                                np.uint8)
    return out


def parse_yolo_label(path: str, cols: int, max_rows: int = 256):
    """One YOLO label file -> (rows, cols) float32, or None when a row
    has another column count or trailing text (the check_file rule). A
    missing or empty file gives 0 rows; a file with more than `max_rows`
    rows is read again at its exact size, so no row is dropped. numpy
    parsing where the native library is absent."""
    lib = get_lib()
    if lib is not None:
        fp = ctypes.POINTER(ctypes.c_float)
        buf = np.zeros((max_rows, cols), np.float32)
        r = lib.tp_parse_yolo_label(path.encode(), buf.ctypes.data_as(fp),
                                    max_rows, cols)
        if r == -2:                          # no such file
            return np.zeros((0, cols), np.float32)
        if r < 0:
            return None
        if r > max_rows:
            buf = np.zeros((r, cols), np.float32)
            r = lib.tp_parse_yolo_label(path.encode(),
                                        buf.ctypes.data_as(fp), r, cols)
            if r < 0:
                return None
        return buf[:r].copy()
    try:
        f = open(path)
    except FileNotFoundError:
        return np.zeros((0, cols), np.float32)
    rows = []
    with f:
        for ln in f:
            vals = ln.split()
            if not vals:
                continue
            if len(vals) != cols:
                return None
            rows.append([float(v) for v in vals])
    return np.asarray(rows, np.float32).reshape(-1, cols)


def _prescale_dims(full_w: int, full_h: int, shrink: float):
    """Predict libjpeg's DCT-prescaled output dims for a given shrink —
    mirrors decode_jpeg's scale_num selection (io.cc): the largest num
    with 8/(num-1) > shrink, output dim = ceil(dim*num/8)."""
    num = 8
    while num > 1 and 8.0 / (num - 1) <= max(shrink, 1.0):
        num -= 1
    return (full_w * num + 7) // 8, (full_h * num + 7) // 8, num


def decode_prescaled_batch(paths, shrinks, caps_hw, num_threads: int = 8):
    """Threaded DCT-prescaled decode into fresh per-item buffers (the
    decode-once half of the epoch cache).

    paths: N jpeg paths; shrinks: N source-pixels-per-crop-pixel factors;
    caps_hw: N (full_w, full_h) hints (from the annotation file) used to
    size the buffers via _prescale_dims. Returns a list of N entries
    (img (h, w, 3) uint8 trimmed to the real decoded dims, full_w,
    full_h) with None for failed slots, or None when the native library
    is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    bufs, caps = [], np.empty(n, np.int64)
    for i, (fw, fh) in enumerate(caps_hw):
        pw, ph, _ = _prescale_dims(int(fw), int(fh), float(shrinks[i]))
        # slack for annotation dims being off by a little
        bufs.append(np.empty(((ph + 8) * (pw + 8) * 3,), np.uint8))
        caps[i] = bufs[i].size
    u8p = ctypes.POINTER(ctypes.c_uint8)
    outs = (u8p * n)(*[b.ctypes.data_as(u8p) for b in bufs])
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    sh = np.ascontiguousarray(np.asarray(shrinks, np.float32))
    ws = np.zeros(n, np.int32)
    hs = np.zeros(n, np.int32)
    fws = np.zeros(n, np.int32)
    fhs = np.zeros(n, np.int32)
    ok = np.ones(n, np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.tp_decode_prescaled_batch(
        arr, sh.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, outs,
        caps.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        ws.ctypes.data_as(i32p), hs.ctypes.data_as(i32p),
        fws.ctypes.data_as(i32p), fhs.ctypes.data_as(i32p),
        num_threads, ok.ctypes.data_as(u8p))
    res = []
    for i in range(n):
        if not ok[i]:
            res.append(None)
            continue
        w, h = int(ws[i]), int(hs[i])
        # copy: trims the allocation slack so a cache's byte accounting
        # is honest, and frees the oversized backing buffer
        img = bufs[i][:h * w * 3].reshape(h, w, 3).copy()
        res.append((img, int(fws[i]), int(fhs[i])))
    return res


def warp_batch(sources, matrices, out_h: int, out_w: int,
               num_threads: int = 8):
    """Threaded affine crop from already-decoded (prescaled) sources (the
    warp-per-epoch half of the cache). sources: N (img (h, w, 3) uint8
    C-contiguous, full_w, full_h); matrices: (N, 2, 3) dst->src in
    full-res coords. Returns (N, out_h, out_w, 3) uint8, or None when
    the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(sources)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    srcs = (u8p * n)(*[s[0].ctypes.data_as(u8p) for s in sources])
    ws = np.asarray([s[0].shape[1] for s in sources], np.int32)
    hs = np.asarray([s[0].shape[0] for s in sources], np.int32)
    fws = np.asarray([s[1] for s in sources], np.int32)
    fhs = np.asarray([s[2] for s in sources], np.int32)
    mats = np.ascontiguousarray(
        np.asarray(matrices, np.float32).reshape(n, 6))
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.tp_warp_batch(
        srcs, ws.ctypes.data_as(i32p), hs.ctypes.data_as(i32p),
        fws.ctypes.data_as(i32p), fhs.ctypes.data_as(i32p),
        mats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        out_h, out_w, out.ctypes.data_as(u8p), num_threads)
    return out


def decode_warp_batch(paths, matrices, out_h: int, out_w: int,
                      num_threads: int = 8):
    """Fused JPEG decode + 2x3 affine crop on the C++ thread pool.

    paths: N file paths; matrices: (N, 2, 3) float32 dst->src in FULL-RES
    source pixels. Returns (images (N, out_h, out_w, 3) uint8, ok (N,)
    bool — False for slots whose decode failed and was zero-filled, so
    callers can invalidate the labels too), or None when the native
    library is unavailable (callers fall back to the PIL path).
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    mats = np.ascontiguousarray(np.asarray(matrices, np.float32).reshape(n, 6))
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    ok = np.ones(n, np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    fails = lib.tp_decode_warp_batch(
        arr, mats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        out_h, out_w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        num_threads, ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if fails:
        printW(f"native decode+warp: {fails}/{n} failures "
               f"(zero-filled, labels invalidated)")
    return out, ok.astype(bool)
