"""Dynamic-batching pose-estimation server (the port's own copy of
tpupose/engine/server.py: stdlib HTTP + MicroBatcher, wrapping
tpupose_torch's HeatmapPredictor).

  * Micro-batching: concurrent requests are coalesced for up to
    `window_ms` (or until `max_batch`) and run as ONE forward.
  * Bucketed shapes: the batch is padded up to the next power-of-two
    bucket, and every bucket is run once before the socket opens, so the
    kernels are built and warm before the first request.
  * One device pass per batch: normalize -> forward (+flip) -> DARK
    decode -> back-projection run on the card through HeatmapPredictor;
    only (B, K, 3) floats return to the host.

Transport is a dependency-free stdlib ThreadingHTTPServer:
  POST /predict   body = JPEG/PNG (content-type image/*, needs Pillow) or
                  a .npy (H, W, 3) uint8 array; response JSON
                  {"keypoints": [[x, y, score], ...]} in SOURCE pixels.
  GET  /healthz   liveness + model identity.
  GET  /stats     request/batch counters, latency percentiles, and the
                  batch-size histogram (proof the batcher coalesces).

Handler threads block on an Event while the single batcher thread runs
the device work (PyTorch releases the GIL inside its kernels).
"""

from __future__ import annotations

import io
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q / 100.0 * (len(sorted_vals) - 1))))
    return float(sorted_vals[i])


class _Request:
    __slots__ = ("image", "center", "scale", "done", "coords", "scores",
                 "error", "t0")

    def __init__(self, image, center, scale):
        self.image = image
        self.center = center
        self.scale = scale
        self.done = threading.Event()
        self.coords = None
        self.scores = None
        self.error = None
        self.t0 = time.perf_counter()


class MicroBatcher:
    """Coalesce single-crop requests into padded power-of-two batches.

    predict_fn(images (B,H,W,3) u8, centers (B,2), scales (B,2))
      -> (coords (B,K,2), scores (B,K)|(B,K,1)) in source coords.
    """

    def __init__(self, predict_fn, input_hw, max_batch: int = 32,
                 window_ms: float = 4.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.predict_fn = predict_fn
        self.input_hw = tuple(input_hw)
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1e3
        self.buckets = []
        b = 1
        while b < self.max_batch:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(self.max_batch)
        self._q: deque[_Request] = deque()
        self._cv = threading.Condition()
        self._closed = False
        # stats (guarded by _stats_lock)
        self._stats_lock = threading.Lock()
        self.n_requests = 0
        self.n_errors = 0
        self.n_batches = 0
        self.batch_hist = {}
        self._lat_s = deque(maxlen=2048)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="microbatcher")
        self._thread.start()

    # -- client side --------------------------------------------------------
    def submit(self, image, center, scale, timeout: float = 30.0):
        H, W = self.input_hw
        if image.shape != (H, W, 3) or image.dtype != np.uint8:
            raise ValueError(
                f"expected ({H}, {W}, 3) uint8 crop, got "
                f"{image.shape} {image.dtype}")
        r = _Request(image, np.asarray(center, np.float32),
                     np.asarray(scale, np.float32))
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._q.append(r)
            self._cv.notify()
        try:
            if not r.done.wait(timeout):
                raise TimeoutError("prediction timed out")
            if r.error is not None:
                raise r.error
        except BaseException:
            # failed/timed-out requests count toward load but NOT toward
            # the latency percentiles: a timeout contributes ~the whole
            # timeout value and the request may still complete later, so
            # folding it into _lat_s inflates p50/p95 exactly when
            # things go wrong
            with self._stats_lock:
                self.n_requests += 1
                self.n_errors += 1
            raise
        with self._stats_lock:
            self.n_requests += 1
            self._lat_s.append(time.perf_counter() - r.t0)
        return r.coords, r.scores

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    # -- batcher thread -------------------------------------------------------
    def _take_batch(self):
        with self._cv:
            while not self._q and not self._closed:
                self._cv.wait()
            if self._closed and not self._q:
                return None
            batch = [self._q.popleft()]
        deadline = time.perf_counter() + self.window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            with self._cv:
                if not self._q:
                    self._cv.wait(timeout=remaining)
                if self._q:
                    batch.append(self._q.popleft())
                elif self._closed:
                    break
        return batch

    def _bucket(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def _loop(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            n = len(batch)
            b = self._bucket(n)
            H, W = self.input_hw
            images = np.zeros((b, H, W, 3), np.uint8)
            centers = np.zeros((b, 2), np.float32)
            scales = np.ones((b, 2), np.float32)
            for i, r in enumerate(batch):
                images[i] = r.image
                centers[i] = r.center
                scales[i] = r.scale
            try:
                coords, scores = self.predict_fn(images, centers, scales)
                coords = np.asarray(coords)
                scores = np.asarray(scores).reshape(b, coords.shape[1])
                for i, r in enumerate(batch):
                    r.coords, r.scores = coords[i], scores[i]
                    r.done.set()
            except Exception as e:  # deliver, don't kill the loop
                for r in batch:
                    r.error = e
                    r.done.set()
            with self._stats_lock:
                self.n_batches += 1
                self.batch_hist[n] = self.batch_hist.get(n, 0) + 1

    def warmup(self):
        """Run every bucket once before serving (synchronous): builds the
        kernels and warms the allocator."""
        H, W = self.input_hw
        for b in self.buckets:
            self.predict_fn(np.zeros((b, H, W, 3), np.uint8),
                            np.tile([[W / 2, H / 2]], (b, 1)).astype(np.float32),
                            np.tile([[W, H]], (b, 1)).astype(np.float32))

    def stats(self):
        with self._stats_lock:
            lat = sorted(self._lat_s)
            return {
                "requests": self.n_requests,
                "errors": self.n_errors,
                "batches": self.n_batches,
                "batch_hist": dict(sorted(self.batch_hist.items())),
                "latency_ms": {
                    "p50": round(_percentile(lat, 50) * 1e3, 3),
                    "p90": round(_percentile(lat, 90) * 1e3, 3),
                    "p99": round(_percentile(lat, 99) * 1e3, 3),
                },
            }


def _decode_body(body: bytes, content_type: str, input_hw):
    """Request payload -> ((H, W, 3) uint8 model crop, source (w0, h0))."""
    H, W = input_hw
    if content_type.startswith("image/"):
        from PIL import Image

        pil = Image.open(io.BytesIO(body)).convert("RGB")
        w0, h0 = pil.size
        arr = np.asarray(pil.resize((W, H)), np.uint8)
        return arr, (w0, h0)
    # raw array: .npy payload, (H', W', 3) uint8
    arr = np.load(io.BytesIO(body), allow_pickle=False)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"npy payload must be (H, W, 3), got {arr.shape}")
    h0, w0 = arr.shape[:2]
    if (h0, w0) != (H, W):
        from PIL import Image

        arr = np.asarray(
            Image.fromarray(arr.astype(np.uint8)).resize((W, H)), np.uint8)
    return arr.astype(np.uint8), (w0, h0)


class PoseServer:
    """HTTP front end over a MicroBatcher. `predictor` is a
    HeatmapPredictor (or anything with the same __call__ contract)."""

    def __init__(self, predictor, input_hw, host: str = "127.0.0.1",
                 port: int = 0, max_batch: int = 32, window_ms: float = 4.0,
                 model_name: str = "pose"):
        self.input_hw = tuple(input_hw)
        self.model_name = model_name
        self.batcher = MicroBatcher(predictor, self.input_hw,
                                    max_batch=max_batch, window_ms=window_ms)
        self.batcher.warmup()
        server = self

        class Handler(BaseHTTPRequestHandler):
            # quiet: no per-request stderr lines
            def log_message(self, fmt, *args):
                pass

            def _json(self, code, obj):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"ok": True, "model": server.model_name,
                                     "input_hw": list(server.input_hw)})
                elif self.path == "/stats":
                    self._json(200, server.batcher.stats())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/predict":
                    self._json(404, {"error": "not found"})
                    return
                try:
                    # client-fault phase: malformed body/image -> 400
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n)
                    ctype = self.headers.get("Content-Type",
                                             "application/octet-stream")
                    crop, (w0, h0) = _decode_body(body, ctype,
                                                  server.input_hw)
                except Exception as e:
                    self._json(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                try:
                    # server-fault phase: batcher/device errors are OURS,
                    # not the client's -> 500 (TimeoutError, CUDA faults)
                    # back-project to source pixels: the evaluator maps
                    # heatmap coords through center/scale of the source
                    center = (w0 / 2.0, h0 / 2.0)
                    scale = (float(w0), float(h0))
                    coords, scores = server.batcher.submit(crop, center,
                                                           scale)
                    kpts = np.concatenate(
                        [coords, scores[:, None]], axis=-1)
                    self._json(200, {"keypoints":
                                     [[round(float(v), 3) for v in row]
                                      for row in kpts]})
                except Exception as e:
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self):
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                             name="pose-server")
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()
