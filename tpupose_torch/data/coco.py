"""COCO keypoints top-down dataset (the port's copy of
tpupose/data/coco.py).

Parses a COCO-format annotation JSON directly (no pycocotools), builds
one sample per annotated person instance, and produces the top-down crop
parameters (center, scale with fixed aspect + 1.25 padding). Keypoint
coords are returned both in source pixels and heatmap pixels (post-crop),
the contract of engine/trainer and engine/evaluator.

Source images vary in size, so the crop to the fixed input size runs on
the host: `get_batch` fuses JPEG decode and crop in the port's native
runtime (data/native_io.py) where it builds, else each item is decoded
and cropped with PIL under the same dst->src matrix. The per-sample
augmentation draws are numpy's, per (seed, sample, visit), in the JAX
package's order, so one seed gives the same crops and flips in both
packages. With `augment_geometry=False` (data.device_affine) rotation and
scale jitter run on the card in the train step instead (the warp kernel
K7).
"""

from __future__ import annotations

import json
import os

import numpy as np

from tpupose_torch.utils.logging import printT, printW

COCO_NUM_KEYPOINTS = 17


def fit_aspect(w: float, h: float, aspect: float):
    """Grow (never shrink) a box to the target aspect = W/H — the shared
    MSRA crop-shape rule (also used by mpii.py and the half-body crop)."""
    if w > aspect * h:
        h = w / aspect
    else:
        w = h * aspect
    return w, h


def pil_affine_crop(img: np.ndarray, m: np.ndarray, out_hw) -> np.ndarray:
    """PIL crop under THIS repo's matrix convention: src = m @ (x, y, 1).

    PIL's Image.transform samples at m @ (x+0.5, y+0.5) - 0.5 (verified
    empirically; its docs leave it implicit), i.e. content shifted by
    m[:, :2] @ [0.5, 0.5] - 0.5 against our labels — adjust the
    translation so the fallback path matches the native/device warps."""
    from PIL import Image

    H, W = out_hw
    m = np.asarray(m, np.float64)
    a, b, c = m[0]
    d, e, f = m[1]
    # PIL samples at a(x+.5)+b(y+.5)+c' - .5; solve c' so that equals
    # ax+by+c: c' = c - .5(a+b) + .5 (same for the y row)
    data = (a, b, c - 0.5 * (a + b) + 0.5, d, e, f - 0.5 * (d + e) + 0.5)
    crop = Image.fromarray(img).transform((W, H), Image.AFFINE, data,
                                          resample=Image.BILINEAR)
    return np.asarray(crop, np.uint8)


class CocoTopDownDataset:
    def __init__(self, image_dir: str, ann_file: str, image_size=(256, 192),
                 heatmap_size=(64, 48), is_train: bool = True,
                 scale_factor: float = 0.25, rotation_factor: float = 30.0,
                 flip_prob: float = 0.5, min_keypoints: int = 1,
                 padding: float = 1.25, seed: int = 0,
                 decode_threads: int = 4, flip_pairs=None,
                 augment_geometry: bool = True,
                 half_body_prob: float = 0.0,
                 half_body_min_joints: int = 8,
                 udp: bool = False,
                 decode_cache_mb: int = 0):
        # augment_geometry=False: host applies only the flip — rotation/
        # scale jitter runs on device inside the train step
        # (cfg.data.device_affine, ops/affine.random_affine_augment).
        self.augment_geometry = augment_geometry
        # unbiased (unit-length) data processing: every crop/label affine
        # uses the (N-1)-interval grid (ops/affine udp=True). The evaluator
        # must be built with the same flag (cfg.data.udp wires both).
        self.udp = bool(udp)
        # half-body transform (the standard HRNet/MSRA crop aug the
        # reference lacks entirely): with prob p, re-center the crop on
        # the visible upper- OR lower-body joints only. Only when more
        # than half_body_min_joints joints are visible.
        self.half_body_prob = float(half_body_prob)
        self.half_body_min_joints = int(half_body_min_joints)
        # COCO-17 split: 0-10 = face + arms, 11-16 = hips/knees/ankles
        self.upper_body_ids = tuple(range(11))
        self.image_dir = image_dir
        if flip_pairs is None:
            from tpupose_torch.engine.evaluator import COCO_FLIP_PAIRS

            flip_pairs = COCO_FLIP_PAIRS
        self.flip_pairs = np.asarray(flip_pairs, np.int64)
        self.image_size = tuple(image_size)   # (H, W)
        self.heatmap_size = tuple(heatmap_size)
        self.is_train = is_train
        self.scale_factor = scale_factor
        self.rotation_factor = rotation_factor
        self.flip_prob = flip_prob
        self.padding = padding
        self.decode_threads = decode_threads or max(1, os.cpu_count() or 1)
        # decode-once / warp-per-epoch cache: JPEG decode dominates the
        # host pipeline on few-core hosts, but only the WARP depends on the
        # per-epoch augmentation draw — the DCT-prescaled source pixels
        # don't.
        # Bounded LRU over decoded sources, in MB (0 = off).
        self.decode_cache_mb = int(decode_cache_mb)
        from collections import OrderedDict

        self._cache: "OrderedDict[str, tuple]" = OrderedDict()
        self._cache_bytes = 0
        # augmentation rng is derived per (seed, sample, visit) so draws
        # are identical no matter which loader worker thread lands on the
        # sample first (each index is visited once per epoch)
        self._seed = int(seed)
        self._visits: dict = {}
        import threading

        self._rng_lock = threading.Lock()  # guards the visit counter
        self._cache_lock = threading.Lock()  # guards the decode cache

        with open(ann_file) as f:
            coco = json.load(f)
        images = {im["id"]: im for im in coco["images"]}
        self.samples = []
        for ann in coco.get("annotations", []):
            if ann.get("num_keypoints", 0) < min_keypoints or ann.get("iscrowd", 0):
                continue
            im = images.get(ann["image_id"])
            if im is None:
                continue
            kpts = np.asarray(ann["keypoints"], np.float32).reshape(-1, 3)
            x, y, w, h = ann["bbox"]
            self.samples.append({
                "file_name": im["file_name"],
                "image_id": int(ann["image_id"]),
                "width": im["width"], "height": im["height"],
                "bbox": np.array([x, y, w, h], np.float32),
                "joints": kpts[:, :2].copy(),
                "visibility": kpts[:, 2].copy(),
                "area": float(ann.get("area", w * h)),
            })
        printT(f"COCO top-down: {len(self.samples)} person instances from {ann_file}")

    @classmethod
    def from_config(cls, cfg, split: str = "train"):
        d = cfg.data
        sub = "train2017" if split == "train" else "val2017"
        return cls(
            image_dir=os.path.join(d.root, sub),
            ann_file=os.path.join(d.root, "annotations",
                                  f"person_keypoints_{sub}.json"),
            image_size=tuple(d.image_size),
            heatmap_size=tuple(cfg.model.heatmap_size),
            is_train=(split == "train"),
            scale_factor=d.scale_factor, rotation_factor=d.rotation_factor,
            flip_prob=d.flip_prob, seed=cfg.train.seed,
            augment_geometry=not getattr(d, "device_affine", False),
            half_body_prob=getattr(d, "half_body_prob", 0.0),
            half_body_min_joints=getattr(d, "half_body_min_joints", 8),
            udp=getattr(d, "udp", False),
            decode_threads=getattr(d, "decode_threads", 0),
            decode_cache_mb=getattr(d, "decode_cache_mb", 0),
        )

    def __len__(self):
        return len(self.samples)

    def _box_to_center_scale(self, bbox):
        """xywh box -> (center, scale) with the target aspect ratio and
        1.25 padding (the MSRA convention the BASELINE decode expects)."""
        H, W = self.image_size
        x, y, w, h = bbox
        cx, cy = x + w / 2, y + h / 2
        w, h = fit_aspect(w, h, W / H)
        return (np.array([cx, cy], np.float32),
                np.array([w, h], np.float32) * self.padding)

    def _read_image(self, file_name):
        from PIL import Image

        path = os.path.join(self.image_dir, file_name)
        return np.asarray(Image.open(path).convert("RGB"), np.uint8)

    def _center_scale(self, s):
        """Crop (center, scale) for one sample; COCO derives them from the
        person bbox, subclasses may store them directly (MPII)."""
        return self._box_to_center_scale(s["bbox"])

    def _half_body_center_scale(self, joints_src, vis, rng):
        """Crop params covering only the visible upper- OR lower-body
        joints (HRNet half-body transform). Returns None when the chosen
        half has fewer than 2 visible joints (and the other half too)."""
        visible = vis > 0
        upper = [i for i in self.upper_body_ids
                 if i < len(vis) and visible[i]]
        lower = [i for i in range(len(vis))
                 if i not in self.upper_body_ids and visible[i]]
        pick = upper if rng.random() < 0.5 else lower
        other = lower if pick is upper else upper
        if len(pick) < 2:
            pick = other
        if len(pick) < 2:
            return None
        pts = joints_src[pick]
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        w, h = float(hi[0] - lo[0]), float(hi[1] - lo[1])
        if w < 1 or h < 1:
            return None
        cx, cy = float((lo[0] + hi[0]) / 2), float((lo[1] + hi[1]) / 2)
        H, W = self.image_size
        w, h = fit_aspect(w, h, W / H)
        # 1.5x the usual padding: the half-body box is tight on joints,
        # not on the body contour
        return (np.array([cx, cy], np.float32),
                np.array([w, h], np.float32) * self.padding * 1.5)

    def _sample_params(self, idx: int):
        """Draw augmentation params + labels for one instance (numpy-only:
        the host path must never dispatch device ops)."""
        s = self.samples[idx]
        center, scale = self._center_scale(s)
        joints_src = s["joints"].copy()
        vis = s["visibility"].copy()
        rot = 0.0
        flipped = False
        if self.is_train:
            with self._rng_lock:
                visit = self._visits.get(idx, 0)
                self._visits[idx] = visit + 1
            rng = np.random.default_rng(
                np.random.SeedSequence([self._seed, idx, visit]))
            r_scale = rng.standard_normal()
            r_rotp = rng.random()
            r_rot = rng.standard_normal()
            r_flip = rng.random()
            # half-body only re-centers/re-scales the host crop, so it is
            # compatible with the device-affine pipeline too (where
            # augment_geometry=False moves rotation/scale jitter on device)
            if (self.half_body_prob > 0
                    and int((vis > 0).sum()) > self.half_body_min_joints
                    and rng.random() < self.half_body_prob):
                hb = self._half_body_center_scale(joints_src, vis, rng)
                if hb is not None:
                    center, scale = hb
            if self.augment_geometry:
                scale = scale * np.clip(
                    1.0 + r_scale * self.scale_factor,
                    1 - self.scale_factor, 1 + self.scale_factor)
                if r_rotp < 0.6:
                    rot = float(np.clip(r_rot * self.rotation_factor,
                                        -2 * self.rotation_factor,
                                        2 * self.rotation_factor))
            if r_flip < self.flip_prob:
                flipped = True
                joints_src[:, 0] = s["width"] - 1 - joints_src[:, 0]
                center = center.copy()
                center[0] = s["width"] - 1 - center[0]
                for a, b in self.flip_pairs:
                    joints_src[[a, b]] = joints_src[[b, a]]
                    vis[[a, b]] = vis[[b, a]]
        return s, center, scale, rot, flipped, joints_src, vis

    def _labels(self, s, center, scale, rot, flipped, joints_src, vis):
        """Heatmap-coord joints + the sample dict (minus the image)."""
        from tpupose_torch.ops.affine import get_affine_matrix_np

        Hh, Wh = self.heatmap_size
        m_hm = get_affine_matrix_np(center, scale, rot, (Hh, Wh),
                                    udp=self.udp)
        minv = _invert_2x3(m_hm)
        joints_hm = (minv[:, :2] @ joints_src.T + minv[:, 2:3]).T
        # joints leaving the crop become invisible
        inside = ((joints_hm[:, 0] >= 0) & (joints_hm[:, 0] < Wh)
                  & (joints_hm[:, 1] >= 0) & (joints_hm[:, 1] < Hh))
        vis = np.where(inside, vis, 0.0)
        out = {
            "image_id": np.int64(s["image_id"]),
            "center": center, "scale": scale, "rotation": np.float32(rot),
            "joints": joints_hm.astype(np.float32),   # heatmap coords
            "joints_src": joints_src.astype(np.float32),
            "visibility": vis.astype(np.float32),
            "area": np.float32(s["area"]),
            "flipped": flipped,
        }
        return out

    def _flip_folded_matrix(self, s, center, scale, rot, flipped):
        """dst->src matrix in ORIGINAL-image pixels: the horizontal flip is
        folded into the matrix (x_orig = (W0-1) - x_flipped) so decode+crop
        is one warp — no flipped full-image copy ever exists."""
        from tpupose_torch.ops.affine import get_affine_matrix_np

        m = get_affine_matrix_np(center, scale, rot, self.image_size,
                                 udp=self.udp)
        if flipped:
            m = m.copy()
            m[0, :] = -m[0, :]
            m[0, 2] += s["width"] - 1
        return m

    def _pil_crop(self, s, center, scale, rot, flipped) -> np.ndarray:
        """Per-item host crop (the PIL fallback / non-JPEG path): decode,
        flip, warp with the SAME dst->src matrix the native/device warps
        use (pil_affine_crop corrects PIL's half-pixel convention)."""
        from tpupose_torch.ops.affine import get_affine_matrix_np

        img = self._read_image(s["file_name"])
        if flipped:
            img = img[:, ::-1]
        m = get_affine_matrix_np(center, scale, rot, self.image_size,
                                 udp=self.udp)
        return pil_affine_crop(img, m, self.image_size)

    def __getitem__(self, idx: int) -> dict:
        s, center, scale, rot, flipped, joints_src, vis = self._sample_params(idx)

        # Source images vary in size, so the crop to the fixed (H, W) input
        # happens on the host with the SAME dst->src matrix the device ops
        # use; fixed-size batches then flow uint8 to the device. get_batch
        # fuses decode+warp in C++ (tpupose_torch/native/io.cc) — this per-item
        # path is the PIL fallback and the non-JPEG path.
        out = self._labels(s, center, scale, rot, flipped, joints_src, vis)
        out["image"] = self._pil_crop(s, center, scale, rot, flipped)
        return out

    def _cached_decode_warp(self, params, paths, mats, H, W):
        """Decode-once / warp-per-epoch batch path: misses run the
        threaded DCT-prescaled decode and enter a bounded LRU; every item
        is then warped (threaded) from the cached source with this
        epoch's augmentation matrix. A cached source is reused only if
        its decode resolution covers the current crop's need (a bigger
        zoom-in than ever seen re-decodes and replaces the entry).
        Returns (images, ok) with decode_warp_batch's contract, or None
        when the native library is unavailable."""
        from tpupose_torch.data import native_io

        if native_io.get_lib() is None:
            return None
        n = len(paths)
        # same shrink the fused C path derives: source pixels per crop
        # pixel, per-axis column norms of the dst->src matrix
        sx = np.hypot(mats[:, 0, 0], mats[:, 1, 0])
        sy = np.hypot(mats[:, 0, 1], mats[:, 1, 1])
        shrinks = np.maximum(np.minimum(sx, sy), 1.0)

        sources: list = [None] * n
        miss = []
        with self._cache_lock:
            for i, p in enumerate(paths):
                ent = self._cache.get(p)
                if ent is not None:
                    img, fw, fh, num = ent
                    need = native_io._prescale_dims(fw, fh,
                                                    float(shrinks[i]))[2]
                    if num >= need:
                        self._cache.move_to_end(p)
                        sources[i] = (img, fw, fh)
                        continue
                miss.append(i)
        if miss:
            caps = [(params[i][0]["width"], params[i][0]["height"])
                    for i in miss]
            dec = native_io.decode_prescaled_batch(
                [paths[i] for i in miss], [float(shrinks[i]) for i in miss],
                caps, num_threads=self.decode_threads)
            if dec is None:
                return None
            with self._cache_lock:
                for i, d in zip(miss, dec):
                    if d is None:
                        continue
                    img, fw, fh = d
                    num = native_io._prescale_dims(
                        fw, fh, float(shrinks[i]))[2]
                    old = self._cache.pop(paths[i], None)
                    if old is not None:
                        self._cache_bytes -= old[0].nbytes
                    self._cache[paths[i]] = (img, fw, fh, num)
                    self._cache_bytes += img.nbytes
                    sources[i] = (img, fw, fh)
                budget = self.decode_cache_mb * (1 << 20)
                while self._cache_bytes > budget and len(self._cache) > 1:
                    _, old = self._cache.popitem(last=False)
                    self._cache_bytes -= old[0].nbytes

        ok = np.asarray([s is not None for s in sources])
        live = [i for i in range(n) if ok[i]]
        imgs = np.zeros((n, H, W, 3), np.uint8)
        if live:
            warped = native_io.warp_batch(
                [sources[i] for i in live], mats[live], H, W,
                num_threads=self.decode_threads)
            if warped is None:
                return None
            imgs[live] = warped
        if not ok.all():
            printW(f"native decode (cached): {int((~ok).sum())}/{n} "
                   f"failures (zero-filled, labels invalidated)")
        return imgs, ok

    def get_batch(self, indices) -> list:
        """Batched fast path: fused JPEG decode + affine crop on the native
        C++ thread pool (one warp per sample, DCT-prescaled decode).
        Falls back to the per-item PIL path when the native lib is absent
        or any source is not a JPEG."""
        params = [self._sample_params(int(i)) for i in indices]
        paths = [os.path.join(self.image_dir, p[0]["file_name"])
                 for p in params]
        if all(p.lower().endswith((".jpg", ".jpeg")) for p in paths):
            from tpupose_torch.data.native_io import decode_warp_batch

            mats = np.stack([
                self._flip_folded_matrix(s, c, sc, r, fl)
                for (s, c, sc, r, fl, _, _) in params])
            H, W = self.image_size
            if self.decode_cache_mb > 0:
                res = self._cached_decode_warp(params, paths, mats, H, W)
            else:
                res = decode_warp_batch(paths, mats, H, W,
                                        num_threads=self.decode_threads)
            if res is not None:
                imgs, ok = res
                out = []
                for img, good, (s, c, sc, r, fl, js, v) in zip(
                        imgs, ok, params):
                    if not good:
                        # decode failed (zero-filled image): kill the
                        # labels too, or the model trains joints on black
                        v = np.zeros_like(v)
                    d = self._labels(s, c, sc, r, fl, js, v)
                    d["image"] = img
                    out.append(d)
                return out
        # fallback: per-item (re-deriving params would advance the rng, so
        # rebuild from the already-drawn params)
        out = []
        for (s, c, sc, r, fl, js, v) in params:
            d = self._labels(s, c, sc, r, fl, js, v)
            d["image"] = self._pil_crop(s, c, sc, r, fl)
            out.append(d)
        return out


def _invert_2x3(m):
    A = m[:, :2]
    t = m[:, 2]
    Ai = np.linalg.inv(A)
    return np.concatenate([Ai, (-Ai @ t)[:, None]], axis=1).astype(np.float32)
