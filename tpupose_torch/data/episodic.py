"""Episodic few-shot data (the port's copy of tpupose/data/episodic.py,
numpy only).

FewShotDataset wraps a base dataset (samples with 'class_id', 'image'
and 'keypoints' (K, 3) normalized) into N-way/K-shot episodes: random,
balanced (least-used classes first) or fixed class sampling; each
episode is (n_way * k_shot) support and (n_way * n_query) query samples.
EpisodicDataLoader stacks episodes along a leading axis, and
WeightedEpisodeSampler picks classes by recorded difficulty and use
frequency. The draws are np.random.RandomState's in the JAX package's
order, so the same seed gives the same episodes, bit for bit.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


class FewShotDataset:
    """Wraps a base dataset whose samples carry 'class_id', 'image',
    'keypoints' (K, 3 normalized) fields into episodes."""

    def __init__(self, base, n_way: int = 5, k_shot: int = 1,
                 n_query: int = 4, episodes_per_epoch: int = 100,
                 class_sampling: str = "random", fixed_classes=None,
                 seed: int = 0):
        self.base = base
        self.n_way = n_way
        self.k_shot = k_shot
        self.n_query = n_query
        self.episodes_per_epoch = episodes_per_epoch
        self.class_sampling = class_sampling
        self.fixed_classes = fixed_classes
        self._rng = np.random.RandomState(seed)

        # class -> sample indices map (reference :95-110)
        self.class_to_samples = defaultdict(list)
        for i in range(len(base)):
            self.class_to_samples[int(base[i]["class_id"])].append(i)
        need = k_shot + n_query
        self.classes = [c for c, s in self.class_to_samples.items()
                        if len(s) >= need]
        if len(self.classes) < n_way:
            raise ValueError(
                f"need {n_way} classes with >= {need} samples, have "
                f"{len(self.classes)}")
        self._class_use_count = defaultdict(int)

    def _sample_classes(self):
        if self.class_sampling == "fixed":
            return list(self.fixed_classes)[: self.n_way]
        if self.class_sampling == "balanced":
            # least-recently-used classes first (reference :157-197)
            order = sorted(self.classes, key=lambda c: self._class_use_count[c])
            chosen = order[: self.n_way]
        else:
            chosen = list(self._rng.choice(self.classes, self.n_way,
                                           replace=False))
        for c in chosen:
            self._class_use_count[c] += 1
        return chosen

    def __len__(self):
        return self.episodes_per_epoch

    def __getitem__(self, idx: int) -> dict:
        classes = self._sample_classes()
        sup_imgs, sup_lbls, sup_kpts, sup_vis = [], [], [], []
        qry_imgs, qry_lbls, qry_kpts, qry_vis = [], [], [], []
        for way, c in enumerate(classes):
            pool = self.class_to_samples[c]
            pick = self._rng.choice(pool, self.k_shot + self.n_query,
                                    replace=False)
            for j, si in enumerate(pick):
                s = self.base[int(si)]
                kp = np.asarray(s["keypoints"], np.float32)
                dst = (sup_imgs, sup_lbls, sup_kpts, sup_vis) \
                    if j < self.k_shot else (qry_imgs, qry_lbls, qry_kpts, qry_vis)
                dst[0].append(np.asarray(s["image"], np.uint8))
                dst[1].append(way)
                dst[2].append(kp[:, :2])
                dst[3].append(kp[:, 2])
        return {
            "support_images": np.stack(sup_imgs),
            "support_labels": np.asarray(sup_lbls, np.int32),
            "support_keypoints": np.stack(sup_kpts),
            "support_visibility": np.stack(sup_vis),
            "query_images": np.stack(qry_imgs),
            "query_labels": np.asarray(qry_lbls, np.int32),
            "query_keypoints": np.stack(qry_kpts),
            "query_visibility": np.stack(qry_vis),
            "episode_classes": np.asarray(classes, np.int32),
        }


class EpisodicDataLoader:
    """Batches episodes (stacks along a leading episode axis,
    reference :311-328)."""

    def __init__(self, dataset: FewShotDataset, batch_size: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        for b in range(len(self)):
            eps = [self.dataset[b * self.batch_size + i]
                   for i in range(self.batch_size)]
            yield {k: np.stack([e[k] for e in eps]) for k in eps[0]}


class WeightedEpisodeSampler:
    """Difficulty/frequency-weighted class sampling (reference
    FewShotBatchSampler :337-451): classes with higher recorded difficulty
    and lower use frequency are picked more often."""

    def __init__(self, dataset: FewShotDataset, difficulty_weight: float = 0.5,
                 frequency_weight: float = 0.5, seed: int = 0):
        self.ds = dataset
        self.difficulty = {c: 1.0 for c in dataset.classes}
        self.dw = difficulty_weight
        self.fw = frequency_weight
        self._rng = np.random.RandomState(seed)

    def record_difficulty(self, class_id: int, loss: float):
        d = self.difficulty.get(class_id, 1.0)
        self.difficulty[class_id] = 0.9 * d + 0.1 * float(loss)

    def sample_classes(self):
        cs = self.ds.classes
        diff = np.asarray([self.difficulty[c] for c in cs])
        freq = np.asarray([self.ds._class_use_count[c] for c in cs], np.float64)
        w = self.dw * (diff / (diff.sum() + 1e-9)) \
            + self.fw * ((1.0 / (1.0 + freq)) / (1.0 / (1.0 + freq)).sum())
        w = w / w.sum()
        chosen = self._rng.choice(cs, self.ds.n_way, replace=False, p=w)
        for c in chosen:
            self.ds._class_use_count[c] += 1
        return list(chosen)
