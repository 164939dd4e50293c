"""Host batching + device prefetch (the port's copy of
tpupose/data/loader.py).

`BatchLoader` is copied (numpy collation of static-shape samples,
optional worker threads, a dataset's batched `get_batch` where it has
one, e.g. COCO's fused native decode + crop), with `shard` for data
parallelism: each rank loads its contiguous slice of every global
batch. `prefetch_to_device` keeps `depth`
batches in flight: each numpy field is copied into pinned host memory
and sent to the device with a `non_blocking` copy, so host collation and
the host-to-device transfer overlap the train step on the card.
"""

from __future__ import annotations

import collections

import numpy as np


class BatchLoader:
    """Minimal epoch-based batch iterator over a map-style dataset.

    Collation stacks each dict field — all samples are already static-shape
    (padded), so collation is a cheap np.stack, not ragged concat.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, num_workers: int = 0,
                 pad_last: bool = False, shard=(0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)
        self.num_workers = num_workers
        # pad_last: repeat the last sample to fill the tail batch and mark
        # real rows in a `pad_mask` — every batch then has the same static
        # shape (the JAX package compiles its eval program once for it)
        self.pad_last = pad_last
        # shard (rank, world): data parallelism. The epoch's order and its
        # global batches of `batch_size` are every rank's alike (one seed);
        # this rank loads only its contiguous slice of each
        self.shard = tuple(shard)
        if self.shard[1] > 1 and (pad_last or not drop_last):
            raise ValueError("a sharded loader takes whole global batches "
                             "only (drop_last, no pad_last)")

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _collate(self, samples):
        out = {}
        for k in samples[0]:
            out[k] = np.stack([s[k] for s in samples])
        # pluralize image key for the engine contract
        if "image" in out:
            out["images"] = out.pop("image")
        return out

    def _make_batch(self, idx, b):
        sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
        pad = 0
        if self.pad_last and len(sel) < self.batch_size:
            pad = self.batch_size - len(sel)
            sel = np.concatenate([sel, np.repeat(sel[-1:], pad)])
        if self.shard[1] > 1:
            from tpupose_torch.parallel.mesh import local_slice

            sel = sel[local_slice(len(sel), *self.shard)]
        if hasattr(self.dataset, "get_batch"):
            # batched fast path (e.g. the native fused decode+crop)
            samples = self.dataset.get_batch(sel)
        else:
            samples = [self.dataset[int(i)] for i in sel]
        batch = self._collate(samples)
        if self.pad_last:
            mask = np.ones(len(sel), bool)
            if pad:
                mask[-pad:] = False
            batch["pad_mask"] = mask
        return batch

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        nb = len(self)
        if self.num_workers > 0:
            yield from self._threaded_iter(idx, nb)
            return
        for b in range(nb):
            yield self._make_batch(idx, b)

    def _threaded_iter(self, idx, nb):
        """Parallel collation: `num_workers` threads each build whole
        batches (JPEG decode in the native path releases the GIL, so
        workers overlap); batches are re-ordered and yielded in sequence
        so epoch order stays deterministic."""
        from concurrent.futures import ThreadPoolExecutor

        depth = max(2, self.num_workers)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = {}
            submitted = 0
            for b in range(min(depth, nb)):
                pending[b] = pool.submit(self._make_batch, idx, b)
                submitted += 1
            for b in range(nb):
                yield pending.pop(b).result()
                if submitted < nb:
                    pending[submitted] = pool.submit(self._make_batch, idx,
                                                     submitted)
                    submitted += 1


def to_device(batch: dict, device) -> dict:
    """numpy fields of a host batch -> tensors on `device`. On the card
    the copy goes through pinned host memory and is `non_blocking`; on
    the CPU the arrays are shared, not copied."""
    import torch

    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetch_to_device(iterator, device, depth: int = 2):
    """Keep `depth` batches in flight on `device` (double buffering): the
    pinned-memory / prefetch_factor pattern (HPE/train.py:72-79)."""
    buf = collections.deque()
    for batch in iterator:
        buf.append(to_device(batch, device))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
