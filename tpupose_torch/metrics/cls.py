"""Classification metrics, top-1/top-k accuracy and per-class
precision, recall and F1 (the port's copy of tpupose/metrics/cls.py).
Host numpy.
"""

from __future__ import annotations

import numpy as np


class ClassifyMet:
    def __init__(self, num_classes: int, topk: int = 5):
        self.num_classes = num_classes
        self.topk = topk
        self.reset()

    def reset(self):
        self.confusion = np.zeros((self.num_classes, self.num_classes), np.int64)
        self.topk_correct = 0
        self.total = 0

    def update(self, logits, labels):
        logits = np.asarray(logits)
        labels = np.asarray(labels).astype(np.int64)
        pred = logits.argmax(-1)
        for p, t in zip(pred, labels):
            self.confusion[t, p] += 1
        k = min(self.topk, logits.shape[-1])
        topk = np.argsort(-logits, axis=-1)[:, :k]
        self.topk_correct += int((topk == labels[:, None]).any(-1).sum())
        self.total += len(labels)

    def compute(self) -> dict:
        tp = np.diag(self.confusion).astype(np.float64)
        support = self.confusion.sum(1)
        predicted = self.confusion.sum(0)
        precision = tp / np.maximum(predicted, 1)
        recall = tp / np.maximum(support, 1)
        f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-9)
        acc = tp.sum() / max(self.confusion.sum(), 1)
        return {
            "accuracy": float(acc),
            f"top{self.topk}": self.topk_correct / max(self.total, 1),
            "precision": precision, "recall": recall, "f1": f1,
        }
