"""Running-statistics meters; the port's copy of tpupose/utils/meters.py
(reference: HPE/utils/__init__.py:30-45 AverageMeter)."""

from __future__ import annotations


class AverageMeter:
    """Tracks current value, running sum, count, and mean."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __repr__(self):
        return f"{self.name}: {self.val:.4f} (avg {self.avg:.4f})"


class MetricDict:
    """A dict of AverageMeters keyed by metric name; the structured per-step
    metrics sink the reference lacked (SURVEY.md §5.5)."""

    def __init__(self):
        self._meters: dict[str, AverageMeter] = {}

    def update(self, metrics: dict, n: int = 1):
        for k, v in metrics.items():
            self._meters.setdefault(k, AverageMeter(k)).update(float(v), n)

    def averages(self) -> dict:
        return {k: m.avg for k, m in self._meters.items()}

    def reset(self):
        for m in self._meters.values():
            m.reset()

    def __getitem__(self, k: str) -> AverageMeter:
        return self._meters[k]

    def format(self) -> str:
        return " ".join(f"{k}={m.avg:.4f}" for k, m in self._meters.items())
