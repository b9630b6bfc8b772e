"""Host-side metric aggregation and the continual-forgetting matrix
(counterparts of rag_tpu/metrics/meters.py::AverageMeterDict and
ForgettingMatrix)."""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch


class AverageMeterDict:
    def __init__(self):
        self.data: Dict[str, float] = {}
        self.count = 0

    def update(self, scalars: Dict[str, float]):
        self.count += 1
        for k, v in scalars.items():
            self.data[k] = self.data.get(k, 0.0) + float(v)

    def mean(self) -> Dict[str, float]:
        return {k: v / max(self.count, 1) for k, v in self.data.items()}

    def update_batched(self, outs) -> "AverageMeterDict":
        """Feed a list of per-batch dicts of 0-d tensors with one device
        to host copy (the same float32 values update() would see)."""
        if not outs:
            return self
        keys = sorted(outs[0])
        stacked = torch.stack([torch.stack([o[k] for k in keys])
                               for o in outs]).cpu().numpy()
        for row in stacked:
            self.update({k: float(v) for k, v in zip(keys, row)})
        return self


class ForgettingMatrix:
    """matrix[t, u] = metric on task u after training task t (u <= t)."""

    def __init__(self, num_tasks: int, metrics=("D1", "EPE", "loss")):
        self.num_tasks = num_tasks
        self.metric_names = tuple(metrics)
        self.m = {k: np.zeros((num_tasks, num_tasks), np.float64)
                  for k in metrics}

    def record(self, t: int, u: int, scalars: Dict[str, float]):
        for k in self.metric_names:
            if k in scalars:
                self.m[k][t, u] = float(scalars[k])

    def mean_final(self, metric: str, upto: Optional[int] = None) -> float:
        """Mean of the last completed row."""
        t = self.num_tasks - 1 if upto is None else upto
        return float(np.mean(self.m[metric][t, : t + 1]))

    def forgetting(self, metric: str) -> float:
        """Average increase of the metric on old tasks from when they were
        learned to after the final task."""
        t = self.num_tasks - 1
        if t == 0:
            return 0.0
        diffs = [self.m[metric][t, u] - self.m[metric][u, u] for u in range(t)]
        return float(np.mean(diffs))

    def to_json(self) -> str:
        return json.dumps({k: v.tolist() for k, v in self.m.items()}, indent=2)

    def format(self, metric: str, scale: float = 1.0,
               fmt: str = "{:7.3f}") -> str:
        lines: List[str] = []
        for i in range(self.num_tasks):
            lines.append(" ".join(fmt.format(self.m[metric][i, j] * scale)
                                  for j in range(self.num_tasks)))
        return "\n".join(lines)
