"""Host-side metric aggregation (counterpart of
rag_tpu/metrics/meters.py::AverageMeterDict)."""

from __future__ import annotations

from typing import Dict

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
