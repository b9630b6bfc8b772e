"""Growable multi-path network: the per-site candidate registry, read side.

Counterpart of rag_tpu/models/growable.py. A restored checkpoint holds, per
searchable site and head, the list of candidate Units, and per task an arch
map site -> candidate index; ``path(arch)`` assembles one task's
(specs, params, stats). Growth (expand/select) and op search arrive with the
training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch


@dataclasses.dataclass
class Unit:
    spec: Any
    params: Any
    stats: Any
    born_task: int


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class GrowableStereoNet:
    """Candidate registry + per-task architecture maps."""

    def __init__(self, genotypes, units: Dict[str, List[Unit]],
                 heads: Dict[str, List[Unit]], archis: List[Dict[str, int]]):
        self.genotypes = genotypes
        self.units = units
        self.heads = heads
        self.archis = archis

    def _unit(self, name: str, idx: int) -> Unit:
        return (self.heads[name] if name in self.heads else self.units[name])[idx]

    def path(self, arch: Dict[str, int]):
        """(specs, params, stats) dicts for one task's path."""
        specs, params, stats = {}, {}, {}
        for name, idx in arch.items():
            u = self._unit(name, idx)
            specs[name] = u.spec
            params[name] = u.params
            stats[name] = u.stats
        return specs, params, stats

    def to(self, device) -> "GrowableStereoNet":
        """Move every candidate's tensors to ``device`` (in place)."""
        device = torch.device(device)
        for store in (self.units, self.heads):
            for units in store.values():
                for u in units:
                    u.params = _tree_to(u.params, device)
                    u.stats = _tree_to(u.stats, device)
        return self
