"""Growable multi-path network: the per-site candidate registry.

Counterpart of rag_tpu/models/growable.py. A restored checkpoint holds, per
searchable site and head, the list of candidate Units, per task an arch
map site -> candidate index, and ``model_to_train``: per site, the
candidates the latest task may train. ``path(arch)`` assembles one task's
(specs, params, stats), ``trainable_sites(t)`` names the sites task t
trains, and ``write_back`` commits trained tensors. Growth (expand/select)
and op search are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

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
                 heads: Dict[str, List[Unit]], archis: List[Dict[str, int]],
                 model_to_train: Optional[Dict[str, List[int]]] = None):
        self.genotypes = genotypes
        self.units = units
        self.heads = heads
        self.archis = archis
        self.model_to_train = model_to_train

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

    def write_back(self, arch: Dict[str, int], params=None, stats=None):
        """Commit trained params and/or stats of a path to its units."""
        for name, idx in arch.items():
            u = self._unit(name, idx)
            if params is not None:
                u.params = params[name]
            if stats is not None:
                u.stats = stats[name]

    def trainable_sites(self, t: int) -> frozenset:
        """Sites of archis[t] whose unit the task may train: everything for
        t=0, else the units in model_to_train."""
        if t == 0:
            return frozenset(self.archis[0].keys())
        if self.model_to_train is None:
            raise ValueError("no model_to_train: the checkpoint records none")
        return frozenset(name for name, idx in self.archis[t].items()
                         if idx in self.model_to_train.get(name, []))

    def to(self, device) -> "GrowableStereoNet":
        """Move every candidate's tensors to ``device`` (in place)."""
        device = torch.device(device)
        for store in (self.units, self.heads):
            for units in store.values():
                for u in units:
                    u.params = _tree_to(u.params, device)
                    u.stats = _tree_to(u.stats, device)
        return self
