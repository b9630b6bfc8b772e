"""Growable multi-path network: the per-site candidate registry and its
growth.

Counterpart of rag_tpu/models/growable.py (stereo). Per searchable site
and head the registry holds a list of candidate Units; per task an arch
map site -> candidate index. ``initial`` builds task 0's one candidate per
site and head from a genotype. ``expand(t, genotype)`` appends one fresh
candidate per site and fresh heads and sets each site's reuse-vs-new
categorical ``p`` to the K_MULTIPLIER = 2 reuse prior
[2/(2L+1), ..., 1/(2L+1)]. ``select(t)`` argmaxes each ``p``, deletes a
losing new unit, and records ``archis[t]`` and ``model_to_train``.
``path(arch)`` assembles one task's (specs, params, stats),
``trainable_sites(t)`` names the sites task t trains, and ``write_back``
commits trained tensors.

``GrowableDepthNet`` is the depth variant's registry: the same 18-site
grid built by the depth spec builders (a 2D matching half), plus one
``depth_head`` unit shared by every task, created once and never
expanded. It trains at task 0 only, so that no later task moves an
earlier task's output through it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from rag_tpu_torch.models.depth import (
    DEPTH_HEAD_SPEC,
    build_depth_head_specs,
    build_depth_site_specs,
    init_depth_head,
)
from rag_tpu_torch.models.stereo import (
    HEAD_NAMES,
    SITE_NAMES,
    build_head_specs,
    build_site_specs,
    init_sites,
)

K_MULTIPLIER = 2


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

    variant = "stereo"
    site_builder = staticmethod(build_site_specs)
    head_builder = staticmethod(build_head_specs)

    def __init__(self, genotypes, units: Dict[str, List[Unit]],
                 heads: Dict[str, List[Unit]], archis: List[Dict[str, int]],
                 model_to_train: Optional[Dict[str, List[int]]] = None,
                 p: Optional[List[np.ndarray]] = None):
        """A registry as a checkpoint records it (``initial`` builds a new
        one)."""
        self.genotypes = genotypes
        self.units = units
        self.heads = heads
        self.archis = archis
        self.model_to_train = model_to_train
        self.p = p
        self.new_models: Optional[Dict[str, List[int]]] = None

    @classmethod
    def _fresh(cls, genotype, seed: int, device, weights, gen=None):
        """(site specs, site params, site stats, head specs, head params,
        head stats): from ``weights`` = (site params, site stats, head
        params, head stats) when given, else drawn from ``gen`` (default
        ``torch.Generator().manual_seed(seed)``), sites first."""
        site_specs, head_specs = cls.site_builder(genotype), cls.head_builder()
        if weights is None:
            gen = gen or torch.Generator().manual_seed(seed)
            weights = (*init_sites(gen, site_specs, device),
                       *init_sites(gen, head_specs, device))
        return (site_specs, weights[0], weights[1],
                head_specs, weights[2], weights[3])

    @classmethod
    def initial(cls, genotype, seed: int = 0, device="cuda",
                weights=None) -> "GrowableStereoNet":
        """Task 0's network: one candidate per site and head, every site
        and head at index 0 in archis[0]."""
        ss, sp, sst, hs, hp, hst = cls._fresh(genotype, seed, device, weights)
        units = {s: [Unit(ss[s], sp[s], sst[s], 0)] for s in SITE_NAMES}
        heads = {h: [Unit(hs[h], hp[h], hst[h], 0)] for h in HEAD_NAMES}
        archis = [{**{s: 0 for s in SITE_NAMES}, **{h: 0 for h in HEAD_NAMES}}]
        return cls([genotype], units, heads, archis)

    # -- growth ------------------------------------------------------------

    def length(self, site: str) -> int:
        return len(self.units[site])

    def expand(self, t: int, genotype, seed: int = 0, weights=None):
        """Append one candidate per searchable site and fresh heads, on the
        device of the existing units; build p and new_models."""
        if t != len(self.genotypes):
            raise ValueError(f"task {t} expands after {len(self.genotypes)}")
        device = self.units[SITE_NAMES[0]][0].params["w"].device
        ss, sp, sst, hs, hp, hst = self._fresh(genotype, seed, device, weights)
        self.genotypes.append(genotype)
        self.p = []
        for s in SITE_NAMES:
            n = self.length(s)
            self.units[s].append(Unit(ss[s], sp[s], sst[s], t))
            prob = np.full(n + 1, 1.0 / (K_MULTIPLIER * n + 1), np.float64)
            prob[:n] *= K_MULTIPLIER
            self.p.append(prob)
        for h in HEAD_NAMES:
            self.heads[h].append(Unit(hs[h], hp[h], hst[h], t))
            assert len(self.heads[h]) == t + 1
        self.new_models = {
            **{s: [self.length(s) - 1] for s in SITE_NAMES},
            **{h: [t] for h in HEAD_NAMES},
        }

    def select(self, t: int) -> Dict[str, int]:
        """Argmax the reuse-vs-new probabilities, prune losing new units,
        record archis[t] and model_to_train."""
        if self.p is None:
            raise ValueError("select before expand")
        best: Dict[str, int] = {}
        to_train: Dict[str, List[int]] = {}
        for i, s in enumerate(SITE_NAMES):
            idx = int(np.argmax(self.p[i]))
            c = self.length(s) - 1  # index of the freshly added candidate
            if idx == c:
                best[s] = c
                to_train[s] = [c]
            else:
                best[s] = idx
                to_train[s] = []
                del self.units[s][c]
        for h in HEAD_NAMES:
            best[h] = t
            to_train[h] = [t]
        self.model_to_train = to_train
        self.archis.append(best)
        self.p = None
        self.new_models = None
        return best

    def search_arch(self, selected: List[int], t: int) -> Dict[str, int]:
        """Arch map of an op-search sample: selected[i] indexes site i's
        candidates (0..L-1 reuse, L the new unit); heads pinned to t."""
        arch = {s: int(selected[i]) for i, s in enumerate(SITE_NAMES)}
        for h in HEAD_NAMES:
            arch[h] = t
        return arch

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

    def all_units(self) -> List[Unit]:
        """Every candidate of every site and head."""
        return [u for store in (self.units, self.heads)
                for units in store.values() for u in units]

    def to(self, device) -> "GrowableStereoNet":
        """Move every unit's tensors to ``device`` (in place)."""
        device = torch.device(device)
        for u in self.all_units():
            u.params = _tree_to(u.params, device)
            u.stats = _tree_to(u.stats, device)
        return self

    def num_params(self) -> int:
        def count(tree):
            if isinstance(tree, dict):
                return sum(count(v) for v in tree.values())
            return tree.numel()
        return sum(count(u.params) for store in (self.units, self.heads)
                   for units in store.values() for u in units)

    def size_m(self) -> float:
        """Model size in M params."""
        return self.num_params() / 1e6


class GrowableDepthNet(GrowableStereoNet):
    """The depth variant's registry: depth spec builders and the
    task-shared ``depth_head`` unit."""

    variant = "depth"
    site_builder = staticmethod(build_depth_site_specs)
    head_builder = staticmethod(build_depth_head_specs)

    def __init__(self, *args, depth_head: Optional[Unit] = None, **kw):
        super().__init__(*args, **kw)
        self.depth_head = depth_head

    @classmethod
    def initial(cls, genotype, seed: int = 0, device="cuda",
                weights=None) -> "GrowableDepthNet":
        """Task 0's network and the depth head: from ``weights`` = (site
        params, site stats, head params, head stats, depth-head params,
        depth-head stats) when given, else drawn from one
        ``torch.Generator().manual_seed(seed)``: sites, heads, depth head."""
        if weights is None:
            gen = torch.Generator().manual_seed(seed)
            _, sp, sst, _, hp, hst = cls._fresh(genotype, seed, device, None,
                                                gen)
            weights = (sp, sst, hp, hst, *init_depth_head(gen, device))
        net = super().initial(genotype, seed, device, weights[:4])
        net.depth_head = Unit(DEPTH_HEAD_SPEC, weights[4], weights[5], 0)
        return net

    def path(self, arch: Dict[str, int]):
        specs, params, stats = super().path(arch)
        specs["depth_head"] = self.depth_head.spec
        params["depth_head"] = self.depth_head.params
        stats["depth_head"] = self.depth_head.stats
        return specs, params, stats

    def write_back(self, arch: Dict[str, int], params=None, stats=None):
        drop = lambda tree: (None if tree is None else
                             {k: v for k, v in tree.items()
                              if k != "depth_head"})
        super().write_back({k: v for k, v in arch.items()
                            if k != "depth_head"}, drop(params), drop(stats))
        if params is not None and "depth_head" in params:
            self.depth_head.params = params["depth_head"]
        if stats is not None and "depth_head" in stats:
            self.depth_head.stats = stats["depth_head"]

    def trainable_sites(self, t: int) -> frozenset:
        """The stereo rule, plus the shared depth head at t = 0 only."""
        base = super().trainable_sites(t)
        return base | {"depth_head"} if t == 0 else base

    def all_units(self) -> List[Unit]:
        return super().all_units() + [self.depth_head]
