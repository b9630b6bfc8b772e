"""Scene-parallel cell search: every scene's MdeNAS search at once.

Counterpart of rag_tpu/search/scene_parallel.py. The cell search of a
task builds a fresh supernet that depends on that scene's data only, so
the scenes' searches are independent. rag_tpu runs them on a 'scene'
mesh axis, one device per scene, under shard_map. Here scene t runs on
visible device t % n (every scene on a rank's own card where the device
names one) on a CUDA stream of its own. Each scene's search is its
sequential ``CellSearch``'s own loop, run as a generator
(``CellSearch.steps``): every round advances each scene by one supernet
step on its stream (kernels A and D launch on the current stream, and
their workspaces come from the stream-aware caching allocator), and each
epoch syncs once, for all scenes' scalars. One card then holds every
scene's search, without rag_tpu's one device per scene. On the CPU the
scenes take their rounds in turn. Scene t's stream is the same for every
search in the process (``scene_stream``): the caching allocator keeps
its blocks per stream, so a search on fresh streams would allocate all
of its memory anew.

Per scene the search is therefore the sequential one: the same init seed
(the scene's seed), the same host streams ``default_rng(seed_t + 1000
t)`` for the ops and the split, the same epochs of single-path training
and held-out scoring, the same pairwise update and the same
best-by-valid-loss restore of p and params. Each scene runs every batch
of its own train split, as its sequential search does (rag_tpu's ``zip``
over the scenes' batches stops at the shortest scene).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rag_tpu_torch.ops.precision import FP32, Precision
from rag_tpu_torch.ops.variants import DEFAULT, KernelVariants
from rag_tpu_torch.search.genotype import Genotype
from rag_tpu_torch.search.mdenas import EPOCH, CellSearch, CellSearchConfig


def scene_devices(num_scenes: int, device="cuda") -> List[torch.device]:
    """Scene t's device: for "cuda" without an index visible device t % n;
    otherwise ``device`` itself (a rank's own card, or the CPU)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return [device] * num_scenes
    n = torch.cuda.device_count()
    return [torch.device("cuda", t % n) for t in range(num_scenes)]


_STREAMS: Dict[Tuple[torch.device, int], torch.cuda.Stream] = {}


def scene_stream(device: torch.device, t: int):
    """Scene t's CUDA stream on device, one for the process (None on the
    CPU)."""
    if device.type != "cuda":
        return None
    if (device, t) not in _STREAMS:
        _STREAMS[device, t] = torch.cuda.Stream(device=device)
    return _STREAMS[device, t]


class SceneParallelCellSearch:
    """Searches one Genotype per scene, all scenes concurrently.

    scene_seeds: scene t's CellSearch seed (default config.seed for all);
    the driver passes cell.seed + t, as its sequential searches take.
    weights: optional per-scene (params, stats) to start from, as
    CellSearch's ``weights``. search_cls: the sequential search each scene
    mirrors (``DepthCellSearch`` for the depth variant)."""

    def __init__(self, config: CellSearchConfig, num_scenes: int,
                 log: Optional[Callable] = print,
                 scene_seeds: Optional[Sequence[int]] = None,
                 device="cuda", variants: KernelVariants = DEFAULT,
                 weights: Optional[Sequence] = None,
                 search_cls=CellSearch, precision: Precision = FP32):
        self.cfg = config
        self.num_scenes = num_scenes
        self.log = log or (lambda *_: None)
        self.scene_seeds = (list(scene_seeds) if scene_seeds is not None
                            else [config.seed] * num_scenes)
        if len(self.scene_seeds) != num_scenes:
            raise ValueError(f"{len(self.scene_seeds)} seeds for "
                             f"{num_scenes} scenes")
        self.devices = scene_devices(num_scenes, device)
        self.searches = [
            search_cls(dataclasses.replace(config, seed=seed), log=self.log,
                       device=dev, variants=variants,
                       weights=None if weights is None else weights[t],
                       precision=precision)
            for t, (seed, dev) in enumerate(zip(self.scene_seeds,
                                                self.devices))]
        self.streams = [scene_stream(dev, t)
                        for t, dev in enumerate(self.devices)]

    @property
    def p(self):
        """Per-scene categorical distributions, {kind: (S, edges, ops)}."""
        return {k: np.stack([cs.p[k] for cs in self.searches])
                for k in ("normal", "reduce")}

    @property
    def params(self):
        return [cs.params for cs in self.searches]

    def genotypes(self) -> List[Genotype]:
        return [cs.genotype() for cs in self.searches]

    def _on(self, t: int):
        s = self.streams[t]
        return torch.cuda.stream(s) if s is not None \
            else contextlib.nullcontext()

    def _sync(self) -> None:
        for s in self.streams:
            if s is not None:
                s.synchronize()

    def search(self, train_datas: Sequence, writer=None) -> List[Genotype]:
        """All scenes' searches; returns the per-scene best-by-valid-loss
        genotypes (scene t's search runs as CellSearch.search(train_datas
        [t], task=t) with seed scene_seeds[t]).

        Each round advances every scene's ``CellSearch.steps`` by one step
        on its stream; a scene at its epoch's end waits there until every
        scene is, and then one sync serves all of their scalars."""
        n = self.num_scenes
        if len(train_datas) != n:
            raise ValueError(f"{len(train_datas)} datasets for {n} scenes")
        cur = [torch.cuda.current_stream(dev) if dev.type == "cuda" else None
               for dev in self.devices]
        for s, c in zip(self.streams, cur):
            if s is not None:
                s.wait_stream(c)
        gens = [cs.steps(d, writer, task=t) for t, (cs, d)
                in enumerate(zip(self.searches, train_datas))]
        live = set(range(n))
        while live:
            waiting = set()
            while live - waiting:
                for t in sorted(live - waiting):
                    with self._on(t):
                        what = next(gens[t], None)
                    if what is None:
                        live.discard(t)
                    elif what == EPOCH:
                        waiting.add(t)
            self._sync()          # the epoch's one wait, for every scene
        for c, s in zip(cur, self.streams):
            if s is not None:
                c.wait_stream(s)
        return self.genotypes()
