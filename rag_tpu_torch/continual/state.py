"""Checkpoint restore for the growable stereo network (read side), and the
Scene Router's file (both sides).

Counterpart of rag_tpu/continual/state.py::load_checkpoint, save_router and
load_router. A checkpoint is a JSON manifest (genotypes, per-site
candidate counts and birth tasks, per-task arch maps, the units the latest
task trains) plus an .npz of every parameter/stat leaf; the router is one
``router.npz`` beside it (``num_tasks``, ``input_key``, ``trained_task``
and the ``router_leaf_{i}`` of ``SceneRouter.state_arrays``). Both packages
read each other's files. Arrays go straight to tensors on the requested
device.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from rag_tpu_torch.convert import to_torch, unflatten
from rag_tpu_torch.models.growable import GrowableStereoNet, Unit
from rag_tpu_torch.models.router import SceneRouter
from rag_tpu_torch.models.stereo import (
    HEAD_NAMES,
    SITE_NAMES,
    build_head_specs,
    build_site_specs,
)
from rag_tpu_torch.ops.cell import canonicalize_gene
from rag_tpu_torch.search.genotype import Genotype


def _geno_from(d) -> Genotype:
    return Genotype(normal=canonicalize_gene(d["normal"]),
                    reduce=canonicalize_gene(d["reduce"]))


def save_router(directory: str, router: SceneRouter,
                name: str = "router.npz") -> None:
    """Persist the Scene Router (params + Adam state) beside the task
    checkpoints, with ``trained_task``, the last task it was trained
    after (-1: unknown), so that a resume can tell a stale router."""
    os.makedirs(directory, exist_ok=True)
    np.savez(os.path.join(directory, name),
             num_tasks=router.num_tasks, input_key=router.input_key,
             trained_task=router.trained_task, **router.state_arrays())


def load_router(directory: str, name: str = "router.npz",
                device="cuda") -> Optional[SceneRouter]:
    """The saved SceneRouter on ``device``; None if none was saved. A file
    without ``trained_task`` gives -1."""
    path = os.path.join(directory, name)
    if not os.path.exists(path):
        return None
    with np.load(path) as npz:
        data = dict(npz)
    router = SceneRouter(int(data["num_tasks"]),
                         input_key=str(data.get("input_key", "left")),
                         device=device)
    router.load_arrays(data)
    router.trained_task = int(data.get("trained_task", -1))
    return router


def latest_task(directory: str) -> Optional[int]:
    tasks = [int(n[len("manifest_task"):-len(".json")])
             for n in (os.listdir(directory) if os.path.isdir(directory) else [])
             if n.startswith("manifest_task") and n.endswith(".json")]
    return max(tasks) if tasks else None


def load_checkpoint(directory: str, task: Optional[int] = None,
                    device="cuda"):
    """Rebuild the stereo net saved after ``task`` (default: the latest)
    with its tensors on ``device``. Returns (net, manifest)."""
    if task is None:
        task = latest_task(directory)
        if task is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    with open(os.path.join(directory, f"manifest_task{task}.json")) as f:
        manifest = json.load(f)
    variant = manifest.get("variant", "stereo")
    if variant != "stereo":
        raise ValueError(f"the port serves the stereo variant, not {variant!r}")
    with np.load(os.path.join(directory, f"arrays_task{task}.npz")) as npz:
        data = dict(npz)

    genotypes = [_geno_from(g) for g in manifest["genotypes"]]
    spec_cache = {}

    def site_spec(born, s):
        if born not in spec_cache:
            spec_cache[born] = build_site_specs(genotypes[born])
        return spec_cache[born][s]

    def leaves(prefix):
        return to_torch(unflatten(data, prefix), device)

    units = {
        s: [Unit(site_spec(born, s), leaves(f"units/{s}/{i}/params"),
                 leaves(f"units/{s}/{i}/stats"), born)
            for i, born in enumerate(manifest["born"][s][:manifest["lengths"][s]])]
        for s in SITE_NAMES
    }
    head_specs = build_head_specs()
    heads = {
        h: [Unit(head_specs[h], leaves(f"heads/{h}/{i}/params"),
                 leaves(f"heads/{h}/{i}/stats"), i)
            for i in range(manifest["num_heads"][h])]
        for h in HEAD_NAMES
    }
    archis = [{k: int(v) for k, v in arch.items()} for arch in manifest["archis"]]
    mtt = manifest.get("model_to_train")
    if mtt is not None:
        mtt = {k: [int(i) for i in v] for k, v in mtt.items()}
    return GrowableStereoNet(genotypes, units, heads, archis, mtt), manifest
