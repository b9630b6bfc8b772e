"""Checkpoints of the growable network (both sides) and the Scene
Router's file.

Counterpart of rag_tpu/continual/state.py::save_checkpoint,
load_checkpoint, save_router and load_router, for the stereo and depth
registries. A checkpoint after
task t is ``manifest_task{t}.json`` (genotypes, per-site candidate counts
and birth tasks, per-task arch maps, the search probabilities ``p``, the
units the latest task trains, and the caller's ``extra``) plus
``arrays_task{t}.npz``, every parameter/stat leaf under
``units/{site}/{i}/{params|stats}/...`` and ``heads/{head}/{i}/...``,
and for a depth net (manifest ``variant: "depth"``) the shared head's
``depth_head/params/{bias1,w}`` (it has no statistics); the
router is one ``router.npz`` beside it (``num_tasks``, ``input_key``,
``trained_task`` and the ``router_leaf_{i}`` of
``SceneRouter.state_arrays``). Both packages read each other's files:
the same keys, dtypes and shapes. Arrays go straight to tensors on the
requested device. A depth checkpoint rebuilds its units with the depth
spec builders (2D matching stems and cells).

The mid-stage state files of the searches and the fine-tune use two
layouts, each as rag_tpu writes it: ``leaf_{i}`` arrays in
``jax.tree_util.tree_flatten`` order of a tuple of trees (every dict's
keys sorted, depth first; optax's SGD state flattens to its momentum
trace, a tree shaped like the params), written and read by
``leaf_arrays`` / ``from_leaves``; and ``_flatten``'s named keys, read
back by ``_unflatten``. Every array written is a host copy taken at the
write, and every tree read is new tensors.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from rag_tpu_torch.convert import depth_head_to_torch, to_torch
from rag_tpu_torch.convert import unflatten as _unflatten  # _flatten's reader
from rag_tpu_torch.models.depth import DEPTH_HEAD_SPEC
from rag_tpu_torch.models.growable import (
    GrowableDepthNet,
    GrowableStereoNet,
    Unit,
)
from rag_tpu_torch.models.router import SceneRouter
from rag_tpu_torch.models.stereo import HEAD_NAMES, SITE_NAMES
from rag_tpu_torch.ops.cell import canonicalize_gene
from rag_tpu_torch.search.genotype import Genotype
from rag_tpu_torch.train.trainer import _leaves


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]):
    """Leaves of a nested dict as host arrays under 'prefix/key/...'."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}/{k}", out)
    else:
        out[prefix] = tree.detach().cpu().numpy()


def tree_device(tree) -> torch.device:
    """The device of a nested dict's first leaf."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device


def leaf_arrays(trees: Sequence, prefix: str = "leaf_") -> Dict[str, np.ndarray]:
    """{prefix}{i}: host copies of the leaves of ``trees`` in jax's
    tree_flatten order."""
    leaves = [x for t in trees for _, x in _leaves(t)]
    return {f"{prefix}{i}": x.detach().cpu().numpy().copy()
            for i, x in enumerate(leaves)}


def from_leaves(data, templates: Sequence, device,
                prefix: str = "leaf_") -> List:
    """Trees shaped like ``templates``, filled in jax's tree_flatten order
    from ``data[f"{prefix}{i}"]`` as new tensors on ``device``."""
    n = len([k for k in data if k.startswith(prefix)])
    need = sum(len(list(_leaves(t))) for t in templates)
    if n != need:
        raise ValueError(f"{n} {prefix}* arrays for {need} leaves")
    it = iter(range(n))

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(tree[k]) for k in sorted(tree)}
        return torch.from_numpy(np.array(data[f"{prefix}{next(it)}"],
                                          copy=True)).to(device)

    return [fill(t) for t in templates]


def savez_atomic(path: str, **arrays) -> None:
    """np.savez to ``path`` through a temporary file and a rename, so a
    kill mid-write leaves the previous file whole."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _geno_json(g: Genotype):
    return {"normal": [list(p) for p in g.normal],
            "reduce": [list(p) for p in g.reduce]}


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


def save_checkpoint(directory: str, net: GrowableStereoNet, task: int,
                    extra: Optional[Dict] = None,
                    manifest_only: bool = False) -> None:
    """Write the checkpoint after ``task``. ``manifest_only`` rewrites just
    the manifest (stage, matrix and eval progress in ``extra``) where the
    arrays on disk are already current."""
    os.makedirs(directory, exist_ok=True)
    manifest = {
        "task": task,
        "variant": net.variant,
        "genotypes": [_geno_json(g) for g in net.genotypes],
        "archis": net.archis,
        "lengths": {s: len(net.units[s]) for s in SITE_NAMES},
        "num_heads": {h: len(net.heads[h]) for h in HEAD_NAMES},
        "born": {s: [u.born_task for u in net.units[s]] for s in SITE_NAMES},
        "p": [p.tolist() for p in net.p] if net.p is not None else None,
        "model_to_train": net.model_to_train,
        "extra": extra or {},
    }
    path = os.path.join(directory, f"manifest_task{task}.json")
    if manifest_only:
        if not os.path.exists(os.path.join(directory,
                                           f"arrays_task{task}.npz")):
            raise FileNotFoundError(
                "a manifest_only save needs the arrays file on disk")
        with open(path + ".tmp", "w") as f:
            json.dump(manifest, f)
        os.replace(path + ".tmp", path)
        return
    arrays: Dict[str, np.ndarray] = {}
    for kind, store, names in (("units", net.units, SITE_NAMES),
                               ("heads", net.heads, HEAD_NAMES)):
        for name in names:
            for i, u in enumerate(store[name]):
                _flatten(u.params, f"{kind}/{name}/{i}/params", arrays)
                _flatten(u.stats, f"{kind}/{name}/{i}/stats", arrays)
    if net.variant == "depth":
        _flatten(net.depth_head.params, "depth_head/params", arrays)
        _flatten(net.depth_head.stats, "depth_head/stats", arrays)
    with open(path, "w") as f:
        json.dump(manifest, f)
    np.savez(os.path.join(directory, f"arrays_task{task}.npz"), **arrays)


def latest_task(directory: str) -> Optional[int]:
    tasks = [int(n[len("manifest_task"):-len(".json")])
             for n in (os.listdir(directory) if os.path.isdir(directory) else [])
             if n.startswith("manifest_task") and n.endswith(".json")]
    return max(tasks) if tasks else None


def load_checkpoint(directory: str, task: Optional[int] = None,
                    device="cuda"):
    """Rebuild the net saved after ``task`` (default: the latest) with its
    tensors on ``device``: a GrowableStereoNet, or a GrowableDepthNet where
    the manifest's variant is "depth". Returns (net, manifest)."""
    if task is None:
        task = latest_task(directory)
        if task is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    with open(os.path.join(directory, f"manifest_task{task}.json")) as f:
        manifest = json.load(f)
    cls = {"stereo": GrowableStereoNet,
           "depth": GrowableDepthNet}.get(manifest.get("variant", "stereo"))
    if cls is None:
        raise ValueError(f"unknown variant {manifest['variant']!r}")
    with np.load(os.path.join(directory, f"arrays_task{task}.npz")) as npz:
        data = dict(npz)

    genotypes = [_geno_from(g) for g in manifest["genotypes"]]
    spec_cache = {}

    def site_spec(born, s):
        if born not in spec_cache:
            spec_cache[born] = cls.site_builder(genotypes[born])
        return spec_cache[born][s]

    def leaves(prefix):
        return to_torch(_unflatten(data, prefix), device)

    units = {
        s: [Unit(site_spec(born, s), leaves(f"units/{s}/{i}/params"),
                 leaves(f"units/{s}/{i}/stats"), born)
            for i, born in enumerate(manifest["born"][s][:manifest["lengths"][s]])]
        for s in SITE_NAMES
    }
    head_specs = cls.head_builder()
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
    p = manifest.get("p")
    if p is not None:
        p = [np.asarray(q, np.float64) for q in p]
    net = cls(genotypes, units, heads, archis, mtt, p)
    if cls is GrowableDepthNet:
        net.depth_head = Unit(
            DEPTH_HEAD_SPEC,
            depth_head_to_torch(_unflatten(data, "depth_head/params"), "net",
                                device),
            leaves("depth_head/stats"), 0)
    return net, manifest
