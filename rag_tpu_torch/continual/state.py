"""Checkpoint restore for the growable stereo network (read side).

Counterpart of rag_tpu/continual/state.py::load_checkpoint. A checkpoint is
a JSON manifest (genotypes, per-site candidate counts and birth tasks,
per-task arch maps) plus an .npz of every parameter/stat leaf; both packages
read the same files. Arrays go straight to tensors on the requested device.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from rag_tpu_torch.convert import to_torch, unflatten
from rag_tpu_torch.models.growable import GrowableStereoNet, Unit
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
    return GrowableStereoNet(genotypes, units, heads, archis), manifest
