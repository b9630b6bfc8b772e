"""Parameter/stat trees of the JAX package -> the port's tensors.

A tree is nested dicts whose leaves are arrays (numpy, or anything
``np.asarray`` takes), keyed as rag_tpu/continual/state.py::_flatten keys
checkpoint leaves. Both packages store conv weights as (*k, Cin, Cout), so
conversion keeps every shape and dtype; any re-layout a kernel needs happens
inside that kernel's wrapper.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def to_torch(tree, device="cuda"):
    """Nested dict of arrays -> nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def unflatten(keys_vals: Dict[str, np.ndarray], prefix: str):
    """Rebuild the nested dict for every key under ``prefix/``."""
    tree: Dict = {}
    plen = len(prefix) + 1
    for key, val in keys_vals.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[plen:].split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree
