"""Parameter/stat trees of the JAX package -> the port's tensors.

A tree is nested dicts whose leaves are arrays (numpy, or anything
``np.asarray`` takes), keyed as rag_tpu/continual/state.py::_flatten keys
checkpoint leaves. Both packages store conv weights as (*k, Cin, Cout), so
conversion keeps every shape and dtype; any re-layout a kernel needs happens
inside that kernel's wrapper. A depth head is checked by its leaf names
on the way: the depth net's has 'bias1', the depth supernet's 'b'
(``depth_head_to_torch``, ``supernet_to_torch``).
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


# The depth head's leaves: the depth net's (rag_tpu/models/depth.py::
# init_depth_head) and the depth supernet's (rag_tpu/models/supernet.py::
# init_depth_supernet) name the bias apart.
DEPTH_HEAD_LEAVES = {"net": ("bias1", "w"), "supernet": ("b", "w")}


def depth_head_to_torch(tree, kind: str, device="cuda"):
    """A depth head's params -> tensors on ``device``; ``kind`` "net" or
    "supernet" names the leaves it must have (a head of the other kind
    raises)."""
    if tuple(sorted(tree)) != DEPTH_HEAD_LEAVES[kind]:
        raise ValueError(f"a depth {kind}'s head has leaves "
                         f"{DEPTH_HEAD_LEAVES[kind]}, not {sorted(tree)}")
    return to_torch(tree, device)


def supernet_to_torch(params, stats, device="cuda"):
    """(params, stats) of a stereo or depth supernet -> tensors on
    ``device``; a depth supernet's head is checked by its leaf names."""
    params = dict(params)
    head = params.pop("depth_head", None)
    out = to_torch(params, device)
    if head is not None:
        out["depth_head"] = depth_head_to_torch(head, "supernet", device)
    return out, to_torch(stats, device)
