"""Import the reference's published rag_depth checkpoints into the port's
registry.

Counterpart of rag_tpu/compat/torch_import.py. The reference ships one set
of weights, ``rag_depth/logs/checkpoint_task{0..3}.ckpt``, saved as
``{'task', 'model': state_dict, 'optimizer'}`` in torch's legacy (non-zip)
serialization, and has no load path of its own. Every tensor of the
state_dict must land, with its shape, on a site of the rebuilt depth
architecture (``models.growable.GrowableDepthNet``); ``unused == []`` is
asserted.

Reading treats the artifact as untrusted. ``load_legacy_torch`` calls
``torch.load(path, map_location="cpu", weights_only=True)``: torch's
restricted unpickler, which builds tensors, containers and primitives and
refuses every other global, stands in for rag_tpu's hand-written
whitelist (rag_tpu reads the stream without torch).

The artifact's structure, and so the mapping (rag_tpu's):

* The state_dict stores tensors only. The per-task genotypes and
  site -> candidate maps (``archis``) are not saved. What each cell
  candidate does record is which of its 6 genotype rows were convs
  (``_ops.{i}`` carries parameters only for a conv); ``gene_from_ops``
  rebuilds a gene with a canonical connectivity (each step reads s0 and
  s1) and those op types, which reproduces every tensor shape. Task 0 is
  fully determined (candidate 0 everywhere); later tasks' maps are not in
  the artifact, so the imported net holds ``archis[0]`` only.
* ConvBR_2d always allocates a BatchNorm, even for bn=False blocks
  (``last_3_2d``, ``last_3_3d``): those dormant tensors are skipped, and
  so is every ``bn.num_batches_tracked``.
* Conv weights are OIHW; the port keeps rag_tpu's HWIO (kh, kw, I, O).
* DispHead.conv1 carries a bias: the depth head's ``bias1`` leaf.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from rag_tpu_torch.models.depth import (
    DEPTH_HEAD_SPEC,
    build_depth_head_specs,
    build_depth_site_specs,
)
from rag_tpu_torch.models.growable import GrowableDepthNet, Unit
from rag_tpu_torch.models.stereo import (
    _CELL2D_PLAN,
    _CELL3D_PLAN,
    HEAD_NAMES,
    SITE_NAMES,
)
from rag_tpu_torch.ops.cell import OP_CONV, OP_SKIP, CellSpec, canonicalize_gene
from rag_tpu_torch.ops.convbr import ConvBRSpec
from rag_tpu_torch.search.genotype import Genotype, default_genotype


def load_legacy_torch(path: str) -> Any:
    """A torch.save file (legacy or zip) read with torch's restricted
    unpickler; every tensor comes back as a numpy array. A stream that
    names any global outside torch's allow-list raises before it runs."""
    obj = torch.load(path, map_location="cpu", weights_only=True)

    def to_numpy(o):
        if isinstance(o, torch.Tensor):
            return o.detach().numpy().copy()
        if isinstance(o, dict):
            return type(o)((k, to_numpy(v)) for k, v in o.items())
        if isinstance(o, (list, tuple)):
            return type(o)(to_numpy(v) for v in o)
        return o

    return to_numpy(obj)


_STEM_MAP = {
    "stem2d0": "stem_2d0", "stem2d1": "stem_2d1", "stem2d2": "stem_2d2",
    "last_3_2d": "last_3_2d", "stem3d0": "stem_3d0", "stem3d1": "stem_3d1",
}
_HEAD_KEYS = ("last_3_3d", "last_6_3d", "last_12_3d")

# canonical connectivity for recovered genes: each step reads (s0, s1),
# edge ids (0, 1), (2, 3), (5, 6) in the reference's global edge numbering
_CANONICAL_EDGES = (0, 1, 2, 3, 5, 6)


def gene_from_ops(present_rows) -> Tuple[Tuple[int, int], ...]:
    """Gene with canonical connectivity and the artifact's per-row op
    types: row i is a conv iff ``_ops.{i}`` carried parameters."""
    present = set(int(i) for i in present_rows)
    return canonicalize_gene(tuple(
        (e, OP_CONV if i in present else OP_SKIP)
        for i, e in enumerate(_CANONICAL_EDGES)))


def _w_hwio(w: np.ndarray) -> np.ndarray:
    """torch conv weight (O, I, kh, kw) -> the port's (kh, kw, I, O)."""
    return np.transpose(w, (2, 3, 1, 0)).copy()


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


def _convbr_from(sd: Dict[str, np.ndarray], prefix: str, spec: ConvBRSpec,
                 used: set, device) -> Tuple[Dict, Dict]:
    """(params, stats) of a ConvBR site from '{prefix}.conv.*' and
    '{prefix}.bn.*'; a bn=False block's dormant BatchNorm is left unused."""
    w = _w_hwio(sd[f"{prefix}.conv.weight"])
    used.add(f"{prefix}.conv.weight")
    expect = (spec.kernel,) * spec.ndim + (spec.cin, spec.cout)
    assert w.shape == expect, (prefix, w.shape, expect)
    params = {"w": _t(w, device)}
    stats = {}
    if spec.bn:
        params["scale"] = _t(sd[f"{prefix}.bn.weight"], device)
        params["bias"] = _t(sd[f"{prefix}.bn.bias"], device)
        stats = {"mean": _t(sd[f"{prefix}.bn.running_mean"], device),
                 "var": _t(sd[f"{prefix}.bn.running_var"], device)}
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            used.add(f"{prefix}.bn.{leaf}")
        assert params["scale"].shape == (spec.cout,), prefix
    return params, stats


def _cell_from(sd, prefix: str, plan, used: set, device):
    """(CellSpec, params, stats) of one cell candidate."""
    cpp, cp, cout, downup = plan
    rows = sorted({int(k[len(prefix) + 6:].split(".")[0])
                   for k in sd if k.startswith(f"{prefix}._ops.")})
    gene = gene_from_ops(rows)
    spec = CellSpec(2, cpp, cp, cout, downup, gene)
    params: Dict[str, Any] = {"ops": {}}
    stats: Dict[str, Any] = {"ops": {}}
    params["pre"], stats["pre"] = _convbr_from(
        sd, f"{prefix}.pre_preprocess", ConvBRSpec(2, cpp, cout, 1), used,
        device)
    params["prep"], stats["prep"] = _convbr_from(
        sd, f"{prefix}.preprocess", ConvBRSpec(2, cp, cout, 1), used, device)
    conv_spec = ConvBRSpec(2, cout, cout, 3)
    # conv rows in ascending row order map to the ascending conv edges of
    # the canonical gene (both follow genotype-row order)
    conv_edges = [edge for edge, op in gene if op == OP_CONV]
    for row, edge in zip(rows, conv_edges):
        params["ops"][str(edge)], stats["ops"][str(edge)] = _convbr_from(
            sd, f"{prefix}._ops.{row}", conv_spec, used, device)
    return spec, params, stats


def import_depth_checkpoint(path: str, device=None):
    """A reference rag_depth checkpoint as a GrowableDepthNet on ``device``
    (default: CUDA). Returns (net, info): net.archis holds task 0 only
    (the artifact records no later task's site -> candidate map); info =
    {'task', 'imported', 'skipped_dormant', 'candidates', 'unused'}, as
    rag_tpu's."""
    device = torch.device("cuda" if device is None else device)
    ckpt = load_legacy_torch(path)
    sd: Dict[str, np.ndarray] = dict(ckpt["model"])
    task = int(ckpt.get("task", 0))
    used: set = set()
    fixed_specs = build_depth_site_specs(default_genotype())
    head_specs = build_depth_head_specs()

    def candidates(group: str) -> int:
        pos = group.count(".") + 1  # the candidate index follows the group
        idxs = {int(k.split(".")[pos]) for k in sd
                if k.startswith(group + ".")}
        return max(idxs) + 1 if idxs else 0

    units: Dict[str, list] = {}
    counts: Dict[str, int] = {}
    # stems and last_3_2d (plain ConvBR candidate lists)
    for tkey, site in _STEM_MAP.items():
        n = candidates(tkey)
        assert n >= 1, f"missing site group {tkey}"
        counts[site] = n
        spec = fixed_specs[site]
        units[site] = [Unit(spec, *_convbr_from(sd, f"{tkey}.{i}", spec, used,
                                                device), 0)
                       for i in range(n)]
    # cells (genes recovered per candidate)
    for kind, plans in (("2d", _CELL2D_PLAN), ("3d", _CELL3D_PLAN)):
        for c, plan in enumerate(plans):
            group, site = f"cells_{kind}.{c}", f"cell_{kind}{c}"
            n = candidates(group)
            counts[site] = n
            units[site] = [Unit(*_cell_from(sd, f"{group}.{i}", plan, used,
                                            device), 0) for i in range(n)]
    # per-task output heads
    heads: Dict[str, list] = {}
    for h in _HEAD_KEYS:
        n = candidates(h)
        assert n == task + 1, (h, n, task)
        spec = head_specs[h]
        heads[h] = [Unit(spec, *_convbr_from(sd, f"{h}.{i}", spec, used,
                                             device), 0) for i in range(n)]
    # the shared DispHead (a conv with a bias)
    depth_head = Unit(DEPTH_HEAD_SPEC, {
        "w": _t(_w_hwio(sd["depth_head.conv1.weight"]), device),
        "bias1": _t(sd["depth_head.conv1.bias"], device)}, {}, 0)
    used.update(("depth_head.conv1.weight", "depth_head.conv1.bias"))

    # task 0 is arch_init: candidate 0 everywhere
    archis = [{**{s: 0 for s in SITE_NAMES}, **{h: 0 for h in HEAD_NAMES}}]
    genotypes = [Genotype(normal=units["cell_2d0"][0].spec.gene,
                          reduce=units["cell_3d0"][0].spec.gene)]
    net = GrowableDepthNet(genotypes, units, heads, archis,
                           depth_head=depth_head)

    dormant = sorted(k for k in sd if k not in used and (
        ".bn." in k and (k.startswith("last_3_2d")
                         or k.startswith("last_3_3d"))))
    tracked = sorted(k for k in sd if k.endswith("num_batches_tracked")
                     and k not in dormant)
    unused = sorted(k for k in sd
                    if k not in used and k not in dormant
                    and k not in tracked)
    info = {"task": task, "imported": len(used),
            "skipped_dormant": len(dormant) + len(tracked),
            "candidates": counts, "unused": unused}
    assert not unused, f"unmapped reference tensors: {unused[:8]}"
    return net, info


def main(argv=None, device=None):
    """``python -m rag_tpu_torch.compat.torch_import CKPT [--eval]``: import
    a checkpoint and print what landed; ``--eval`` runs task 0 through the
    depth eval step on a synthetic depth scene. On the card unless
    ``device="cpu"``. Returns (net, info, eval metrics or None)."""
    import argparse

    from rag_tpu_torch.continual.depth_driver import SyntheticDepthDataset
    from rag_tpu_torch.metrics.meters import AverageMeterDict
    from rag_tpu_torch.train.trainer import make_depth_eval_step

    ap = argparse.ArgumentParser(
        description="Import a reference rag_depth checkpoint and run a "
                    "task-0 forward/eval parity check")
    ap.add_argument("ckpt")
    ap.add_argument("--eval", action="store_true",
                    help="evaluate task 0 on a synthetic depth scene")
    args = ap.parse_args(argv)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the import runs on a CUDA device and none is "
                           "available; main(argv, device='cpu') runs it on "
                           "the CPU")
    net, info = import_depth_checkpoint(args.ckpt, device)
    print(f"imported task-{info['task']} checkpoint: "
          f"{info['imported']} tensors -> registry, "
          f"{info['skipped_dormant']} dormant skipped, "
          f"{net.size_m():.4f} M params")
    print("candidates per site:", info["candidates"])
    if not args.eval:
        return net, info, None
    specs, params, stats = net.path(net.archis[0])
    step = make_depth_eval_step(specs)
    ds = SyntheticDepthDataset(8, 96, 192, seed=1, device=device)
    v = AverageMeterDict().update_batched(
        [step(params, stats, b["image"], b["depth"])
         for b in ds.batches(2, False, seed=0, drop_last=False)]).mean()
    print("task-0 eval on synthetic scene: "
          + " ".join(f"{k}={v[k]:.4f}" for k in sorted(v)))
    return net, info, v


if __name__ == "__main__":
    main()
