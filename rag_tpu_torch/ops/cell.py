"""Genotype-driven cells: 2D feature cells (NHWC) and 3D matching cells
(channel-first).

Counterpart of rag_tpu/ops/cell.py. A cell is a 3-step DAG over states
[s0, s1]; each step sums its two genotype-selected in-edges and the output
concatenates the last 3 states. Genes are canonical (edge, op) tuples sorted
by edge. Conv edges that read the same state run as ONE conv with their
output channels concatenated (exact: conv, BN and ReLU are per output
channel), which widens Cout up to 48 in the matching cells; their new
BatchNorm statistics are split back per edge. Cells return
``(y, new_stats)`` with new_stats keyed as the stats tree.

Ops: op 0 = skip_connect (identity), op 1 = conv_3x3 (ConvBR, stride 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from rag_tpu_torch.ops.convbr import ConvBRSpec, apply_convbr
from rag_tpu_torch.ops.convbr_cf import apply_convbr_cf
from rag_tpu_torch.ops.resize import resize_cf, resize_linear, scale_dimension

STEPS = 3
BLOCK_MULTIPLIER = 3

OP_SKIP = 0
OP_CONV = 1

Gene = Tuple[Tuple[int, int], ...]  # ((edge, op) x 6), sorted by edge


def canonicalize_gene(pairs) -> Gene:
    """Sort (edge, op) pairs by edge and validate each step's in-edges."""
    flat = sorted((int(e), int(o)) for e, o in pairs)
    if len(flat) != 2 * STEPS:
        raise ValueError(f"gene needs {2 * STEPS} edges: {flat}")
    offset, nstates, idx = 0, 2, 0
    for _ in range(STEPS):
        for _ in range(2):
            e, _ = flat[idx]
            if not offset <= e < offset + nstates:
                raise ValueError(f"edge {e} outside step window: {flat}")
            idx += 1
        offset += nstates
        nstates += 1
    return tuple(flat)


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """Static cell description."""

    ndim: int          # 2 (feature) or 3 (matching)
    c_pp: int          # prev_prev input channels
    c_p: int           # prev input channels
    c_out: int         # per-state channels
    downup: int        # -1 halve, 0 keep, +1 double spatial dims
    gene: Gene

    @property
    def out_channels(self) -> int:
        return BLOCK_MULTIPLIER * self.c_out


def _edge_groups(gene: Gene) -> Dict[int, list]:
    """Conv edges grouped by the global index of the state they read
    (0 = s0, 1 = s1, 2+k = intermediate node k)."""
    groups: Dict[int, list] = {}
    offset, nstates = 0, 2
    state_of_edge = {}
    for _ in range(STEPS):
        for j in range(nstates):
            state_of_edge[offset + j] = j
        offset += nstates
        nstates += 1
    for edge, op in gene:
        if op == OP_CONV:
            groups.setdefault(state_of_edge[edge], []).append(edge)
    return groups


def _merged(params, stats, keys):
    mp = {"w": torch.cat([params[k]["w"] for k in keys], dim=-1),
          "scale": torch.cat([params[k]["scale"] for k in keys]),
          "bias": torch.cat([params[k]["bias"] for k in keys])}
    ms = {"mean": torch.cat([stats[k]["mean"] for k in keys]),
          "var": torch.cat([stats[k]["var"] for k in keys])}
    return mp, ms


def _run_dag(spec: CellSpec, s0, s1, run_merged, ch_axis: int, new_stats):
    """The cell DAG shared by both layouts. run_merged(edges, x) runs the
    same-input conv edges as one conv and returns ({edge: output},
    {edge key: new stats})."""
    groups = _edge_groups(spec.gene)
    conv_out: Dict[int, torch.Tensor] = {}

    def run_group(state_idx, x):
        if state_idx in groups:
            outs, ns = run_merged(groups[state_idx], x)
            conv_out.update(outs)
            new_stats["ops"].update(ns)

    run_group(0, s0)
    run_group(1, s1)
    states = [s0, s1]
    offset = 0
    for _ in range(STEPS):
        acc = None
        for edge, op in spec.gene:
            if not offset <= edge < offset + len(states):
                continue
            h = conv_out[edge] if op == OP_CONV else states[edge - offset]
            acc = h if acc is None else acc + h
        offset += len(states)
        states.append(acc)
        run_group(len(states) - 1, states[-1])
    return torch.cat(states[-BLOCK_MULTIPLIER:], dim=ch_axis), new_stats


def _split_stats(ns, keys, c):
    return {k: {"mean": ns["mean"][i * c:(i + 1) * c],
                "var": ns["var"][i * c:(i + 1) * c]}
            for i, k in enumerate(keys)}


def apply_cell(spec: CellSpec, params, stats, s0, s1, train: bool = False,
               halves: int = 1):
    """2D feature cell on NHWC maps. Returns (y, new_stats)."""
    assert spec.ndim == 2
    axes = (1, 2)
    new_stats = {"ops": {}}
    if spec.downup != 0:
        scale = 0.5 if spec.downup == -1 else 2.0
        target = tuple(scale_dimension(s1.shape[a], scale) for a in axes)
        s1 = resize_linear(s1, target, axes, align_corners=True)
    s1_spatial = tuple(s1.shape[a] for a in axes)
    if tuple(s0.shape[a] for a in axes) != s1_spatial:
        s0 = resize_linear(s0, s1_spatial, axes, align_corners=True)
    if spec.c_pp != spec.c_out:
        s0, new_stats["pre"] = apply_convbr(
            ConvBRSpec(2, spec.c_pp, spec.c_out, 1), params["pre"],
            stats["pre"], s0, train, halves)
    s1, new_stats["prep"] = apply_convbr(
        ConvBRSpec(2, spec.c_p, spec.c_out, 1), params["prep"],
        stats["prep"], s1, train, halves)
    c = spec.c_out

    def run_merged(edges, x):
        keys = [str(e) for e in edges]
        mp, ms = _merged(params["ops"], stats["ops"], keys)
        out, ns = apply_convbr(ConvBRSpec(2, c, c * len(edges), 3), mp, ms,
                               x, train, halves)
        return ({e: out[..., i * c:(i + 1) * c] for i, e in enumerate(edges)},
                _split_stats(ns, keys, c))

    return _run_dag(spec, s0, s1, run_merged, -1, new_stats)


def apply_cell_cf(spec: CellSpec, params, stats, s0, s1, train: bool = False):
    """3D matching cell on channel-first (B, D, C, H, W) volumes. Returns
    (y, new_stats)."""
    assert spec.ndim == 3
    axes = (1, 3, 4)
    new_stats = {"ops": {}}
    if spec.downup != 0:
        scale = 0.5 if spec.downup == -1 else 2.0
        target = tuple(scale_dimension(s1.shape[a], scale) for a in axes)
        s1 = resize_cf(s1, *target, True)
    s1_spatial = tuple(s1.shape[a] for a in axes)
    if tuple(s0.shape[a] for a in axes) != s1_spatial:
        s0 = resize_cf(s0, *s1_spatial, True)
    if spec.c_pp != spec.c_out:
        s0, new_stats["pre"] = apply_convbr_cf(
            ConvBRSpec(3, spec.c_pp, spec.c_out, 1), params["pre"],
            stats["pre"], s0, train)
    s1, new_stats["prep"] = apply_convbr_cf(
        ConvBRSpec(3, spec.c_p, spec.c_out, 1), params["prep"],
        stats["prep"], s1, train)
    c = spec.c_out

    def run_merged(edges, x):
        keys = [str(e) for e in edges]
        mp, ms = _merged(params["ops"], stats["ops"], keys)
        out, ns = apply_convbr_cf(ConvBRSpec(3, c, c * len(edges), 3), mp, ms,
                                  x, train)
        return ({e: out[:, :, i * c:(i + 1) * c] for i, e in enumerate(edges)},
                _split_stats(ns, keys, c))

    return _run_dag(spec, s0, s1, run_merged, 2, new_stats)
