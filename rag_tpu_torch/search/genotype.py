"""Genotype: the searched cell architecture, as immutable data.

Counterpart of rag_tpu/search/genotype.py. ``parse_genotype`` extracts a
genotype from MdeNAS's per-edge op probabilities: per step keep the two
in-edges ranked highest by their largest op probability past op 0, then
take each kept edge's most probable op; kept edges sort by index.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rag_tpu_torch.ops.cell import STEPS, Gene, canonicalize_gene


@dataclasses.dataclass(frozen=True)
class Genotype:
    """normal = 2D feature cell gene; reduce = 3D matching cell gene."""

    normal: Gene
    reduce: Gene


def _parse_gene(alphas: np.ndarray) -> Gene:
    """alphas: (num_edges, num_ops) softmax-normalized probabilities."""
    gene = []
    start, n = 0, 2
    for _ in range(STEPS):
        end = start + n
        edges = sorted(range(start, end), key=lambda x: -np.max(alphas[x, 1:]))
        for j in sorted(edges[:2]):
            gene.append((j, int(np.argmax(alphas[j]))))
        start = end
        n += 1
    return canonicalize_gene(gene)


def parse_genotype(p_normal: np.ndarray, p_reduce: np.ndarray) -> Genotype:
    """A Genotype from search probabilities (each (9, 2)), softmaxed in
    float64 first, as the reference does."""

    def _softmax(x):
        e = np.exp(x - x.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    return Genotype(
        normal=_parse_gene(_softmax(np.asarray(p_normal, np.float64))),
        reduce=_parse_gene(_softmax(np.asarray(p_reduce, np.float64))),
    )


def default_genotype() -> Genotype:
    """The fixed genotype of the flagship deployed model (used when running
    without a search stage)."""
    gene = canonicalize_gene([(0, 1), (1, 1), (2, 1), (3, 1), (5, 1), (6, 1)])
    return Genotype(normal=gene, reduce=gene)
