"""Genotype: the searched cell architecture, as immutable data.

Counterpart of rag_tpu/search/genotype.py (the search that produces
genotypes arrives with the search slice).
"""

from __future__ import annotations

import dataclasses

from rag_tpu_torch.ops.cell import Gene, canonicalize_gene


@dataclasses.dataclass(frozen=True)
class Genotype:
    """normal = 2D feature cell gene; reduce = 3D matching cell gene."""

    normal: Gene
    reduce: Gene


def default_genotype() -> Genotype:
    """The fixed genotype of the flagship deployed model (used when running
    without a search stage)."""
    gene = canonicalize_gene([(0, 1), (1, 1), (2, 1), (3, 1), (5, 1), (6, 1)])
    return Genotype(normal=gene, reduce=gene)
