"""The matching net's ops that read across a volume's H rows.

``WHOLE`` runs them on whole volumes: the 3x3x3 conv (kernel A, or H,
``ops.conv3d``), the align-corners resize (``ops.resize.resize_cf``) and
the disparity head (kernel C, ``ops.disparity``). The matching blocks and
cells (``ops.convbr_cf``, ``ops.cell``) and ``models.stereo`` call them
through a ``vol`` argument, ``WHOLE`` by default. The spatial path passes
``parallel.halo.SlabVolume`` there instead: the same methods, running the
same kernels on one rank's H slab of a volume split over a mesh's model
axis. Every other op of the matching net reads its own rows only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rag_tpu_torch.ops.conv3d import conv3d_brc_cf
from rag_tpu_torch.ops.disparity import fused_soft_argmin
from rag_tpu_torch.ops.resize import resize_cf
from rag_tpu_torch.ops.variants import KernelVariants


class WholeVolume:
    """Whole volumes: every rank (or the only process) holds all H rows."""

    def rows(self, h: int) -> Tuple[int, int]:
        """The rows [h0, h1) of an H axis of h rows that this volume holds."""
        return 0, h

    def conv(self, x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor, relu: bool,
             variants: KernelVariants) -> torch.Tensor:
        """conv3d_brc_cf of x (B, D, Cin, H, W)."""
        return conv3d_brc_cf(x.contiguous(), w, scale, bias, relu, variants)

    def resize(self, x: torch.Tensor, h: int, d2: int, h2: int, w2: int,
               variants: KernelVariants) -> torch.Tensor:
        """The align-corners resize of x, whose whole H is h, to (d2, h2,
        w2)."""
        return resize_cf(x, d2, h2, w2, True, variants)

    def soft_argmin(self, x: torch.Tensor, maxdisp: int,
                    scale: int) -> torch.Tensor:
        """The head on the matching cost x (B, D, h, w): (B, scale h,
        scale w) disparities."""
        return fused_soft_argmin(x.contiguous(), maxdisp, scale)


WHOLE = WholeVolume()
