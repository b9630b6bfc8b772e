"""Which optional kernels a path runs: ``KernelVariants``.

rag_tpu keeps three kernels off by default behind environment gates (each
lost on the TPU it was written for). The port selects their counterparts
with this explicit, frozen argument instead, passed from the entry points
(``stereo_forward``, ``RoutedInference``, ``make_train_step``,
``make_eval_step``) down to the ops that branch (``run_matching_cf``,
``apply_cell_cf``, ``apply_convbr_cf``, ``conv3d_brc_cf``, ``resize_cf``).
No environment variable and no module-global or thread-local state: the
autograd Functions take the resolved choice as a non-tensor argument, so a
backward run on PyTorch's autograd thread sees the same choice as its
forward. The all-off default is rag_tpu's default path.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KernelVariants:
    # RAG_TPU_CONV3D_V4: every 3x3x3 conv after the stem (forward and dx)
    # runs kernel H, the D-blocked conv, instead of kernel A
    conv3d_dblock: bool = False
    # RAG_TPU_RESIZE_KERNEL: resize_cf (the matching cells' down/up resizes
    # and the head's two) runs kernel I, forward and adjoint, instead of
    # the matrix products; under a bf16 policy (ops.precision) its bf16
    # instance, where rag_tpu/ops/pallas_resize.py's gate sends a bf16
    # volume to the matrix products (ops/resize.py's module docstring)
    resize_kernel: bool = False
    # RAG_TPU_CVSTEM_SHEAR: stem_3d0 runs as eighteen (3,1) tap-map convs
    # plus kernel J (backward: kernel K) instead of kernels B, E and F
    shear_stem: bool = False


DEFAULT = KernelVariants()
