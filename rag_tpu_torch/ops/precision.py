"""The mixed-precision policy: bf16 at rest, float32 compute.

Counterpart of rag_tpu/ops/precision.py, as an explicit frozen argument
instead of rag_tpu's environment variable ``RAG_TPU_COMPUTE_DTYPE``: a
``Precision`` is passed as ``precision=``
beside ``variants=`` to the entry points, and the three model forwards
(``stereo_forward``, ``supernet_forward``, ``depth_forward``) cast their
activations at rag_tpu's boundaries. Below them every op dispatches on
its tensor's dtype, as rag_tpu's do:

  * params, optimizer state, BatchNorm running statistics and every
    parameter gradient: float32 always;
  * the feature net's and the matching half's activations between ops:
    ``compute_dtype`` (bfloat16 under ``--bf16``, else float32). The
    feature net rides it as under rag_tpu's default
    ``RAG_TPU_BF16_FEATURES=1``; that variable's opt-out has no
    counterpart, since no caller of the port needs it;
  * inside the hand-written kernels A, B, D-F and H-K: bf16 loads are
    widened to float32 before the sums, which run in float32, and the
    output is stored in the input's dtype (the weight gradients and K's
    tap-map gradients in float32); kernels C and G take float32 only;
  * BatchNorm takes its statistics and normalizes in float32 and returns
    x's dtype; the 2D and 1x1x1 convs cast the weight to x's dtype;
  * the disparity and depth heads run in float32.

The default ``Precision()`` is float32 everywhere: every cast is then the
identity.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    # storage dtype of the feature net's and the matching half's
    # activations (rag_tpu's RAG_TPU_COMPUTE_DTYPE)
    compute_dtype: torch.dtype = torch.float32

    def mixed(self) -> bool:
        return self.compute_dtype != torch.float32

    def cast_in(self, x: torch.Tensor) -> torch.Tensor:
        """An activation in the compute dtype. Tensors wider than float32
        (the float64 tests) keep their dtype under the float32 policy."""
        if not self.mixed() or x.dtype == self.compute_dtype:
            return x
        return x.to(self.compute_dtype)


def wide(x: torch.Tensor) -> torch.Tensor:
    """x upcast to float32 for a float32 computation; float32 and float64
    tensors as they are."""
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


FP32 = Precision()
