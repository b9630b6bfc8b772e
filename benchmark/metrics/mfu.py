"""The whole request's or step's share of the H100's dense TF32 peak: the
model's FLOPs (forward; in training also dX, and dW of the sites that
train; ``harness.work``) of every request or step of the window over the
window's host-clock time, in %. Serves ``mfu.serve`` and ``mfu.train``."""

from harness.rooflines import PEAK_TF32_FLOPS


def read(ctx):
    if not ctx.window_s:
        return None
    return 100.0 * ctx.flops / ctx.window_s / PEAK_TF32_FLOPS
