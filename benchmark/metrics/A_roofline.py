"""Kernel A's share of its roofline in the traced segment: the summed
bounds of its calls (each 3x3x3 conv after the stem, and in training its
dX, priced by ``harness.rooflines`` at the TF32 peak or the HBM rate)
over the device time of its launches, in %. Serves ``A_roofline.serve``
and ``A_roofline.train``."""


def read(ctx):
    busy = ctx.trace.class_s().get("A", 0.0)
    bound = ctx.work.get("A", {}).get("bound_s", 0.0)
    if busy <= 0 or bound <= 0:
        return None
    return 100.0 * bound / busy
