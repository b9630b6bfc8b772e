"""A step's SGD tail on the device's clock, in ms: over the traced
segment's roots (the program's ``train.step`` spans, ``harness.spans``),
the mean of the device times of a root's ``train.optimizer`` spans (the
gradients' sum over the ranks, the clip, weight decay, momentum and
update of every trained leaf), from the end of the backward's device
work to the end of the tail's. The host's time in the span would also
hold its wait for the backward's kernels in a full launch queue; this
holds the tail's own device work and the gaps in which the device waits
for the host to issue it. Nothing where the program records no spans,
dropped some, times none on the device, or the roots are not the
segment's steps. Serves ``optimizer_ms.train``."""

from harness.spans import segment


def read(ctx):
    seg = segment(ctx)
    if seg is None:
        return None
    tails = [r for r in seg.records if r.name == "train.optimizer"]
    if not tails or any(r.events is None for r in tails):
        return None
    return sum(r.device_ms for r in tails) / len(seg.roots)
