"""Host time of a request blocked on the device, in ms: over the traced
segment's roots (the program's ``serve.request`` spans,
``harness.spans``), the mean of the durations of a root's outermost wait
spans (copy in, the routed ids' fetch, copy out). Nothing where the
program records no spans, dropped some, or the roots are not the
segment's requests. Serves ``wait_ms.serve``."""

from harness.spans import outermost_waits, segment


def read(ctx):
    seg = segment(ctx)
    if seg is None:
        return None
    return sum(r.ns for r in outermost_waits(seg)) / 1e6 / len(seg.roots)
