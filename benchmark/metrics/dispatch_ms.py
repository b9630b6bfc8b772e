"""Host time of a request not spent blocked on the device, in ms: over
the traced segment's roots (the program's ``serve.request`` spans,
``harness.spans``), the mean of a root's duration less its outermost wait
spans'. Nothing where the program records no spans, dropped some, or the
roots are not the segment's requests. Serves ``dispatch_ms.serve``."""

from harness.spans import outermost_waits, segment


def read(ctx):
    seg = segment(ctx)
    if seg is None:
        return None
    host = sum(r.ns for r in seg.roots.values())
    wait = sum(r.ns for r in outermost_waits(seg))
    return (host - wait) / 1e6 / len(seg.roots)
