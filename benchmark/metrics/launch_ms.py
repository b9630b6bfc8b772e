"""Host time of the hand-written kernels' launches, in ms: over the
traced segment's roots (the program's ``serve.request`` or ``train.step``
spans, ``harness.spans``), the mean of the summed self time of a root's
``kernel.<letter>`` spans (each wrapper's plan, allocations, argument
packing and ctypes call), on any thread: the backward's launches join
their step. Nothing where the program records no spans, dropped some, or
the roots are not the segment's requests or steps. Serves
``launch_ms.serve`` and ``launch_ms.train``."""

from harness.spans import segment


def read(ctx):
    seg = segment(ctx)
    if seg is None:
        return None
    own = seg.store.self_ns()
    launch = sum(own[r.id] for r in seg.records
                 if r.name.startswith("kernel."))
    return launch / 1e6 / len(seg.roots)
