"""The program's spans of a traced segment, for the ``program_span``
readers (``metrics/dispatch_ms.py``, ``wait_ms.py``, ``optimizer_ms.py``,
``launch_ms.py``): the records of ``rag_tpu_torch.utils.profiling.SPANS``,
which the program fills only while a profiler records, so in a benchmark
process only in the traced segment.
"""

from types import SimpleNamespace


def segment(ctx):
    """The segment's spans: ``roots`` (the root spans, requests or steps,
    by root number), ``records`` (every span in one of them) and
    ``store``. None where the program records no spans, dropped some, or
    its roots are not the segment's ``ctx.items``."""
    try:
        from rag_tpu_torch.utils import profiling
    except ImportError:
        return None
    store = getattr(profiling, "SPANS", None)
    if store is None or store.dropped:
        return None
    records = store.records()
    roots = {r.root: r for r in records if r.is_root}
    if not roots or len(roots) != ctx.items:
        return None
    return SimpleNamespace(roots=roots, store=store,
                           records=[r for r in records if r.root in roots])


def outermost_waits(seg):
    """The segment's wait spans that no other wait span holds."""
    by_id = {r.id: r for r in seg.records}

    def outermost(r):
        while r.parent is not None:
            r = by_id[r.parent]
            if r.wait:
                return False
        return True

    return [r for r in seg.records if r.wait and outermost(r)]
