"""The readers of the program's spans (``dispatch_ms``, ``wait_ms``,
``optimizer_ms``, ``launch_ms``, through ``harness.spans``) on a synthetic
span store: their arithmetic, and nothing where the store is empty, lacks,
or holds another number of roots than the segment's items."""

from types import SimpleNamespace

import pytest

from harness import spec
from rag_tpu_torch.utils import profiling
from rag_tpu_torch.utils.profiling import SpanRecord, SpanStore

MS = 1_000_000      # ns


def request(n, base, t0):
    """The ``n``-th synthetic request (or step), its spans' ids from
    ``base``, opened at ``t0`` ms: 10 ms long, a 1 ms copy in, a route of
    2 ms with a 0.5 ms fetch, a forward of 5 ms with two launches (0.3 ms,
    and 0.2 ms with a 0.05 ms child), a 1.5 ms copy out, an optimizer tail
    of 0.3 ms on the host and 0.7 ms on the device, and a 0.4 ms launch on
    another thread (the autograd worker's)."""
    def rec(name, i, parent, a, b, wait=False, thread=1, events=None):
        return SpanRecord(name, base + i, parent, n, thread,
                          int((t0 + a) * MS), int((t0 + b) * MS), wait,
                          events)

    root = base
    return [
        rec("serve.copy_in", 1, root, 0.0, 1.0, True),
        rec("serve.route.fetch", 3, root + 2, 2.0, 2.5, True),
        rec("serve.route", 2, root, 1.0, 3.0),
        rec("kernel.A", 5, root + 4, 3.5, 3.8),
        rec("kernel.X", 7, root + 6, 4.1, 4.15),
        rec("kernel.C", 6, root + 4, 4.0, 4.2),
        rec("serve.forward", 4, root, 3.0, 8.0),
        rec("serve.copy_out", 8, root, 8.0, 9.5, True),
        rec("train.optimizer", 9, root, 9.5, 9.8,
            events=(Event(9.6), Event(10.3))),
        rec("kernel.D", 10, root, 8.5, 8.9, thread=2),
        SpanRecord("serve.request", root, None, n, 1, int(t0 * MS),
                   int((t0 + 10.0) * MS), False),
    ]


class Event:
    """A completed CUDA event at ``ms`` on the device's clock."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def store_of(*recs):
    s = SpanStore()
    for r in recs:
        s.add(r)
    return s


TWO = request(0, 10, 0.0) + request(1, 100, 50.0)
EXPECTED = {
    "dispatch_ms": 10.0 - 1.0 - 0.5 - 1.5,
    "wait_ms": 1.0 + 0.5 + 1.5,
    "optimizer_ms": 0.7,
    # A 0.3, C 0.2 less its child's 0.05, the child 0.05, D 0.4
    "launch_ms": 0.3 + 0.15 + 0.05 + 0.4,
}


@pytest.mark.parametrize("metric", [
    "dispatch_ms.serve", "wait_ms.serve", "optimizer_ms.train",
    "launch_ms.serve", "launch_ms.train"])
def test_reader_arithmetic(metric, monkeypatch):
    monkeypatch.setattr(profiling, "SPANS", store_of(*TWO))
    got = spec.reader(metric)(SimpleNamespace(items=2))
    assert got == pytest.approx(EXPECTED[metric.split(".")[0]], rel=1e-9)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
@pytest.mark.parametrize("case", ["empty", "other_count", "dropped",
                                  "no_store"])
def test_reader_reads_nothing(metric, case, monkeypatch):
    if case == "no_store":
        # the program before spans: the reader finds nothing, and raises
        # nothing
        monkeypatch.delattr(profiling, "SPANS")
    else:
        store = store_of(*({"empty": [], "other_count": TWO,
                            "dropped": TWO}[case]))
        if case == "dropped":
            store.dropped = 1
        monkeypatch.setattr(profiling, "SPANS", store)
    items = 3 if case == "other_count" else 2
    assert spec.reader(metric)(SimpleNamespace(items=items)) is None


@pytest.mark.parametrize("stray", [
    SpanRecord("kernel.A", 500, None, None, 1, 0, MS, False),
    SpanRecord("kernel.A", 501, 499, None, 1, 0, MS, False),
], ids=["no_parent", "no_root"])
def test_spans_outside_the_roots_are_not_counted(stray, monkeypatch):
    """A span that opened in no root is neither a root of the segment's
    nor a part of one."""
    monkeypatch.setattr(profiling, "SPANS", store_of(*TWO, stray))
    ctx = SimpleNamespace(items=2)
    assert spec.reader("launch_ms.serve")(ctx) == \
        pytest.approx(EXPECTED["launch_ms"], rel=1e-9)


def test_optimizer_reads_nothing_untimed(monkeypatch):
    """Tails not timed on the device (the program on the CPU) give no
    optimizer_ms."""
    recs = [r._replace(events=None) for r in TWO]
    monkeypatch.setattr(profiling, "SPANS", store_of(*recs))
    ctx = SimpleNamespace(items=2)
    assert spec.reader("optimizer_ms.train")(ctx) is None
    assert spec.reader("launch_ms.train")(ctx) == \
        pytest.approx(EXPECTED["launch_ms"], rel=1e-9)
