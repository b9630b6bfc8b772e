"""Profiling and debugging hooks.

Counterpart of rag_tpu/utils/profiling.py:
  * ``trace(log_dir)``: a torch.profiler session over the block, its
    chrome trace written to ``log_dir``. The session is always closed on
    the way out: a session left open in a process stops later profiles
    from recording pageable host-to-device copies.
  * ``span(name, wait=False, root=False, device=False)``: a program
    span at a layer boundary (``serve.*`` in ``continual.inference``,
    ``train.*`` in ``train.trainer``, ``kernel.<letter>`` at each
    hand-written kernel's launch, ``ops.cuda_lib.launch``). Spans record
    exactly while a torch profiler session records, and cost one check
    otherwise: each is then a ``record_function`` (a ``user_annotation``
    event on the profiler's clock, beside the device's kernels) and a
    ``SpanRecord`` in ``SPANS``, the store that ``trace`` clears when it
    starts. The benchmark's span readers read the store, as its traces
    keep no ``user_annotation`` events.
  * ``debug_nans(enable)``: a switch, off by default, that makes the
    port's train steps raise FloatingPointError on a non-finite loss,
    output or gradient (``check_finite``), as jax_debug_nans stops a
    jitted step. Nothing reads it from the environment.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
import warnings
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA where available); yields the
    profiler, whose ``key_averages()`` hold the session's events, and
    writes ``trace.json`` into log_dir after the session has closed."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    SPANS.clear()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


MAX_SPANS = 1 << 17     # records SPANS holds; later ones are dropped


class SpanRecord(NamedTuple):
    """One closed span. A root (a request or a step) has no ``parent``
    and numbers itself in ``root``, counting roots from 0; any other span
    has the root it belongs to in ``root`` (None where it opened in
    none). Times are ``time.perf_counter_ns()``. A ``wait`` span's host
    time is the host blocked on the device (a copy to or from the host).
    ``events``: the CUDA events recorded on the current stream as a span
    timed on the device opened and closed, else None."""
    name: str
    id: int
    parent: Optional[int]
    root: Optional[int]
    thread: int
    start_ns: int
    end_ns: int
    wait: bool
    events: Optional[Tuple[object, object]] = None

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def is_root(self) -> bool:
        return self.parent is None and self.root is not None

    @property
    def device_ms(self) -> Optional[float]:
        """The span's time on the device once its events have completed:
        from the end of the work queued before it opened to the end of
        the work queued inside it."""
        return None if self.events is None else \
            self.events[0].elapsed_time(self.events[1])


class SpanStore:
    """The closed spans of the process, in the order they closed, up to
    ``cap`` records: past it a span is dropped, counted on ``dropped``,
    and the first drop warns."""

    def __init__(self, cap: int = MAX_SPANS):
        self.cap = cap
        self._records: List[SpanRecord] = []
        self.dropped = 0
        self._lock = threading.Lock()   # spans close on several threads

    def add(self, record: SpanRecord) -> None:
        with self._lock:
            if len(self._records) < self.cap:
                self._records.append(record)
                return
            self.dropped += 1
            first = self.dropped == 1
        if first:
            warnings.warn(f"the span store is full ({self.cap} records): "
                          "later spans are dropped", RuntimeWarning)

    def records(self) -> List[SpanRecord]:
        return list(self._records)

    def self_ns(self) -> Dict[int, int]:
        """Each record's self time by id: its duration minus the part of
        it that its child spans cover (their union, on any thread)."""
        children: Dict[int, list] = {}
        for r in self._records:
            if r.parent is not None:
                children.setdefault(r.parent, []).append((r.start_ns,
                                                          r.end_ns))
        out = {}
        for r in self._records:
            covered, end = 0, r.start_ns
            for a, b in sorted(children.get(r.id, ())):
                a, b = max(a, end), min(b, r.end_ns)
                if b > a:
                    covered += b - a
                    end = b
            out[r.id] = r.ns - covered
        return out

    def clear(self) -> None:
        with self._lock:
            self._records = []
            self.dropped = 0


SPANS = SpanStore()

_ids = itertools.count()
_root_ids = itertools.count()
_local = threading.local()      # .stack: the thread's open spans
_roots: List["Span"] = []       # the open roots of every thread


class Span:
    """A recording span (``span`` opens one only while a profiler
    records). A root span is a root wherever it opens. Any other span's
    parent is the innermost span open on its thread; on a thread with
    none open (the autograd engine's worker on CUDA) it is the root open
    in the process, if exactly one is, and otherwise the span belongs to
    no root."""

    __slots__ = ("name", "wait", "is_root", "device", "id", "parent",
                 "root", "start", "events", "_fn", "_stack")

    def __init__(self, name: str, wait: bool = False, root: bool = False,
                 device: bool = False):
        self.name = name
        self.wait = wait
        self.is_root = root
        self.device = device

    def __enter__(self):
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        if self.is_root:
            self.parent, self.root = None, next(_root_ids)
            _roots.append(self)
        elif stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            open_roots = list(_roots)   # other threads open and close roots
            one = open_roots[0] if len(open_roots) == 1 else None
            self.parent = None if one is None else one.id
            self.root = None if one is None else one.root
        stack.append(self)
        self._stack = stack
        self.events = None
        if self.device and torch.cuda.is_available():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self._stack.pop()
        if self.is_root:
            _roots.remove(self)
        SPANS.add(SpanRecord(self.name, self.id, self.parent, self.root,
                             threading.get_ident(), self.start, end,
                             self.wait, self.events))
        self._fn.__exit__(*exc)
        return False


NO_SPAN = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str, wait: bool = False, root: bool = False,
         device: bool = False):
    """A context manager over a program span: a ``Span`` while a torch
    profiler session records, else ``NO_SPAN``, the one shared no-op.
    ``root``: a request or a step, the root of the spans opened in it;
    ``device``: also time the span on the device (``SpanRecord.device_ms``),
    where CUDA is."""
    if not _recording():
        return NO_SPAN
    return Span(name, wait, root, device)


class _NanCheck:
    def __init__(self):
        self.enabled = False


NAN_CHECK = _NanCheck()


def debug_nans(enable: bool = True) -> None:
    """Turn the train steps' finiteness check on or off."""
    NAN_CHECK.enabled = bool(enable)


def check_finite(**tensors) -> None:
    """With debug_nans on: FloatingPointError naming the first non-finite
    tensor among ``tensors`` (a host sync per tensor). Off: nothing."""
    if not NAN_CHECK.enabled:
        return
    for name, t in tensors.items():
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {name}")
