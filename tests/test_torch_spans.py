"""The port's program spans on the CPU (rag_tpu_torch.utils.profiling.span):
nothing recorded without a profiler, the spans of a request and of a train
step under one, a backward's span joining its step, roots that stay roots
on any thread, a span timed on the device, the chrome trace's
``user_annotation`` events against the store, self times, the store's cap,
and every hand-written kernel's launch counted and spanned in one place
(ops.cuda_lib.launch)."""

import json
import os
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rag_tpu_torch.continual.inference import RoutedInference
from rag_tpu_torch.models.growable import GrowableStereoNet
from rag_tpu_torch.models.router import SceneRouter
from rag_tpu_torch.ops import conv3d, cuda_lib, cvstem, disparity, resize, \
    shear
from rag_tpu_torch.search.genotype import default_genotype
from rag_tpu_torch.train.trainer import (
    clone_tree,
    make_optimizer,
    make_selfsup_train_step,
    make_train_step,
)
from rag_tpu_torch.utils import profiling
from rag_tpu_torch.utils.profiling import SpanRecord, SpanStore

ROOT = Path(__file__).resolve().parent.parent

# each span of a request or step -> (its parent's name, wait)
SERVE_TREE = {
    "serve.request": (None, False),
    "serve.copy_in": ("serve.request", True),
    "serve.route": ("serve.request", False),
    "serve.route.fetch": ("serve.route", True),
    "serve.path": ("serve.request", False),
    "serve.forward": ("serve.path", False),
    "serve.copy_out": ("serve.path", True),
}
SERVE_TASK_TREE = {
    "serve.request": (None, False),
    "serve.copy_in": ("serve.request", True),
    "serve.forward": ("serve.request", False),
    "serve.copy_out": ("serve.request", True),
}
TRAIN_TREE = {
    "train.step": (None, False),
    "train.forward": ("train.step", False),
    "train.backward": ("train.step", False),
    "train.optimizer": ("train.step", False),
    "train.metrics": ("train.step", False),
}


@pytest.fixture(scope="module")
def tiny():
    """A one-task net, a one-task router, a frame pair and a target: the
    RoutedInference and the supervised and photometric steps over them."""
    net = GrowableStereoNet.initial(default_genotype(), 0, "cpu")
    ri = RoutedInference(net, SceneRouter(1, seed=0, device="cpu"),
                         maxdisp=24, device="cpu")
    specs, params, stats = net.path(net.archis[0])
    opt = make_optimizer(3e-3)
    steps = {make: make(specs, net.trainable_sites(0), opt, maxdisp=24)
             for make in (make_train_step, make_selfsup_train_step)}
    rng = np.random.default_rng(0)
    left = rng.standard_normal((2, 24, 48, 3)).astype(np.float32)
    return dict(ri=ri, steps=steps, params=params, stats=stats, opt=opt,
                left=left, gt=torch.full((2, 24, 48), 5.0))


def run(tiny, what):
    """One request or step of ``tiny``: "serve" (routed), "serve_task"
    (the task given), "train" or "selfsup"."""
    left = tiny["left"]
    if what == "serve":
        return tiny["ri"].predict(left, left)
    if what == "serve_task":
        return tiny["ri"].predict(left, left, task=0)
    make = make_train_step if what == "train" else make_selfsup_train_step
    p = clone_tree(tiny["params"])
    x = torch.from_numpy(left)
    return tiny["steps"][make](p, tiny["stats"], tiny["opt"].init(p), 1e-3,
                               x, x, tiny["gt"])


TREES = {"serve": SERVE_TREE, "serve_task": SERVE_TASK_TREE,
         "train": TRAIN_TREE, "selfsup": TRAIN_TREE}


@pytest.mark.parametrize("what", ["serve", "train"])
def test_no_profiler_records_nothing(tiny, what):
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("serve.request", root=True) is profiling.NO_SPAN
    assert profiling.span("x", wait=True) is profiling.NO_SPAN
    assert profiling.span("train.optimizer", device=True) is \
        profiling.NO_SPAN
    profiling.SPANS.clear()
    run(tiny, what)
    assert profiling.SPANS.records() == []


@pytest.mark.parametrize("what", sorted(TREES))
def test_spans_of_requests_and_steps(tiny, what, tmp_path):
    """Two requests or steps under a profiler: one root each, with its own
    id, and each span once under its parent, in its root; none timed on
    the device without CUDA."""
    tree = TREES[what]
    with profiling.trace(str(tmp_path)):
        run(tiny, what)
        run(tiny, what)
    recs = profiling.SPANS.records()
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.is_root]
    assert [r.name for r in roots] == [next(iter(tree))] * 2
    assert all(r.root is not None and r.events is None for r in recs)
    assert roots[1].root == roots[0].root + 1      # a request counter
    for root in roots:
        mine = [r for r in recs if r.root == root.root]
        assert sorted(r.name for r in mine) == sorted(tree)
        for r in mine:
            parent, wait = tree[r.name]
            assert r.wait == wait
            assert (None if r.parent is None
                    else by_id[r.parent].name) == parent
            assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns


class _Doubled(torch.autograd.Function):
    """x * 2, whose backward opens a kernel's span as a launch in a
    backward does."""

    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        with profiling.span("kernel.G"):
            return g * 2


def _backward_on_this_thread():
    x = torch.ones(3, requires_grad=True)
    with profiling.span("train.backward"):
        _Doubled.apply(x).sum().backward()


def _span_on_a_worker_thread():
    # the autograd engine's worker on CUDA opens its spans on a thread
    # with none open; a Python thread stands in for it (the profiler's
    # state is not carried there, so the recording Span is opened as is)
    def work():
        with profiling.Span("kernel.G"):
            pass

    t = threading.Thread(target=work)
    t.start()
    t.join()


@pytest.mark.parametrize("backward", [_backward_on_this_thread,
                                      _span_on_a_worker_thread],
                         ids=["same_thread", "worker_thread"])
def test_backward_span_joins_the_step(backward, tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("train.step", root=True):
            backward()
    recs = profiling.SPANS.records()
    step = next(r for r in recs if r.name == "train.step")
    g = next(r for r in recs if r.name == "kernel.G")
    assert g.root == step.root and step.parent is None
    assert [r.name for r in recs if r.is_root] == ["train.step"]
    if backward is _span_on_a_worker_thread:
        assert g.parent == step.id and g.thread != step.thread


def test_chrome_trace_holds_the_store(tiny, tmp_path):
    """trace() clears the store, and writes each span as a user_annotation
    event, nested as in the store, with the forward's aten ops inside
    serve.forward."""
    profiling.SPANS.add(SpanRecord("stale", -1, None, -1, 0, 0, 1, False))
    with profiling.trace(str(tmp_path)):
        run(tiny, "serve")
    recs = profiling.SPANS.records()
    assert "stale" not in {r.name for r in recs}
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    assert sorted(e["name"] for e in notes) == sorted(r.name for r in recs)
    # one span of each name in a request: each record's event by name
    ev = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in notes}
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.parent is not None:
            a, b = ev[r.name]
            pa, pb = ev[by_id[r.parent].name]
            assert pa <= a <= b <= pb, (r.name, by_id[r.parent].name)
    a, b = ev["serve.forward"]
    ops = [e["name"] for e in events if e.get("cat") == "cpu_op"
           and a <= e["ts"] and e["ts"] + e["dur"] <= b]
    assert any(n.startswith("aten::conv") for n in ops), ops[:20]


def _rec(i, a, b, parent=None, thread=1):
    return SpanRecord(f"s{i}", i, parent, 0, thread, a, b, False)


@pytest.mark.parametrize("children,covered", [
    ([], 0),
    ([(10, 30)], 20),
    ([(10, 30), (20, 40)], 30),                 # overlapping children
    ([(10, 30), (50, 60, 2)], 30),              # one on another thread
    ([(90, 120), (-5, 5)], 15),                 # clipped to the parent
    ([(10, 20), (12, 15), (40, 50)], 20),       # one inside another
])
def test_self_time_is_duration_less_children(children, covered):
    store = SpanStore()
    store.add(_rec(0, 0, 100))
    for i, c in enumerate(children, 1):
        store.add(_rec(i, c[0], c[1], parent=0,
                       thread=c[2] if len(c) > 2 else 1))
    own = store.self_ns()
    assert own[0] == 100 - covered
    for i, c in enumerate(children, 1):
        assert own[i] == c[1] - c[0]


def test_self_time_of_a_request(tiny, tmp_path):
    with profiling.trace(str(tmp_path)):
        run(tiny, "serve")
    recs = profiling.SPANS.records()
    own = profiling.SPANS.self_ns()
    for r in recs:
        kids = [k.ns for k in recs if k.parent == r.id]
        # a request's children on one thread do not overlap
        assert own[r.id] == r.ns - sum(kids), r.name


def test_store_cap_drops_and_warns():
    store = SpanStore(cap=2)
    store.add(_rec(0, 0, 1))
    store.add(_rec(1, 1, 2))
    with pytest.warns(RuntimeWarning, match="full"):
        store.add(_rec(2, 2, 3))
    store.add(_rec(3, 3, 4))
    assert [r.id for r in store.records()] == [0, 1]
    assert store.dropped == 2
    store.clear()
    assert store.records() == [] and store.dropped == 0


def test_threads_share_the_store(monkeypatch):
    """Spans closing on more threads than cores: every one recorded or
    dropped and counted, never past the cap, each under its own thread's
    parent or the one open root."""
    threads, spans = 2 * (os.cpu_count() or 1) + 2, 200
    store = SpanStore(cap=threads * spans - 7)
    monkeypatch.setattr(profiling, "SPANS", store)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(spans // 2):
            with profiling.Span("outer"):
                with profiling.Span("inner"):
                    pass

    try:
        with pytest.warns(RuntimeWarning, match="full"):
            with profiling.Span("root", root=True) as root:
                pool = [threading.Thread(target=work) for _ in range(threads)]
                for t in pool:
                    t.start()
                for t in pool:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    recs = store.records()
    assert len(recs) == store.cap and store.dropped == 8
    assert len({r.id for r in recs}) == len(recs)
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name == "outer":
            assert r.parent == root.id and r.root == root.root
        elif r.name == "inner" and r.parent in by_id:
            assert by_id[r.parent].name == "outer"
            assert by_id[r.parent].thread == r.thread


def _in_thread(fn):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join()
    return out[0]


def _root_inside_another_threads_root():
    def request():
        with profiling.Span("serve.request", root=True) as r:
            with profiling.Span("serve.forward"):
                pass
        return r

    with profiling.Span("train.step", root=True) as step:
        other = _in_thread(request)
    return step, other


def _span_with_two_roots_open():
    opened, done = threading.Event(), threading.Event()

    def other_request():
        with profiling.Span("serve.request", root=True):
            opened.set()
            done.wait(60)

    def work():
        with profiling.Span("kernel.G"):
            pass

    with profiling.Span("serve.request", root=True):
        t = threading.Thread(target=other_request)
        t.start()
        opened.wait(60)
        _in_thread(work)
        done.set()
        t.join()


def test_a_root_stays_a_root_on_another_thread():
    """A request opened on a second thread while a step is open on the
    first is a root of its own, and its spans are its own."""
    profiling.SPANS.clear()
    step, other = _root_inside_another_threads_root()
    recs = {r.name: r for r in profiling.SPANS.records()}
    assert recs["serve.request"].is_root and recs["train.step"].is_root
    assert recs["serve.request"].root == step.root + 1 == other.root
    assert recs["serve.forward"].parent == other.id
    assert recs["serve.forward"].root == other.root


def test_a_span_with_two_roots_open_belongs_to_none():
    """A span on a thread with none open while two roots are open (on two
    threads) has no root to join: it belongs to none."""
    profiling.SPANS.clear()
    _span_with_two_roots_open()
    recs = profiling.SPANS.records()
    g = next(r for r in recs if r.name == "kernel.G")
    assert g.parent is None and g.root is None and not g.is_root
    roots = [r for r in recs if r.is_root]
    assert len(roots) == 2 and roots[0].thread != roots[1].thread


def test_device_timed_span(monkeypatch):
    """A span timed on the device records an event on the current stream
    as it opens and one as it closes (stand-ins for CUDA's here), and
    reads the interval between them; other spans record none."""
    log = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing

        def record(self):
            log.append(self)
            self.at = len(log)

        def elapsed_time(self, end):
            return float(end.at - self.at)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    profiling.SPANS.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("train.step", root=True):
            with profiling.span("train.optimizer", device=True):
                with profiling.span("kernel.A"):
                    log.append("launch")
    recs = {r.name: r for r in profiling.SPANS.records()}
    tail = recs["train.optimizer"]
    assert log == [tail.events[0], "launch", tail.events[1]]
    assert tail.device_ms == 2.0
    assert recs["kernel.A"].events is None
    assert recs["train.step"].device_ms is None


def test_span_split_table_reads_every_span(tiny, tmp_path):
    """scripts/torch_span_split.py's table of a segment: every span name
    of two requests, once a root, with its time and self time a root."""
    import importlib.util

    path = ROOT / "scripts" / "torch_span_split.py"
    mod_spec = importlib.util.spec_from_file_location("span_split", path)
    split = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(split)
    with profiling.trace(str(tmp_path)):
        run(tiny, "serve")
        run(tiny, "serve")
    recs = profiling.SPANS.records()
    roots = {r.root: r for r in recs if r.is_root}
    table = split.span_table(profiling.SPANS, roots)
    assert sorted(table) == sorted(SERVE_TREE)
    for count, ms, own, device_ms in table.values():
        assert count == 1 and device_ms is None and 0 <= own <= ms
    assert table["serve.request"][1] == pytest.approx(
        sum(r.ns for r in roots.values()) / 1e6 / 2)


# each hand-written kernel's wrapper, by letter (benchmark/kernels.json)
WRAPPERS = {
    "A": conv3d.conv3d_affine_cf, "B": cvstem.cvstem_affine,
    "C": disparity.soft_argmin_fwd, "D": conv3d.conv3d_dw_cf,
    "E": cvstem.cvstem_dxy, "F": cvstem.cvstem_dw,
    "G": disparity.soft_argmin_bwd, "H": conv3d.conv3d_dblock_cf,
    "I": resize.resize_taps_cf, "J": shear.shear_forward,
    "K": shear.shear_adjoint,
}


def test_every_hand_written_kernel_has_a_wrapper():
    kernels = json.loads((ROOT / "benchmark" / "kernels.json").read_text())
    assert sorted(WRAPPERS) == kernels["hand_written"]


@pytest.mark.parametrize("letter", sorted(WRAPPERS))
def test_launch_counts_and_spans_in_one_place(letter, tmp_path):
    """cuda_lib.launch counts the wrapper's launch and returns its span
    kernel.<letter>: no span without a profiler, a recording one under
    it; and the wrapper's module counts only through it, each call in a
    with-statement."""
    wrapper = WRAPPERS[letter]
    assert wrapper.span == f"kernel.{letter}"
    n = wrapper.launches
    try:
        with cuda_lib.launch(wrapper, torch.float32) as s:
            assert s is None
        with profiling.trace(str(tmp_path)):
            with cuda_lib.launch(wrapper, torch.float32) as s:
                assert isinstance(s, profiling.Span)
        assert wrapper.launches == n + 2
    finally:
        wrapper.launches = n
    assert [r.name for r in profiling.SPANS.records()] == [wrapper.span]
    src = Path(wrapper.__code__.co_filename).read_text()
    assert not re.search(r"\.launches(_bf16)? \+=", src)
    calls = re.findall(r"^( *)(with )?cuda_lib\.launch\(", src, re.M)
    assert calls and all(w for _, w in calls)


@pytest.mark.parametrize("dtype,attr", [(torch.float32, "launches"),
                                        (torch.bfloat16, "launches_bf16")])
def test_launch_counts_by_instance(dtype, attr):
    def wrapper():
        pass
    wrapper.launches = wrapper.launches_bf16 = 0
    wrapper.span = "kernel.Z"
    with cuda_lib.launch(wrapper, dtype):
        pass
    assert getattr(wrapper, attr) == 1
    assert wrapper.launches + wrapper.launches_bf16 == 1
