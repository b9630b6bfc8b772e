"""The port's tooling modules on the CPU: rag_tpu_torch.utils.flops
against rag_tpu.utils.flops, utils.profiling (trace sessions, the
debug_nans switch; its spans are test_torch_spans.py's) and
utils.timing."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rag_tpu.utils import flops as jflops
from rag_tpu_torch.models.growable import GrowableStereoNet
from rag_tpu_torch.search.genotype import default_genotype
from rag_tpu_torch.train.trainer import (
    clone_tree,
    make_optimizer,
    make_train_step,
)
from rag_tpu_torch.utils import flops, profiling, timing

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("geometry", [(4, 192, 384), (1, 480, 960)],
                         ids=["train", "eval"])
def test_pipeline_costs_equal_rag_tpu(geometry):
    b, h, w = geometry
    mine = flops.pipeline_costs(b, h, w, maxdisp=192)
    ref = jflops.pipeline_costs(b, h, w, maxdisp=192)
    assert [(s.name, s.flops, s.bytes_moved) for s in mine] == \
        [(s.name, s.flops, s.bytes_moved) for s in ref]
    t, tr = flops.total(mine), jflops.total(ref)
    assert (t.name, t.flops, t.bytes_moved) == \
        (tr.name, tr.flops, tr.bytes_moved)


def test_summarize_against_h100_peaks():
    stages = flops.pipeline_costs(4, 192, 384)
    secs = {"matching_net": 0.01, "disparity_head": 0.002}
    rows = flops.summarize(stages, secs)
    ref = jflops.summarize(jflops.pipeline_costs(4, 192, 384), secs,
                           peak_flops=67e12, peak_bw=3.35e12)
    assert rows == ref
    assert flops.H100_PEAK_FP32_FLOPS == 67e12
    assert flops.H100_PEAK_HBM_BPS == 3.35e12
    src = (ROOT / "rag_tpu_torch" / "utils" / "flops.py").read_text()
    assert "V5E" not in src and "197e12" not in src and "819e9" not in src


def test_trace_writes_and_closes(tmp_path):
    a = torch.randn(32, 32)
    for i in range(2):
        with profiling.trace(str(tmp_path / f"t{i}")) as prof:
            torch.mm(a, a)
        names = {e.key for e in prof.key_averages()}
        assert "aten::mm" in names, (i, sorted(names)[:20])
        events = json.loads((tmp_path / f"t{i}" / "trace.json").read_text())
        assert any(e.get("name") == "aten::mm"
                   for e in events["traceEvents"])
    # the session is closed: a new profiler starts here
    with torch.profiler.profile() as prof:
        torch.mm(a, a)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


@pytest.fixture(scope="module")
def tiny_step():
    net = GrowableStereoNet.initial(default_genotype(), 0, "cpu")
    specs, params, stats = net.path(net.archis[0])
    opt = make_optimizer(3e-3)
    step = make_train_step(specs, net.trainable_sites(0), opt, maxdisp=24)
    # each test takes its step on a copy: a step updates params in place
    rng = np.random.default_rng(0)
    left = torch.from_numpy(rng.standard_normal((2, 24, 48, 3))
                            .astype(np.float32))
    gt = torch.full((2, 24, 48), 5.0)
    return step, params, stats, opt, left, gt


def test_debug_nans_raises_on_nan_loss(tiny_step):
    step, params, stats, opt, left, gt = tiny_step
    params = clone_tree(params)
    bad = left.clone()
    bad[0, 0, 0, 0] = float("nan")
    before = {k: v.clone() for k, v in params["stem_2d0"].items()}
    profiling.debug_nans(True)
    try:
        with pytest.raises(FloatingPointError):
            step(params, stats, opt.init(params), 1e-3, bad, left, gt)
    finally:
        profiling.debug_nans(False)
    # raised before the update: the params did not move
    for k, v in before.items():
        assert torch.equal(params["stem_2d0"][k], v)


def test_debug_nans_off_is_silent(tiny_step):
    step, params, stats, opt, left, gt = tiny_step
    params = clone_tree(params)
    bad = left.clone()
    bad[0, 0, 0, 0] = float("nan")
    assert not profiling.NAN_CHECK.enabled
    _, _, _, sc = step(params, stats, opt.init(params), 1e-3, bad, left, gt)
    assert not torch.isfinite(sc["loss"])


def test_debug_nans_on_passes_finite_step(tiny_step):
    step, params, stats, opt, left, gt = tiny_step
    params = clone_tree(params)
    profiling.debug_nans(True)
    try:
        _, _, _, sc = step(params, stats, opt.init(params), 1e-3, left,
                           left, gt)
    finally:
        profiling.debug_nans(False)
    assert torch.isfinite(sc["loss"])


def test_device_time_on_cpu_and_chip_smoke_imports_timers():
    calls = []
    sec = timing.device_time(lambda x: calls.append(1) or x * 2,
                             torch.ones(4), iters=5, warmup=2)
    assert sec > 0 and len(calls) == 7
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert not {"cuda_ms", "graph_ms"} & defined
    imported = {a.name for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom)
                and n.module == "rag_tpu_torch.utils.timing"
                for a in n.names}
    assert {"cuda_ms", "graph_ms"} <= imported
