"""The control comes out not correct: the plain reference computed in
TF32 (the nearest precision below the configuration's float32 with TF32
off), put in the program's place, against the float32 reference, at a
size a test run holds, on the card. The cells' own size is read by
``benchmark/calibrate.py`` (PERF.md gives its readings)."""

import pytest

from harness import compare, serve, train
from harness.inputs import serve_pool, train_pool
from harness.spec import load

pytestmark = pytest.mark.card


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_serve_control_fails(card, seed):
    cell = load("ds4-serve-cam1")
    traffic = dict(cell.traffic, pool_sets=2)
    pool = serve_pool(seed, traffic, card)
    samples = [(i, i, None, None) for i in range(len(pool))]
    ref = serve.reference_outputs(cell.config, pool, samples, card)
    tf32 = serve.reference_outputs(cell.config, pool, samples, card, tf32=True)
    ok, checks = compare.verdict(serve.numbers(tf32, ref),
                                 cell.limits["limits"])
    assert not ok, checks


@pytest.mark.parametrize("workload", ["ds4-train-t3", "self-train-t0"])
def test_train_control_fails(card, workload):
    cell = load(workload)
    traffic = dict(cell.traffic, batch=2, pool_batches=3)
    batches = train_pool(7, traffic, card)
    cfg, task = cell.config, traffic["task"]
    ref, s0 = train.reference_steps(cfg, task, batches, card)
    tf32, _ = train.reference_steps(cfg, task, batches, card, tf32=True)
    from reference.net import Checkpoint, Path

    p0 = {k: v for k, v in Path(Checkpoint(
        str(train.ROOT / cfg["checkpoint"]), task), task, cfg["net"],
        card).params.items() if k in ref["params"]}
    wd = cfg["hyper"]["weight_decay"]
    nums = compare.train_numbers(train.as_program(tf32, p0, wd), ref, p0,
                                 s0, s0, wd)
    ok, checks = compare.verdict(nums, cell.limits["limits"])
    assert not ok, checks
