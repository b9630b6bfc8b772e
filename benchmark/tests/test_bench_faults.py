"""The check catches a broken timed path: the harness, its look for a
card skipped, drives a small run on the CPU through the program with a
fault planted underneath, and ``correct`` comes out false; the same run
sound comes out true. Faults: an answer altered where it is produced, a
routed id altered (serving); a step that returns its state unchanged,
half of the batch left out with the mean over the rest (training). One
chip, so no exchange between chips to leave out."""

import time

import pytest
import torch

import run as bench_run
from harness.spec import load

SMALL_SERVE = dict(frame_hw=[36, 90], pad_to=[48, 96], pool_sets=4,
                   check_requests=2)
SMALL_TRAIN = dict(frame_hw=[60, 110], crop_hw=[48, 96], batch=2,
                   pool_batches=4)


def small_run(workload, seconds=0.5):
    cell = load(workload)
    cell.traffic.update(SMALL_SERVE if cell.kind == "serve" else SMALL_TRAIN)
    torch.manual_seed(0)
    _, result, checks = bench_run.run_cell(cell, 2 ** 31 + 11, seconds, False,
                                           "cpu", "/tmp", time.perf_counter())
    return result["correct"], checks


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("workload", ["ds4-serve-cam1", "ds4-train-t3"])
def test_sound_run_is_correct(workload):
    ok, checks = small_run(workload)
    assert ok, checks


def _alter_answer(monkeypatch):
    from rag_tpu_torch.continual import inference

    real = inference.stereo_forward

    def altered(*a, **kw):
        disp, st = real(*a, **kw)
        disp = disp.clone()
        disp[:, 5, 7] += 2.0
        return disp, st

    monkeypatch.setattr(inference, "stereo_forward", altered)


def _alter_route(monkeypatch):
    from rag_tpu_torch.models.router import SceneRouter

    real = SceneRouter.predict

    def altered(self, images):
        return (real(self, images) + 1) % self.num_tasks

    monkeypatch.setattr(SceneRouter, "predict", altered)


def _state_unchanged(monkeypatch):
    from rag_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "sgd_apply", lambda *a, **kw: None)


def _half_batch(monkeypatch):
    from rag_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "local_batch", lambda mesh, *ts: tuple(
        t[: t.shape[0] // 2] for t in ts))


@pytest.mark.parametrize("workload,fault", [
    ("ds4-serve-cam1", _alter_answer),
    ("ds4-serve-cam1", _alter_route),
    ("ds4-train-t3", _state_unchanged),
    ("ds4-train-t3", _half_batch),
    ("self-train-t0", _state_unchanged),
    ("self-train-t0", _half_batch),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_makes_the_run_incorrect(monkeypatch, workload, fault):
    fault(monkeypatch)
    ok, checks = small_run(workload)
    assert not ok, checks
