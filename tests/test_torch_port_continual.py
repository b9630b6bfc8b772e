"""Op search, fine-tune and the continual driver against the JAX package,
on the CPU.

(f) one ``OpSearch`` epoch of task 1 on an expanded net holding rag_tpu's
    initial weights (float64, through ``to_torch``): the same sampled
    candidates, p within 1e-12, the same valid loss and D1, the written-back
    new units and heads within 1e-9 of each leaf's largest |dp/lr| and
    their statistics unchanged, the reused units bit-identical.
(g) the best-by-valid-loss restores of ``OpSearch`` and of the driver's
    fine-tune: a run whose best epoch is not the last ends on copies of
    that epoch's tensors (the port's train step updates the registry's
    tensors in place).
(h) a port-only 2-task ``ContinualDriver.run`` at 24x48 with checkpoints
    and the router: structure, files, ``matrix[1, 0] == matrix[0, 0]`` bit
    for bit in all six metrics, and the final checkpoint read back through
    both packages' readers.
Also ``split_half``, ``ForgettingMatrix`` and ``MetricWriter``'s
``events.jsonl`` records equal rag_tpu's.
Slow: the same 2-task run in both packages in float64 from equal initial
weights: the same genotypes, archis and model_to_train, and forgetting
matrices within 1e-9 relative.
"""

import dataclasses
import os
import re

import jax
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from learn_parity import (
    ArrayScene,
    Inits,
    Recorder,
    assert_trees_equal,
    assert_update_close,
    flat,
    np_tree,
    opt0,
)
from rag_tpu.continual import driver as jdriver
from rag_tpu.continual import state as jstate
from rag_tpu.models import growable as jgrowable
from rag_tpu.models import supernet as jsupernet
from rag_tpu.search import genotype as jgenotype
from rag_tpu.search import growth as jgrowth
from rag_tpu.search import mdenas as jmdenas
from rag_tpu_torch.continual import driver as tdriver
from rag_tpu_torch.continual import state as tstate
from rag_tpu_torch.convert import to_torch
from rag_tpu_torch.models.growable import GrowableStereoNet
from rag_tpu_torch.models.stereo import HEAD_NAMES, SITE_NAMES
from rag_tpu_torch.search import genotype as tgenotype
from rag_tpu_torch.search import growth as tgrowth
from rag_tpu_torch.search import mdenas as tmdenas
from test_torch_port_train_slice import _jax_in

H, W, MAXDISP = 24, 48, 48
GENE = ((0, 1), (1, 1), (2, 0), (3, 1), (5, 1), (6, 0))
METRICS = ("D1", "EPE", "loss", "Thres1", "Thres2", "Thres3")


def _genos():
    return (jgenotype.Genotype(normal=GENE, reduce=GENE),
            tgenotype.Genotype(normal=GENE, reduce=GENE))


def _cast64(net):
    """Every unit of a rag_tpu registry as float64 numpy (in place)."""
    for store in (net.units, net.heads):
        for units in store.values():
            for u in units:
                u.params, u.stats = (np_tree(u.params, np.float64),
                                     np_tree(u.stats, np.float64))


def _expanded(monkeypatch):
    """(rag_tpu net, port net): task 0 then expanded for task 1, equal
    float64 tensors (rag_tpu's initial weights)."""
    inits = Inits(monkeypatch)
    gj, gt = _genos()
    jnet = jgrowable.GrowableStereoNet(jax.random.PRNGKey(0), gj)
    jnet.expand(jax.random.PRNGKey(1), 1, gj)
    _cast64(jnet)
    (sp, ss), (hp, hs), (sp1, ss1), (hp1, hs1) = (
        [np_tree(t, np.float64) for t in pair] for pair in inits.drawn)
    torch_of = lambda *ts: tuple(to_torch(t, "cpu") for t in ts)
    tnet = GrowableStereoNet.initial(gt, device="cpu",
                                     weights=torch_of(sp, ss, hp, hs))
    tnet.expand(1, gt, weights=torch_of(sp1, ss1, hp1, hs1))
    return jnet, tnet


class _JaxOpSearch(jgrowth.OpSearch):
    """rag_tpu's OpSearch with its steps compiled at XLA's lowest
    optimization level."""

    def _steps_for(self, arch, trainable):
        train, evaluate, optimizer = super()._steps_for(arch, trainable)
        return opt0(train), opt0(evaluate), optimizer


def _sel(lines):
    return [re.search(r"sel=(\[[^\]]*\])", m).group(1) for m in lines
            if "sel=" in m]


def _unit_trees(net, store="units"):
    return {f"{name}/{i}": (np_tree(u.params), np_tree(u.stats))
            for name, units in getattr(net, store).items()
            for i, u in enumerate(units)}


def test_op_search_one_epoch(monkeypatch):
    jnet, tnet = _expanded(monkeypatch)
    cfg = dict(epochs=1, batch=2, o_size=10, seed=4, maxdisp=MAXDISP)
    scene = ArrayScene(4, H, W, seed=15, style=2)
    before = {**_unit_trees(tnet), **_unit_trees(tnet, "heads")}
    log_j, log_t, rec_j, rec_t = [], [], Recorder(), Recorder()
    with _jax_in(np.float64):
        _JaxOpSearch(jnet, jgrowth.OpSearchConfig(**cfg),
                     log=log_j.append).search(1, scene, writer=rec_j)
    tgrowth.OpSearch(tnet, tgrowth.OpSearchConfig(**cfg),
                     log=log_t.append).search(1, scene.twin(), writer=rec_t)
    assert _sel(log_t) == _sel(log_j) and len(_sel(log_t)) == 1
    for pt, pj in zip(tnet.p, jnet.p):
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-12)
    (_, _, v_j), = rec_j.records
    (_, _, v_t), = rec_t.records
    assert v_t["n_new"] == v_j["n_new"]
    for k in ("valid_loss", "valid_d1"):
        assert abs(v_t[k] - v_j[k]) <= 1e-12 * max(1.0, abs(v_j[k])), k

    selected = eval(_sel(log_t)[0])
    trained = {s for i, s in enumerate(SITE_NAMES)
               if selected[i] == tnet.length(s) - 1} | set(HEAD_NAMES)
    after_t = {**_unit_trees(tnet), **_unit_trees(tnet, "heads")}
    after_j = {**_unit_trees(jnet), **_unit_trees(jnet, "heads")}
    lr = tgrowth.OpSearchConfig().lr   # epoch 0 of the cosine schedule
    for key, (p0, s0) in before.items():
        name, idx = key.split("/")
        assert_trees_equal(after_t[key][1], s0)   # every BatchNorm frozen
        new = int(idx) == (1 if name in HEAD_NAMES else tnet.length(name) - 1)
        if new and name in trained:
            assert_update_close(after_t[key][0], after_j[key][0], p0, lr)
        else:
            # reused units and unsampled new units do not move
            assert_trees_equal(after_t[key][0], p0)
            assert_trees_equal(after_j[key][0], p0)


def _scripted_eval(make, losses, calls):
    """Wrap an eval-step factory: every step's loss replaced by
    losses[epoch], the epoch read from calls (a list the train wrapper
    appends to once per train step)."""

    def factory(*a, **kw):
        step = make(*a, **kw)

        def run(*args):
            sc = step(*args)
            return {**sc, "loss": torch.tensor(losses[len(calls) - 1],
                                               dtype=sc["loss"].dtype)}

        return run

    return factory


def _recording_train(make, after):
    def factory(*a, **kw):
        step = make(*a, **kw)

        def run(*args):
            out = step(*args)
            after.append(np_tree(out[0]))
            return out

        return run

    return factory


def test_op_search_restores_best_epoch(monkeypatch):
    """Epoch 0 scripted best of two: the search ends on copies of epoch
    0's new units and heads."""
    _, tnet = _expanded(monkeypatch)
    after = []
    monkeypatch.setattr(tgrowth, "make_train_step",
                        _recording_train(tgrowth.make_train_step, after))
    monkeypatch.setattr(tgrowth, "make_eval_step",
                        _scripted_eval(tgrowth.make_eval_step, [1.0, 2.0],
                                       after))
    log = []
    search = tgrowth.OpSearch(tnet, tgrowth.OpSearchConfig(
        epochs=2, batch=2, maxdisp=MAXDISP), log=log.append)
    search.search(1, ArrayScene(4, H, W, seed=16).twin())
    assert len(after) == 2
    sels = [eval(s) for s in _sel(log)]
    for name, u in search._new_unit_refs(1):
        i = SITE_NAMES.index(name) if name in SITE_NAMES else None
        trained0 = i is None or sels[0][i] == tnet.length(name) - 1
        trained1 = i is None or sels[1][i] == tnet.length(name) - 1
        if trained0:
            assert_trees_equal(u.params, after[0][name])
        if trained1:
            moved = [not np.array_equal(a, b) for a, b in
                     zip(flat(np_tree(u.params)).values(),
                         flat(after[1][name]).values())]
            assert any(moved), name


def test_fine_tune_restores_best_epoch(monkeypatch):
    """Task 0's fine-tune, epoch 0 scripted best of two (one train and one
    valid batch an epoch): the net ends on copies of epoch 0's tensors."""
    _, tnet = _expanded(monkeypatch)
    after = []
    monkeypatch.setattr(tdriver, "make_train_step",
                        _recording_train(tdriver.make_train_step, after))
    monkeypatch.setattr(tdriver, "make_eval_step",
                        _scripted_eval(tdriver.make_eval_step, [1.0, 2.0],
                                       after))
    drv = tdriver.ContinualDriver(
        tdriver.ExperimentConfig(train=tdriver.TrainConfig(epochs=2, batch=2),
                                 num_tasks=2, maxdisp=MAXDISP),
        log=None, device="cpu")
    drv.net = tnet
    drv.fine_tune(0, ArrayScene(2, H, W, seed=17).twin(),
                  ArrayScene(2, H, W, seed=18).twin())
    assert len(after) == 2
    _, params, _ = tnet.path(tnet.archis[0])
    assert_trees_equal(params, after[0])
    assert any(not np.array_equal(a, b) for a, b in
               zip(flat(np_tree(params)).values(), flat(after[1]).values()))


def _scenes(n, torch_out=True):
    mk = lambda seed, t: ArrayScene(n, H, W, seed=seed, style=t,
                                    torch_out=torch_out)
    return ([mk(10 + t, t) for t in range(2)], [mk(20 + t, t) for t in range(2)],
            [mk(30 + t, t) for t in range(2)])


def _config(ns):
    return ns.ExperimentConfig(
        cell=ns.CellSearchConfig(epochs=2, batch=2, seed=0),
        op=ns.OpSearchConfig(epochs=2, batch=2, o_size=1, lr_a=0.5, seed=0),
        train=ns.TrainConfig(epochs=2, batch=2), num_tasks=2, seed=0,
        maxdisp=MAXDISP)


class _T:
    ExperimentConfig, TrainConfig = tdriver.ExperimentConfig, tdriver.TrainConfig
    CellSearchConfig, OpSearchConfig = (tmdenas.CellSearchConfig,
                                        tgrowth.OpSearchConfig)


class _J:
    ExperimentConfig, TrainConfig = jdriver.ExperimentConfig, jdriver.TrainConfig
    CellSearchConfig, OpSearchConfig = (jmdenas.CellSearchConfig,
                                        jgrowth.OpSearchConfig)


def test_two_task_run_port(tmp_path):
    """(h) The port's driver end to end on the CPU, float32 scenes."""
    cfg = dataclasses.replace(_config(_T), use_router=True, router_epochs=1,
                              router_batch=2)
    train, valid, test = _scenes(4)
    for group in (train, valid, test):
        for s in group:
            s.data = {k: v.astype(np.float32) for k, v in s.data.items()}
    drv = tdriver.ContinualDriver(cfg, log=None, checkpoint_dir=str(tmp_path),
                                  device="cpu")
    matrix = drv.run(train, valid, test)
    net = drv.net
    assert len(net.archis) == len(net.genotypes) == 2
    assert all(len(net.heads[h]) == 2 for h in HEAD_NAMES)
    for s in SITE_NAMES:
        assert 1 <= net.length(s) <= 2
        idx = net.archis[1][s]
        assert idx < net.length(s)
        assert net.model_to_train[s] == (
            [idx] if net.units[s][idx].born_task == 1 else [])
    for k in METRICS:
        assert matrix.m[k][1, 0] == matrix.m[k][0, 0], k
        assert np.isfinite(matrix.m[k][:, 0]).all() and matrix.m[k][1, 1] > 0
    assert sorted(os.listdir(tmp_path)) == [
        "arrays_task0.npz", "arrays_task1.npz", "genotype_t0.json",
        "genotype_t1.json", "manifest_task0.json", "manifest_task1.json",
        "router.npz"]
    jnet, manifest = jstate.load_checkpoint(str(tmp_path), 1)
    assert manifest["extra"]["stage"] == "task_done"
    assert manifest["extra"]["matrix"]["D1"] == matrix.m["D1"].tolist()
    assert jnet.archis == net.archis
    tnet, _ = tstate.load_checkpoint(str(tmp_path), 1, device="cpu")
    for s in SITE_NAMES:
        for a, b in zip(tnet.units[s], net.units[s]):
            assert_trees_equal(a.params, np_tree(b.params))
    assert drv.router.trained_task == 1
    assert tstate.load_router(str(tmp_path), device="cpu").trained_task == 1
    assert drv.router_eval["confusion"] and np.isfinite(
        drv.router_eval["routed_D1"]).all()


@pytest.mark.slow
def test_two_task_run_matches_rag_tpu(monkeypatch):
    """Both drivers, 2 tasks, float64, from equal initial weights."""
    cells = []

    class JaxCellSearch(jmdenas.CellSearch):
        @staticmethod
        def _init_net(key):
            out = np_tree(opt0(jax.jit(jsupernet.init_supernet))(key))
            cells.append(out)
            return out

    class JaxDriver(jdriver.ContinualDriver):
        def _cell_search_cls(self):
            return JaxCellSearch

    inits = Inits(monkeypatch)
    monkeypatch.setattr(jdriver, "OpSearch", _JaxOpSearch)
    train, valid, test = _scenes(4, torch_out=False)
    with _jax_in(np.float64):
        jdrv = JaxDriver(_config(_J), log=None)
        jm = jdrv.run(train, valid, test)

    draws = iter([tuple(to_torch(np_tree(t, np.float64), "cpu") for t in a + b)
                  for a, b in zip(inits.drawn[::2], inits.drawn[1::2])])

    class Driver(tdriver.ContinualDriver):
        def _cell_search(self, t):
            cs = super()._cell_search(t)
            cs.params, cs.stats = (to_torch(np_tree(x, np.float64), "cpu")
                                   for x in cells[t])
            cs.opt_state = cs.optimizer.init(cs.params)
            return cs

        def _grow(self, t, genotype):
            if t == 0:
                self.net = GrowableStereoNet.initial(genotype, device="cpu",
                                                     weights=next(draws))
            else:
                self.net.expand(t, genotype, weights=next(draws))

    tdrv = Driver(_config(_T), log=None, device="cpu")
    tm = tdrv.run(*(tuple(s.twin() for s in g) for g in (train, valid, test)))
    assert [(g.normal, g.reduce) for g in tdrv.net.genotypes] == \
        [(g.normal, g.reduce) for g in jdrv.net.genotypes]
    assert tdrv.net.archis == jdrv.net.archis
    assert tdrv.net.model_to_train == jdrv.net.model_to_train
    for k in METRICS:
        np.testing.assert_allclose(tm.m[k], jm.m[k], rtol=1e-9, atol=0,
                                   err_msg=k)


@pytest.mark.parametrize("n,seed,frac", [(32, 0, 0.5), (33, 1009, 0.5),
                                         (17, None, 0.5), (40, 7, 0.8)])
def test_split_half_matches(n, seed, frac):
    from rag_tpu.data.stereo_dataset import split_half as jsplit
    from rag_tpu_torch.data.stereo_dataset import split_half

    assert split_half(n, seed=seed, frac=frac) == jsplit(n, seed=seed,
                                                         frac=frac)


def test_forgetting_matrix_matches():
    from rag_tpu.metrics.meters import ForgettingMatrix as JMatrix
    from rag_tpu_torch.metrics.meters import ForgettingMatrix

    rng = np.random.default_rng(0)
    mj, mt = JMatrix(3, METRICS), ForgettingMatrix(3, METRICS)
    for t in range(3):
        for u in range(t + 1):
            row = {k: float(v) for k, v in zip(METRICS, rng.uniform(0, 2, 6))}
            mj.record(t, u, row)
            mt.record(t, u, row)
    for k in METRICS:
        np.testing.assert_array_equal(mt.m[k], mj.m[k])
        assert mt.mean_final(k) == mj.mean_final(k)
        assert mt.mean_final(k, upto=1) == mj.mean_final(k, upto=1)
        assert mt.forgetting(k) == mj.forgetting(k)
        assert mt.format(k, 100.0) == mj.format(k, 100.0)
    assert mt.to_json() == mj.to_json()


def test_metric_writer_records(tmp_path):
    import json

    from rag_tpu.utils.logging import MetricWriter as JWriter
    from rag_tpu_torch.utils.logging import MetricWriter

    records = []
    for cls, d in ((JWriter, tmp_path / "jax"), (MetricWriter, tmp_path / "port")):
        w = cls(str(d))
        w.scalars("search_op/task1", {"valid_loss": np.float64(1.5),
                                      "n_new": 3}, step=2)
        w.text("archi/task1", "{'stem_2d0': 0}", step=1)
        w.close()
        with open(d / "events.jsonl") as f:
            lines = [json.loads(line) for line in f]
        for rec in lines:
            assert isinstance(rec.pop("ts"), float)
        records.append(lines)
    assert records[1] == records[0] and len(records[0]) == 2
