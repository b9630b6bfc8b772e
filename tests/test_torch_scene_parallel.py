"""The scene-parallel cell search of the port (rag_tpu_torch.search.
scene_parallel) on the CPU, where the scenes take their rounds in turn.

(a) Two scenes (float64 styled scenes of 4 pairs, 24x48, batch 2, maxdisp
    24, two epochs, from the port's own initial supernets in float64)
    against two sequential ``CellSearch`` runs with the same seeds and
    tasks: the same sampled ops, genotypes equal, p within 1e-12, every
    scene's params within 1e-9 of each leaf's largest value.
(b) (``-m slow``: its shard_map compile takes ~60 s) against rag_tpu's
    ``SceneParallelCellSearch`` over ``make_scene_mesh(2)`` of the fake
    CPU devices from the same float64 weights: genotypes equal, p within
    1e-12.
(c) The driver's ``parallel_cell_search`` hands ``search_cell`` the
    sequential searches' genotypes (tests/test_scene_parallel.py:82's
    check), writes them as ``genotype_t{t}.json`` stage files that a new
    driver reads instead of searching, and does nothing where every task
    has its genotype.
(d) With ``search_cls=DepthCellSearch`` (the depth driver's search),
    two depth scenes' searches at once equal two sequential
    ``DepthCellSearch`` runs (genotypes, p).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from learn_parity import ArrayScene, np_tree, opt0
from rag_tpu_torch.continual.depth_driver import SyntheticDepthDataset
from rag_tpu_torch.continual.driver import ContinualDriver, ExperimentConfig
from rag_tpu_torch.data.synthetic import SyntheticStereoDataset
from rag_tpu_torch.models.supernet import init_supernet
from rag_tpu_torch.search.mdenas import (
    CellSearch,
    CellSearchConfig,
    DepthCellSearch,
)
from rag_tpu_torch.search.scene_parallel import (
    SceneParallelCellSearch,
    scene_devices,
)

H, W, MAXDISP = 24, 48, 24
CFG = CellSearchConfig(epochs=2, batch=2, seed=0, maxdisp=MAXDISP)
SEEDS = (0, 1)


def _f64(tree):
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    return tree.to(torch.float64)


def _weights(seed):
    return tuple(_f64(t) for t in init_supernet(
        torch.Generator().manual_seed(seed), "cpu"))


def _scenes():
    return [ArrayScene(4, H, W, seed=40 + t, style=t, max_disp=16.0,
                       torch_out=True) for t in range(2)]


def _record(cs, out):
    step = cs._train_step

    def run(*a):
        out.append((np.asarray(a[-2]).copy(), np.asarray(a[-1]).copy()))
        return step(*a)

    cs._train_step = run


@pytest.fixture(scope="module")
def runs():
    scenes = _scenes()
    seq = []
    for t, seed in enumerate(SEEDS):
        cs = CellSearch(dataclasses.replace(CFG, seed=seed), log=None,
                        device="cpu", weights=_weights(seed))
        ops = []
        _record(cs, ops)
        seq.append((cs.search(scenes[t], task=t), cs, ops))
    sp = SceneParallelCellSearch(CFG, 2, log=None, scene_seeds=SEEDS,
                                 device="cpu",
                                 weights=[_weights(s) for s in SEEDS])
    par_ops = [[], []]
    for cs, ops in zip(sp.searches, par_ops):
        _record(cs, ops)
    return seq, sp, sp.search(scenes), par_ops


def test_same_ops_and_genotypes(runs):
    seq, _, genos, par_ops = runs
    for t, (geno, _, ops) in enumerate(seq):
        assert genos[t] == geno, t
        assert len(par_ops[t]) == len(ops) == 2
        for (fa, ma), (fb, mb) in zip(par_ops[t], ops):
            np.testing.assert_array_equal(fa, fb)
            np.testing.assert_array_equal(ma, mb)


def test_same_p(runs):
    seq, sp, _, _ = runs
    for t, (_, cs, _) in enumerate(seq):
        for k in cs.p:
            np.testing.assert_allclose(sp.p[k][t], cs.p[k], rtol=0,
                                       atol=1e-12)


def test_same_params(runs):
    seq, sp, _, _ = runs
    for t, (_, cs, _) in enumerate(seq):
        a, b = np_tree(sp.params[t]), np_tree(cs.params)
        for leaf_a, leaf_b in zip(jax.tree_util.tree_leaves(a),
                                  jax.tree_util.tree_leaves(b)):
            tol = 1e-9 * max(float(np.abs(leaf_b).max()), 1e-300)
            assert float(np.abs(leaf_a - leaf_b).max()) <= tol


def test_depth_search_class():
    cfg = dataclasses.replace(CFG, epochs=1)
    scenes = [SyntheticDepthDataset(4, H, W, seed=50 + t, device="cpu")
              for t in range(2)]
    seq = [DepthCellSearch(dataclasses.replace(cfg, seed=s), log=None,
                           device="cpu") for s in SEEDS]
    genos = [cs.search(scenes[t], task=t) for t, cs in enumerate(seq)]
    sp = SceneParallelCellSearch(cfg, 2, log=None, scene_seeds=SEEDS,
                                 device="cpu", search_cls=DepthCellSearch)
    assert sp.search(scenes) == genos
    for t, cs in enumerate(seq):
        for k in cs.p:
            np.testing.assert_allclose(sp.p[k][t], cs.p[k], rtol=0,
                                       atol=1e-12)


def test_scene_devices_on_the_cpu():
    assert scene_devices(3, "cpu") == [torch.device("cpu")] * 3


@pytest.mark.slow
def test_against_rag_tpu_scene_parallel(runs, monkeypatch):
    from rag_tpu.search import mdenas as jmdenas
    from rag_tpu.search import scene_parallel as jsp
    from test_torch_port_train_slice import _jax_in

    _, sp, genos, _ = runs
    inits = {s: tuple(np_tree(t) for t in _weights(s)) for s in SEEDS}
    monkeypatch.setattr(jsp, "init_supernet",
                        lambda key: inits[int(jax.random.key_data(key)[-1])])
    scenes = [s.twin() for s in _scenes()]
    with _jax_in(np.float64):
        jcfg = jmdenas.CellSearchConfig(**dataclasses.asdict(CFG))
        jp = jsp.SceneParallelCellSearch(jcfg, 2, mesh=jsp.make_scene_mesh(2),
                                         log=None, scene_seeds=SEEDS)
        jp._train_step, jp._eval_step = (opt0(jp._train_step),
                                         opt0(jp._eval_step))
        jgenos = jp.search(scenes)
    for t in range(2):
        assert (genos[t].normal, genos[t].reduce) == (jgenos[t].normal,
                                                      jgenos[t].reduce)
        for k in ("normal", "reduce"):
            np.testing.assert_allclose(sp.p[k][t], jp.p[k][t], rtol=0,
                                       atol=1e-12)


def _driver(tmp_path=None, **kw):
    cfg = ExperimentConfig(cell=CFG, num_tasks=2, maxdisp=MAXDISP,
                           scene_parallel_search=True, **kw)
    return ContinualDriver(cfg, log=None, device="cpu",
                           checkpoint_dir=tmp_path)


def test_driver_hands_search_cell_the_sequential_genotypes(tmp_path):
    scenes = [SyntheticStereoDataset(4, H, W, seed=40 + t, max_disp=16.0,
                                     device="cpu") for t in range(2)]
    drv = _driver(tmp_path)
    drv.parallel_cell_search(scenes)
    assert set(drv._pre_genotypes) == {0, 1}
    par = [drv.search_cell(t, scenes[t]) for t in range(2)]
    seq = [CellSearch(dataclasses.replace(CFG, seed=CFG.seed + t), log=None,
                      device="cpu").search(scenes[t], task=t)
           for t in range(2)]
    assert par == seq
    # the stage files: a new driver reads them instead of searching
    fresh = _driver(tmp_path)
    assert all(fresh._have_genotype(t) for t in range(2))
    fresh.parallel_cell_search(None)    # nothing to do: no data touched
    assert fresh._pre_genotypes == {}
    assert [fresh.search_cell(t, None) for t in range(2)] == seq


def test_rag_tpu_depth_scene_parallel_raises(monkeypatch):
    """A reference behaviour, pinned: rag_tpu's parallel_cell_search runs
    the stereo SceneParallelCellSearch whatever the driver, so the depth
    driver's raises on the depth scenes' batches (no "left"); the port's
    runs the driver's own search class (test_depth_search_class). The
    supernets start from the port's weights (rag_tpu's eager init
    compiles for tens of seconds)."""
    from rag_tpu.continual.depth_driver import (
        DepthContinualDriver as JDepthDriver,
        SyntheticDepthDataset as JDepthDataset,
    )
    from rag_tpu.continual.driver import ExperimentConfig as JConfig
    from rag_tpu.search import scene_parallel as jsp
    from rag_tpu.search.mdenas import CellSearchConfig as JCellConfig

    weights = tuple(np_tree(t) for t in _weights(0))
    monkeypatch.setattr(jsp, "init_supernet", lambda key: weights)

    drv = JDepthDriver(JConfig(cell=JCellConfig(epochs=1, batch=2),
                               num_tasks=2, scene_parallel_search=True),
                       log=None)
    with pytest.raises(KeyError, match="left"):
        drv.parallel_cell_search([JDepthDataset(4, H, W, seed=t)
                                  for t in range(2)])
