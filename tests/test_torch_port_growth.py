"""Growth of the registry and checkpoint writes against the JAX package,
on the CPU.

(c) ``GrowableStereoNet.expand`` sets the same reuse prior p as rag_tpu's
    (after task 0: [2/3, 1/3]; where a site kept a new unit: [2/5, 2/5,
    1/5]); ``select`` makes the same picks, archis, model_to_train, lengths
    and birth tasks for all-reuse, all-new and mixed p, and the units that
    stay hold bit-identical tensors. Both registries start from rag_tpu's
    initial weights (through ``to_torch``).
(d) ``num_params`` / ``size_m`` of every task of the committed
    ``logs/canonical_learn_r4`` equal rag_tpu's.
(e) a checkpoint written by the port loads in rag_tpu with bit-equal
    leaves, and rag_tpu writing the loaded net gives the same manifest and
    the same npz keys, dtypes, shapes and bytes; the reverse holds through
    the port's reader; ``manifest_only`` rewrites the manifest alone.
"""

import dataclasses
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from learn_parity import Inits, assert_trees_equal, np_tree
from rag_tpu.continual import state as jstate
from rag_tpu.models import growable as jgrowable
from rag_tpu.search import genotype as jgenotype
from rag_tpu_torch.continual import state as tstate
from rag_tpu_torch.models.growable import GrowableStereoNet
from rag_tpu_torch.models.stereo import SITE_NAMES
from rag_tpu_torch.search import genotype as tgenotype

ROOT = Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "logs" / "canonical_learn_r4")
GENE = ((0, 1), (1, 0), (2, 1), (3, 1), (5, 0), (6, 1))

def _same_spec(a, b):
    return (type(a).__name__ == type(b).__name__
            and dataclasses.asdict(a) == dataclasses.asdict(b))


def _genos():
    return (jgenotype.Genotype(normal=GENE, reduce=GENE),
            tgenotype.Genotype(normal=GENE, reduce=GENE))


def _pair(monkeypatch):
    """(rag_tpu net, port net) of task 0, expanded for task 1, from the
    same rag_tpu weights."""
    inits = Inits(monkeypatch)
    gj, gt = _genos()
    jnet = jgrowable.GrowableStereoNet(jax.random.PRNGKey(0), gj)
    tnet = GrowableStereoNet.initial(gt, device="cpu",
                                     weights=inits.last_two())
    jnet.expand(jax.random.PRNGKey(1), 1, gj)
    tnet.expand(1, gt, weights=inits.last_two())
    return jnet, tnet, inits


def _assert_registries_equal(jnet, tnet):
    assert tnet.archis == jnet.archis
    assert tnet.model_to_train == jnet.model_to_train
    for s in SITE_NAMES:
        assert tnet.length(s) == jnet.length(s)
        for uj, ut in zip(jnet.units[s], tnet.units[s]):
            assert ut.born_task == uj.born_task and _same_spec(ut.spec, uj.spec)
            assert_trees_equal(ut.params, np_tree(uj.params))
            assert_trees_equal(ut.stats, np_tree(uj.stats))
    for h in jnet.heads:
        assert len(tnet.heads[h]) == len(jnet.heads[h])


_PICKS = {"reuse": lambda i: 0, "new": lambda i: 1, "mixed": lambda i: i % 2}


@pytest.mark.parametrize("pick", sorted(_PICKS))
def test_expand_prior_and_select(monkeypatch, pick):
    jnet, tnet, inits = _pair(monkeypatch)
    assert len(tnet.p) == len(jnet.p) == len(SITE_NAMES)
    for pt, pj in zip(tnet.p, jnet.p):
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(pt, [2 / 3, 1 / 3])
    assert tnet.new_models == jnet.new_models
    _assert_registries_equal(jnet, tnet)
    before = {s: [np_tree(u.params) for u in tnet.units[s]] for s in SITE_NAMES}

    for i in range(len(SITE_NAMES)):
        p = np.array([0.2, 0.8] if _PICKS[pick](i) else [0.8, 0.2])
        jnet.p[i], tnet.p[i] = p, p.copy()
    assert tnet.select(1) == jnet.select(1)
    assert tnet.p is None and tnet.new_models is None
    _assert_registries_equal(jnet, tnet)
    for i, s in enumerate(SITE_NAMES):
        new = _PICKS[pick](i) == 1
        assert tnet.archis[1][s] == (1 if new else 0)
        assert tnet.model_to_train[s] == ([1] if new else [])
        assert tnet.length(s) == (2 if new else 1)
        for u, p0 in zip(tnet.units[s], before[s]):
            assert_trees_equal(u.params, p0)
    assert tnet.trainable_sites(1) == jnet.trainable_sites(1)

    gj, gt = _genos()
    jnet.expand(jax.random.PRNGKey(2), 2, gj)
    tnet.expand(2, gt, weights=inits.last_two())
    for pt, pj, s in zip(tnet.p, jnet.p, SITE_NAMES):
        np.testing.assert_array_equal(pt, pj)
        n = tnet.length(s) - 1
        assert len(pt) == n + 1 and pt[-1] == 1.0 / (2 * n + 1)
    _assert_registries_equal(jnet, tnet)


@pytest.mark.parametrize("task", [0, 1, 2, 3])
def test_num_params_committed_checkpoint(task):
    jnet = jstate.load_checkpoint(CKPT, task)[0]
    tnet = tstate.load_checkpoint(CKPT, task, device="cpu")[0]
    assert tnet.num_params() == jnet.num_params()
    assert tnet.size_m() == jnet.size_m()


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_files(dir_a, dir_b, task):
    with open(os.path.join(dir_a, f"manifest_task{task}.json")) as f:
        ma = json.load(f)
    with open(os.path.join(dir_b, f"manifest_task{task}.json")) as f:
        mb = json.load(f)
    assert ma == mb
    za = _npz(os.path.join(dir_a, f"arrays_task{task}.npz"))
    zb = _npz(os.path.join(dir_b, f"arrays_task{task}.npz"))
    assert sorted(za) == sorted(zb)
    for k in za:
        assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def _assert_nets_equal(jnet, tnet):
    assert tnet.archis == jnet.archis
    assert tnet.model_to_train == jnet.model_to_train
    assert [(g.normal, g.reduce) for g in tnet.genotypes] == \
        [(g.normal, g.reduce) for g in jnet.genotypes]
    if jnet.p is None:
        assert tnet.p is None
    else:
        for pt, pj in zip(tnet.p, jnet.p):
            np.testing.assert_array_equal(pt, pj)
    for store in ("units", "heads"):
        for name, units in getattr(jnet, store).items():
            tunits = getattr(tnet, store)[name]
            assert len(tunits) == len(units)
            for uj, ut in zip(units, tunits):
                assert ut.born_task == uj.born_task and _same_spec(ut.spec, uj.spec)
                for a, b in ((ut.params, uj.params), (ut.stats, uj.stats)):
                    assert_trees_equal(a, np_tree(b))
                    for leaf in jax.tree_util.tree_leaves(np_tree(a)):
                        assert leaf.dtype == np.float32


def _net(kind, monkeypatch):
    """(rag_tpu net, port net) holding equal tensors: the committed task-3
    checkpoint, or a fresh task-0 net expanded for task 1 (p set)."""
    if kind == "committed":
        return (jstate.load_checkpoint(CKPT, 3)[0],
                tstate.load_checkpoint(CKPT, 3, device="cpu")[0])
    jnet, tnet, _ = _pair(monkeypatch)
    return jnet, tnet


EXTRA = {"stage": "trained", "matrix": {"D1": [[0.5, 0.0], [0.25, 0.75]]}}


@pytest.mark.parametrize("kind", ["committed", "expanded"])
def test_port_checkpoint_read_by_rag_tpu(tmp_path, monkeypatch, kind):
    jnet, tnet = _net(kind, monkeypatch)
    task = len(tnet.archis) - 1
    tstate.save_checkpoint(str(tmp_path / "port"), tnet, task, extra=EXTRA)
    jback, manifest = jstate.load_checkpoint(str(tmp_path / "port"), task)
    assert manifest["extra"] == EXTRA and manifest["variant"] == "stereo"
    _assert_nets_equal(jback, tnet)
    jstate.save_checkpoint(str(tmp_path / "jax"), jback, task, extra=EXTRA)
    _assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"), task)
    # and the port reads its own file back
    tback, _ = tstate.load_checkpoint(str(tmp_path / "port"), task,
                                      device="cpu")
    _assert_nets_equal(jnet, tback)


@pytest.mark.parametrize("kind", ["committed", "expanded"])
def test_rag_tpu_checkpoint_read_by_port(tmp_path, monkeypatch, kind):
    jnet, tnet = _net(kind, monkeypatch)
    task = len(jnet.archis) - 1
    jstate.save_checkpoint(str(tmp_path / "jax"), jnet, task, extra=EXTRA)
    tback, manifest = tstate.load_checkpoint(str(tmp_path / "jax"), task,
                                             device="cpu")
    assert manifest["extra"] == EXTRA
    _assert_nets_equal(jnet, tback)
    tstate.save_checkpoint(str(tmp_path / "port"), tback, task, extra=EXTRA)
    _assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"), task)


def test_manifest_only_save(tmp_path):
    tnet = tstate.load_checkpoint(CKPT, 3, device="cpu")[0]
    d = str(tmp_path)
    with pytest.raises(FileNotFoundError):
        tstate.save_checkpoint(d, tnet, 3, extra=EXTRA, manifest_only=True)
    tstate.save_checkpoint(d, tnet, 3, extra={"stage": "selected"})
    arrays = os.path.join(d, "arrays_task3.npz")
    stamp = os.stat(arrays).st_mtime_ns, _npz(arrays)
    tstate.save_checkpoint(d, tnet, 3, extra=EXTRA, manifest_only=True)
    assert os.stat(arrays).st_mtime_ns == stamp[0]
    _, manifest = jstate.load_checkpoint(d, 3)
    assert manifest["extra"] == EXTRA
    assert sorted(os.listdir(d)) == ["arrays_task3.npz", "manifest_task3.json"]
