"""The search supernet and MdeNAS against the JAX package, on the CPU.

(a) ``rag_tpu_torch.models.supernet``: ``init_supernet``'s tree has
    rag_tpu's keys and shapes; with rag_tpu's initial weights (cast to
    float64, through ``rag_tpu_torch.convert.to_torch``) the forward in
    train and eval mode gives the disparity within 1e-9 of max |disp| and
    the new BatchNorm statistics within 1e-12 of max(1, |stat|), for an
    all-skip, an all-conv and a random op vector, against rag_tpu's
    channels-last layout (its CPU default) and, for the random vector, its
    channel-first one; one supernet train step (``CellSearch``'s, in (f))
    gives dp/lr within 1e-9 of each leaf's largest |dp/lr| and the new
    statistics within 1e-12.
(b) ``mdenas_update`` and ``parse_genotype`` equal rag_tpu's bit for bit
    on random inputs.
(f) one ``CellSearch`` epoch with injected weights: the same sampled ops,
    the same p within 1e-12, the same valid loss and quality, and the
    params it keeps within the step bound.
(g) ``CellSearch`` keeps the best-by-valid-loss epoch's params: a run
    whose best epoch is not the last restores copies of that epoch's
    tensors (the port's train step updates params in place).

Float64 throughout (rag_tpu with x64 on and its float32 policy pointed at
float64, as in tests/test_torch_port_train_slice.py): the reference's
float32 train-mode BatchNorm statistics are too noisy for a tighter
float32 comparison. B = 2, 24x48, maxdisp 48 (cost volume D = 16).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from learn_parity import (
    ArrayScene,
    Recorder,
    assert_stats_close,
    assert_trees_equal,
    assert_update_close,
    np_tree,
    opt0,
    shapes,
)
from rag_tpu.models import supernet as jsupernet
from rag_tpu.search import genotype as jgenotype
from rag_tpu.search import mdenas as jmdenas
from rag_tpu_torch.convert import to_torch
from rag_tpu_torch.models import supernet as tsupernet
from rag_tpu_torch.search import genotype as tgenotype
from rag_tpu_torch.search import mdenas as tmdenas
from test_torch_port_train_slice import _jax_in

B, H, W, MAXDISP = 2, 24, 48, 48


@pytest.fixture(scope="module")
def weights():
    """rag_tpu's initial supernet (seed 0) as float64 numpy trees."""
    p, s = opt0(jax.jit(jsupernet.init_supernet))(jax.random.PRNGKey(0))
    return np_tree(p, np.float64), np_tree(s, np.float64)


def _batch(seed):
    rng = np.random.default_rng(seed)
    left = rng.standard_normal((B, H, W, 3))
    right = rng.standard_normal((B, H, W, 3))
    gt = rng.uniform(-5.0, MAXDISP + 10.0, (B, H, W))
    return left, right, gt


def test_init_supernet_keys_and_shapes():
    pj, sj = jax.eval_shape(jsupernet.init_supernet, jax.random.PRNGKey(0))
    pt, st = tsupernet.init_supernet(torch.Generator().manual_seed(0), "cpu")
    assert shapes(pt) == shapes(pj)
    assert shapes(st) == shapes(sj)
    for leaf in jax.tree_util.tree_leaves(np_tree(pt)):
        assert leaf.dtype == np.float32
    # kaiming fan-out conv weights, BatchNorm at identity
    w = pt["mat"]["cell4"]["edges"]["3"]["w"]
    assert abs(float(w.std()) - np.sqrt(2.0 / (27 * 16))) < 0.01
    assert torch.equal(pt["mat"]["cell4"]["edges"]["3"]["scale"],
                       torch.ones(16))
    assert torch.equal(st["mat"]["cell4"]["edges"]["3"]["var"], torch.ones(16))
    assert not st["fea"]["last_3"]


_OPS = {"skip": np.zeros(9, np.int32), "conv": np.ones(9, np.int32),
        "random": np.random.default_rng(5).integers(0, 2, 9).astype(np.int32)}


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("ops", sorted(_OPS))
def test_supernet_forward(weights, ops, train):
    _forward_case(weights, _OPS[ops], train, cf=False)


def test_supernet_forward_channel_first_reference(weights):
    """rag_tpu's channel-first layout (its TPU path) gives the same."""
    _forward_case(weights, _OPS["random"], True, cf=True)


# rag_tpu's forward, compiled once per (train, cf): the ops are traced, as
# in its CellSearch
_FWD = {}


def _forward_case(weights, fea_ops, train, cf):
    params, stats = weights
    mat_ops = fea_ops[::-1].copy()
    left, right, _ = _batch(1)
    with _jax_in(np.float64):
        if (train, cf) not in _FWD:
            _FWD[train, cf] = opt0(jax.jit(functools.partial(
                jsupernet.supernet_forward, train=train, cf_matching=cf,
                maxdisp=MAXDISP)))
        dj, nsj = _FWD[train, cf](params, stats, left, right, fea_ops, mat_ops)
        dj, nsj = np.asarray(dj), np_tree(nsj)
    dt, nst = tsupernet.supernet_forward(
        to_torch(params, "cpu"), to_torch(stats, "cpu"),
        torch.from_numpy(left), torch.from_numpy(right), fea_ops, mat_ops,
        train, maxdisp=MAXDISP)
    assert dt.dtype == torch.float64 and dt.shape == (B, H, W)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0,
                               atol=1e-9 * float(np.abs(dj).max()))
    assert_stats_close(nst, nsj)
    if not train:
        assert_trees_equal(nst, stats)


def _cfg(**kw):
    return jmdenas.CellSearchConfig(batch=B, maxdisp=MAXDISP, **kw)


def _tcfg(cfg):
    return tmdenas.CellSearchConfig(**dataclasses.asdict(cfg))


def _jax_search(cfg, weights):
    """rag_tpu's CellSearch on the given float64 weights (call inside
    _jax_in(np.float64))."""

    class Injected(jmdenas.CellSearch):
        @staticmethod
        def _init_net(key):
            return weights

    cs = Injected(cfg, log=None)
    cs._train_step, cs._eval_step = opt0(cs._train_step), opt0(cs._eval_step)
    return cs


def _torch_search(cfg, weights, **kw):
    return tmdenas.CellSearch(_tcfg(cfg), log=None, device="cpu",
                              weights=(to_torch(weights[0], "cpu"),
                                       to_torch(weights[1], "cpu")), **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mdenas_update_bitwise(seed):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(2), size=9)
    h_e = rng.integers(0, 5, (9, 2))
    # ties in h_e and h_a exercise the strict comparisons
    h_a = np.round(rng.uniform(0, 1, (9, 2)), 1)
    for lr_a in (0.01, 0.5):
        np.testing.assert_array_equal(
            tmdenas.mdenas_update(p, h_e, h_a, lr_a),
            jmdenas.mdenas_update(p, h_e, h_a, lr_a))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_parse_genotype_matches(seed):
    rng = np.random.default_rng(seed)
    p_n, p_r = rng.dirichlet(np.ones(2), size=9), rng.dirichlet(np.ones(2), size=9)
    gj = jgenotype.parse_genotype(p_n, p_r)
    gt = tgenotype.parse_genotype(p_n, p_r)
    assert (gt.normal, gt.reduce) == (gj.normal, gj.reduce)


def _record_ops(cs, out):
    """Wrap cs._train_step to keep each step's (fea_ops, mat_ops)."""
    step = cs._train_step

    def run(*a):
        out.append((np.asarray(a[-2]).copy(), np.asarray(a[-1]).copy()))
        return step(*a)

    cs._train_step = run


def test_cell_search_one_epoch(weights):
    """(a), (f) One epoch of CellSearch.search on a 4-pair styled scene, 2
    train pairs (one supernet train step: every BatchNorm in train mode,
    SGD on every leaf, unsampled edges moved by weight decay alone) and 2
    valid pairs, task 1 (host stream seed cfg.seed + 1000)."""
    cfg = _cfg(epochs=1, seed=3)
    scene = ArrayScene(4, H, W, seed=11, style=1)
    rec_j, rec_t = Recorder(), Recorder()
    ops_j, ops_t = [], []
    with _jax_in(np.float64):
        cs = _jax_search(cfg, weights)
        _record_ops(cs, ops_j)
        geno_j = cs.search(scene, writer=rec_j, task=1)
        p_j, params_j, stats_j = cs.p, np_tree(cs.params), np_tree(cs.stats)
    ts = _torch_search(cfg, weights)
    _record_ops(ts, ops_t)
    geno_t = ts.search(scene.twin(), writer=rec_t, task=1)
    assert len(ops_t) == len(ops_j) == 1
    for (fj, mj), (ft, mt) in zip(ops_j, ops_t):
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(mt, mj)
    for k in p_j:
        np.testing.assert_allclose(ts.p[k], p_j[k], rtol=0, atol=1e-12)
    assert (geno_t.normal, geno_t.reduce) == (geno_j.normal, geno_j.reduce)
    (tag_j, _, v_j), = rec_j.records
    (tag_t, _, v_t), = rec_t.records
    assert tag_t == tag_j == "search_cell/task1"
    for k in v_j:
        assert abs(v_t[k] - v_j[k]) <= 1e-12 * max(1.0, abs(v_j[k])), k
    assert_update_close(ts.params, params_j, weights[0], cfg.lr)
    assert_stats_close(ts.stats, stats_j)


def test_cell_search_restores_best_epoch(weights):
    """(g) Two epochs whose scripted valid losses make epoch 0 the best:
    the search ends on copies of epoch 0's params, not the last ones,
    and on epoch 0's p."""
    cfg = _cfg(epochs=2, seed=0)
    scene = ArrayScene(4, H, W, seed=12).twin()
    ts = _torch_search(cfg, weights)
    after, ps = [], []
    step, evaluate = ts._train_step, ts._eval_step

    def train(*a):
        out = step(*a)
        after.append(np_tree(out[0]))
        return out

    def scripted(*a):
        sc = evaluate(*a)
        epoch = len(after) - 1
        ps.append({k: v.copy() for k, v in ts.p.items()})
        return {**sc, "loss": torch.tensor([1.0, 2.0][epoch], dtype=torch.float64)}

    ts._train_step, ts._eval_step = train, scripted
    ts.search(scene, task=0)
    assert len(after) == 2
    assert_trees_equal(ts.params, after[0])
    last = np_tree(ts.params)
    assert any(not np.array_equal(a, b) for a, b in
               zip(jax.tree_util.tree_leaves(last),
                   jax.tree_util.tree_leaves(after[1])))
    # the best p is the one after epoch 0's update (ps[1] was read during
    # epoch 1's evaluation, before its update)
    for k in ts.p:
        np.testing.assert_array_equal(ts.p[k], ps[1][k])
