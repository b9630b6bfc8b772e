"""Stage files and resume of the port's continual path, on the CPU.

(a) Port only, at 24x48 (float32 scenes): a 2-task ``ContinualDriver.run``
    killed inside a stage, right after a stage file's write (an exception
    from its ``log`` callback, as a kill would stop it), then
    ``run(resume=True)`` from its checkpoint directory, ends on the same
    forgetting matrix and network, bit for bit, as the run never killed:
    killed in task 1's cell search, its op search, task 0's fine-tune and
    task 1's fine-tune. The searches' own fault injection (``stop_after``)
    then ``resume=True`` equals an uninterrupted search bit for bit too.
(b) Each package reads the other's ``cellsearch_t{t}.npz``,
    ``opsearch_t{t}.npz`` and ``finetune_t{t}.npz``: every leaf, p, h_e,
    h_a, the best snapshots and the numpy Generator's state bit-equal,
    with distinct random values in every leaf so that a leaf read into
    another's place shows. rag_tpu's trees here are its own structures
    (``jax.eval_shape`` of its initializers, its checkpoint reader, its
    optax state); nothing compiles a JAX step.
(c) Resume at a "trained" checkpoint runs only the evaluations its row
    lacks; a router saved before the last finished task is trained again,
    a current one is not.
(d) The cost volume's backward is deterministic: its gather's adjoint sums
    in a fixed order (autograd's accumulating ``index_put_`` made two equal
    cell searches differ in their last bits on a multi-threaded CPU), and
    gradcheck holds it against finite differences.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from learn_parity import ArrayScene, assert_trees_equal, flat, np_tree
from rag_tpu.continual import driver as jdriver
from rag_tpu.continual import state as jstate
from rag_tpu.models import supernet as jsupernet
from rag_tpu.search import growth as jgrowth
from rag_tpu.search import mdenas as jmdenas
from rag_tpu.train import trainer as jtrainer
from rag_tpu_torch.continual import driver as tdriver
from rag_tpu_torch.continual import state as tstate
from rag_tpu_torch.models.growable import GrowableStereoNet
from rag_tpu_torch.models.router import SceneRouter
from rag_tpu_torch.ops.cost_volume import cost_volume_cf
from rag_tpu_torch.search import growth as tgrowth
from rag_tpu_torch.search import mdenas as tmdenas
from rag_tpu_torch.search.genotype import Genotype, default_genotype

H, W, MAXDISP = 24, 48, 48
GENE = ((0, 1), (1, 1), (2, 0), (3, 1), (5, 1), (6, 0))
METRICS = ("D1", "EPE", "loss", "Thres1", "Thres2", "Thres3")


def _scenes(n=4, tasks=2):
    def mk(seed, t):
        s = ArrayScene(n, H, W, seed=seed, style=t, torch_out=True)
        s.data = {k: v.astype(np.float32) for k, v in s.data.items()}
        return s
    return ([mk(10 + t, t) for t in range(tasks)],
            [mk(20 + t, t) for t in range(tasks)],
            [mk(30 + t, t) for t in range(tasks)])


def _config(**kw):
    return tdriver.ExperimentConfig(
        cell=tmdenas.CellSearchConfig(epochs=2, batch=2, seed=0),
        op=tgrowth.OpSearchConfig(epochs=2, batch=2, o_size=1, lr_a=0.5,
                                  seed=0),
        train=tdriver.TrainConfig(epochs=3, batch=2), num_tasks=2, seed=0,
        maxdisp=MAXDISP, **kw)


class Killed(Exception):
    pass


def _run(ckpt, kill_at=None, resume=False, lines=None):
    """One port driver run into ``ckpt`` (stage files every epoch); raises
    Killed from the log callback at the first line starting ``kill_at``."""
    def log(msg):
        if lines is not None:
            lines.append(msg)
        if kill_at is not None and str(msg).startswith(kill_at):
            raise Killed(msg)

    drv = tdriver.ContinualDriver(_config(), log=log, checkpoint_dir=str(ckpt),
                                  device="cpu")
    drv.stage_checkpoint_every = 1
    matrix = drv.run(*_scenes(), resume=resume)
    return drv, matrix


def _net_trees(net):
    return {f"{kind}/{name}/{i}/{part}": np_tree(getattr(u, part))
            for kind in ("units", "heads")
            for name, units in getattr(net, kind).items()
            for i, u in enumerate(units) for part in ("params", "stats")}


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    drv, matrix = _run(tmp_path_factory.mktemp("whole"))
    return drv.net, {k: matrix.m[k].copy() for k in METRICS}


@pytest.mark.parametrize("kill_at,stage_file,epoch", [
    ("[cell-search t1] epoch 1 ", "cellsearch_t1.npz", 0),
    ("[op-search t1] epoch 1 ", "opsearch_t1.npz", 0),
    ("[train t0] epoch 1 ", "finetune_t0.npz", 0),
    ("[train t1] epoch 2 ", "finetune_t1.npz", 1),
])
def test_killed_and_resumed_run_equals_uninterrupted(tmp_path, uninterrupted,
                                                     kill_at, stage_file,
                                                     epoch):
    with pytest.raises(Killed):
        _run(tmp_path, kill_at=kill_at)
    with np.load(tmp_path / stage_file) as f:
        assert int(f["epoch"]) == epoch
    lines = []
    drv, matrix = _run(tmp_path, resume=True, lines=lines)
    assert any("resumed at epoch" in str(m) for m in lines)
    net, m = uninterrupted
    for k in METRICS:
        np.testing.assert_array_equal(matrix.m[k], m[k], err_msg=k)
    assert drv.net.archis == net.archis
    assert drv.net.genotypes == net.genotypes
    got, want = _net_trees(drv.net), _net_trees(net)
    assert sorted(got) == sorted(want)
    for key in want:
        assert_trees_equal(got[key], want[key])
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(
        ("cellsearch", "opsearch", "finetune"))]


def _cell_search():
    return tmdenas.CellSearch(tmdenas.CellSearchConfig(
        epochs=3, batch=2, seed=2, maxdisp=MAXDISP), log=None, device="cpu")


def _cell_state(cs):
    return {"p": dict(cs.p), "params": np_tree(cs.params),
            "stats": np_tree(cs.stats), "momentum": np_tree(cs.opt_state)}


def test_cell_search_stop_after_and_resume(tmp_path):
    scene = _scenes(tasks=1)[0][0]
    whole = _cell_search()
    g_whole = whole.search(scene, task=1)
    ck = str(tmp_path / "cellsearch_t1.npz")
    _cell_search().search(scene, task=1, checkpoint_path=ck,
                          checkpoint_every=1, stop_after=2)
    resumed = _cell_search()
    assert resumed.search(scene, task=1, checkpoint_path=ck,
                          checkpoint_every=1, resume=True) == g_whole
    a, b = _cell_state(resumed), _cell_state(whole)
    for k in ("normal", "reduce"):
        np.testing.assert_array_equal(a["p"][k], b["p"][k])
    for k in ("params", "stats", "momentum"):
        assert_trees_equal(a[k], b[k])


def _expanded(seed=0):
    g = Genotype(normal=GENE, reduce=GENE)
    net = GrowableStereoNet.initial(g, seed, device="cpu")
    net.expand(1, g, seed + 31)
    return net


def test_op_search_stop_after_and_resume(tmp_path):
    scene = _scenes(tasks=1)[0][0]
    cfg = tgrowth.OpSearchConfig(epochs=3, batch=2, o_size=1, lr_a=0.5,
                                 seed=3, maxdisp=MAXDISP)
    whole = _expanded()
    tgrowth.OpSearch(whole, cfg, log=None).search(1, scene)
    ck = str(tmp_path / "opsearch_t1.npz")
    first = _expanded()
    tgrowth.OpSearch(first, cfg, log=None).search(
        1, scene, checkpoint_path=ck, checkpoint_every=1, stop_after=2)
    resumed = _expanded()
    tgrowth.OpSearch(resumed, cfg, log=None).search(
        1, scene, checkpoint_path=ck, checkpoint_every=1, resume=True)
    for a, b in zip(resumed.p, whole.p):
        np.testing.assert_array_equal(a, b)
    got, want = _net_trees(resumed), _net_trees(whole)
    for key in want:
        assert_trees_equal(got[key], want[key])


# -- (b) each package reads the other's stage files ----------------------------

def _randomized(tree, gen):
    """A tree shaped like ``tree`` with a fresh random value in every leaf
    (an integer leaf stays an integer leaf)."""
    if isinstance(tree, dict):
        return {k: _randomized(v, gen) for k, v in tree.items()}
    return torch.randn(tree.shape, generator=gen).to(tree.dtype)


def _jax_named(tree):
    """rag_tpu's tree (dicts of arrays) as {path: numpy}."""
    return flat(np_tree(tree))


def _rng(seed, draws):
    rng = np.random.default_rng(seed)
    rng.random(draws)
    return rng


def test_cellsearch_file_read_across(tmp_path):
    gen = torch.Generator().manual_seed(0)
    cs = _cell_search()
    cs.params = _randomized(cs.params, gen)
    cs.stats = _randomized(cs.stats, gen)
    cs.opt_state = _randomized(cs.opt_state, gen)
    cs.p = {k: np.random.default_rng(1).dirichlet([1, 1], 9) for k in cs.p}
    h_e = {k: np.random.default_rng(2).integers(0, 9, (9, 2)) for k in cs.p}
    h_a = {k: np.random.default_rng(3).random((9, 2)) for k in cs.p}
    best_p = {k: v[::-1].copy() for k, v in cs.p.items()}
    best_params = _randomized(cs.params, gen)
    rng_t = _rng(4, 7)
    port_file = str(tmp_path / "cellsearch_t0.npz")
    cs.save_state(port_file, 4, h_e, h_a, rng_t, 0.75, best_p, best_params)

    # rag_tpu's CellSearch, its trees from its own initializer and optax
    jcs = jmdenas.CellSearch.__new__(jmdenas.CellSearch)
    jcs.params, jcs.stats = jax.eval_shape(jsupernet.init_supernet,
                                           jax.random.PRNGKey(0))
    jcs.opt_state = jax.eval_shape(jtrainer.make_optimizer(3e-4).init,
                                   jcs.params)
    jcs.p = {}
    rng_j = np.random.default_rng(99)
    start, he_j, ha_j, loss_j, bp_j, bparams_j = jcs.load_state(port_file, rng_j)
    assert (start, loss_j) == (5, 0.75)
    assert rng_j.bit_generator.state == rng_t.bit_generator.state
    trace = jcs.opt_state[jgrowth._find_trace(jcs.opt_state)].trace
    for j, t in ((jcs.params, cs.params), (jcs.stats, cs.stats),
                 (trace, cs.opt_state), (bparams_j, best_params)):
        assert_trees_equal(_jax_named(j), flat(np_tree(t)))
    for k in cs.p:
        for a, b in ((jcs.p[k], cs.p[k]), (he_j[k], h_e[k]), (ha_j[k], h_a[k]),
                     (bp_j[k], best_p[k])):
            np.testing.assert_array_equal(a, b)

    # rag_tpu writes (its values doubled), the port reads
    double = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x) * 2,
                                                 tree)
    jcs.params, jcs.stats = double(jcs.params), double(jcs.stats)
    jcs.opt_state = double(jcs.opt_state)
    jax_file = str(tmp_path / "cellsearch_j.npz")
    rng_j.random(3)
    jcs.save_state(jax_file, 6, he_j, ha_j, rng_j, 0.5, bp_j, double(bparams_j))
    back = _cell_search()
    rng_b = np.random.default_rng(0)
    start, he_b, ha_b, loss_b, bp_b, bparams_b = back.load_state(jax_file, rng_b)
    assert (start, loss_b) == (7, 0.5)
    assert rng_b.bit_generator.state == rng_j.bit_generator.state
    trace = jcs.opt_state[jgrowth._find_trace(jcs.opt_state)].trace
    for t, j in ((back.params, jcs.params), (back.stats, jcs.stats),
                 (back.opt_state, trace), (bparams_b, double(bparams_j))):
        assert_trees_equal(flat(np_tree(t)), _jax_named(j))
    for k in cs.p:
        np.testing.assert_array_equal(back.p[k], cs.p[k])
        np.testing.assert_array_equal(he_b[k], h_e[k])


def _jax_net(tmp_path, net):
    """rag_tpu's registry of ``net``, read from a checkpoint the port wrote."""
    d = str(tmp_path / "registry")
    tstate.save_checkpoint(d, net, task=0)
    return jstate.load_checkpoint(d, 0)[0]


def _op_refs_named(refs):
    return {f"{name}/{part}": flat(np_tree(getattr(u, part)))
            for name, u in refs for part in ("params", "stats")}


def test_opsearch_file_read_across(tmp_path):
    gen = torch.Generator().manual_seed(5)
    net = _expanded()
    search = tgrowth.OpSearch(net, tgrowth.OpSearchConfig(), log=None)
    refs = search._new_unit_refs(1)
    jnet = _jax_net(tmp_path, net)      # before the live trees change
    for _, u in refs:
        u.params, u.stats = _randomized(u.params, gen), _randomized(u.stats, gen)
    momentum = {name: _randomized(u.params, gen) for name, u in refs[::2]}
    best = {name: (_randomized(u.params, gen), _randomized(u.stats, gen))
            for name, u in refs}
    h_e = [np.arange(len(p)) + i for i, p in enumerate(net.p)]
    h_a = [np.linspace(0, 1, len(p)) * i for i, p in enumerate(net.p)]
    net.p = [p[::-1].copy() for p in net.p]
    rng_t = _rng(6, 5)
    port_file = str(tmp_path / "opsearch_t1.npz")
    search.save_state(port_file, 1, 2, h_e, h_a, momentum, best, 0.125,
                      rng=rng_t)

    jsearch = jgrowth.OpSearch(jnet, jgrowth.OpSearchConfig(), log=None)
    rng_j = np.random.default_rng(0)
    start, he_j, ha_j, mom_j, best_j, loss_j = jsearch.load_state(
        port_file, 1, rng=rng_j)
    assert (start, loss_j) == (3, 0.125)
    assert rng_j.bit_generator.state == rng_t.bit_generator.state
    want = _op_refs_named(refs)
    got = _op_refs_named(jsearch._new_unit_refs(1))
    for key in want:
        assert_trees_equal(got[key], want[key])
    assert sorted(mom_j) == sorted(momentum)
    for name in momentum:
        assert_trees_equal(_jax_named(mom_j[name]), flat(np_tree(momentum[name])))
    for name, (p, s) in best.items():
        assert_trees_equal(_jax_named(best_j[name][0]), flat(np_tree(p)))
        assert_trees_equal(_jax_named(best_j[name][1]), flat(np_tree(s)))
    for i in range(len(net.p)):
        for a, b in ((jnet.p[i], net.p[i]), (he_j[i], h_e[i]), (ha_j[i], h_a[i])):
            np.testing.assert_array_equal(a, b)

    # rag_tpu writes (live trees doubled), the port reads into a fresh net
    for _, u in jsearch._new_unit_refs(1):
        u.params = jax.tree_util.tree_map(lambda x: np.asarray(x) * 2, u.params)
    jax_file = str(tmp_path / "opsearch_j.npz")
    jsearch.save_state(jax_file, 1, 4, he_j, ha_j, mom_j, best_j, 0.25,
                       rng=rng_j)
    fresh = _expanded(seed=7)
    back = tgrowth.OpSearch(fresh, tgrowth.OpSearchConfig(), log=None)
    rng_b = np.random.default_rng(1)
    start, he_b, ha_b, mom_b, best_b, loss_b = back.load_state(jax_file, 1,
                                                               rng=rng_b)
    assert (start, loss_b) == (5, 0.25)
    assert rng_b.bit_generator.state == rng_j.bit_generator.state
    want = _op_refs_named(jsearch._new_unit_refs(1))
    got = _op_refs_named(back._new_unit_refs(1))
    for key in want:
        assert_trees_equal(got[key], want[key])
    for name in momentum:
        assert_trees_equal(flat(np_tree(mom_b[name])), flat(np_tree(momentum[name])))
    for name, (p, s) in best.items():
        assert_trees_equal(flat(np_tree(best_b[name][0])), flat(np_tree(p)))
    for i in range(len(net.p)):
        np.testing.assert_array_equal(fresh.p[i], net.p[i])
        np.testing.assert_array_equal(he_b[i], h_e[i])


def test_finetune_file_read_across(tmp_path):
    gen = torch.Generator().manual_seed(8)
    net = GrowableStereoNet.initial(default_genotype(), 0, device="cpu")
    jnet = _jax_net(tmp_path, net)
    _, params, stats = net.path(net.archis[0])
    params, stats = _randomized(params, gen), _randomized(stats, gen)
    opt = _randomized(tdriver.make_optimizer(0.003).init(params), gen)
    best = (_randomized(params, gen), _randomized(stats, gen))
    port_file = str(tmp_path / "finetune_t0.npz")
    tdriver._save_finetune_state(port_file, params, stats, opt, best, 0.5, 6)

    _, jp, js = jnet.path(jnet.archis[0])
    jopt = jtrainer.make_optimizer(0.003).init(jp)
    jp, js, jopt, (jbp, jbs), loss, start = jdriver._load_finetune_state(
        port_file, (jp, js, jopt))
    assert (loss, start) == (0.5, 7)
    trace = jopt[jgrowth._find_trace(jopt)].trace
    for j, t in ((jp, params), (js, stats), (trace, opt), (jbp, best[0]),
                 (jbs, best[1])):
        assert_trees_equal(_jax_named(j), flat(np_tree(t)))

    jax_file = str(tmp_path / "finetune_j.npz")
    jdriver._save_finetune_state(jax_file, jbp, jbs, jopt, (jp, js), 0.25, 2)
    got = tdriver._load_finetune_state(jax_file, (params, stats, opt), "cpu")
    assert got[4:] == (0.25, 3)
    for t, j in ((got[0], jbp), (got[1], jbs), (got[2], trace),
                 (got[3][0], jp), (got[3][1], js)):
        assert_trees_equal(flat(np_tree(t)), _jax_named(j))


# -- (c) resume at a "trained" checkpoint and the stale router -----------------

def _two_task_net():
    g = default_genotype()
    net = GrowableStereoNet.initial(g, 0, device="cpu")
    net.expand(1, g, 31)
    net.p = [np.eye(len(p))[i % len(p)] for i, p in enumerate(net.p)]
    net.select(1)
    return net


def _row(x):
    return {k: float(x + i) for i, k in enumerate(METRICS)}


class _Spy(tdriver.ContinualDriver):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.evaluated, self.routers = [], []

    def search_cell(self, t, train_data):
        raise AssertionError("a resumed finished task searched again")

    def fine_tune(self, t, train_data, valid_data):
        raise AssertionError("a resumed finished task trained again")

    def evaluate(self, u, test_data, batch=1):
        self.evaluated.append((len(self.net.archis) - 1, u))
        return super().evaluate(u, test_data, batch)

    def train_router(self, t, train_datasets, test_datasets):
        self.routers.append(t)
        super().train_router(t, train_datasets, test_datasets)


def test_trained_checkpoint_runs_only_missing_evals(tmp_path):
    first = tdriver.ContinualDriver(_config(), log=None,
                                    checkpoint_dir=str(tmp_path), device="cpu")
    first.net = _two_task_net()
    first._eval_rows = {0: {0: _row(1.0)}, 1: {0: _row(2.0)}}
    first.matrix.record(0, 0, _row(1.0))
    first._save(1, "trained")
    lines = []
    drv = _Spy(_config(), log=lines.append, checkpoint_dir=str(tmp_path),
               device="cpu")
    matrix = drv.run(*_scenes(), resume=True)
    assert drv.evaluated == [(1, 1)]
    assert any("cached from resumed checkpoint" in m for m in lines)
    for i, k in enumerate(METRICS):
        assert matrix.m[k][0, 0] == 1.0 + i and matrix.m[k][1, 0] == 2.0 + i
        assert np.isfinite(matrix.m[k][1, 1])
    with open(tmp_path / "manifest_task1.json") as f:
        extra = json.load(f)["extra"]
    assert extra["stage"] == "task_done"
    assert sorted(extra["eval_rows"]["1"]) == ["0", "1"]


@pytest.mark.parametrize("trained_task,retrained", [(0, True), (1, False)])
def test_stale_router_is_retrained(tmp_path, trained_task, retrained):
    cfg = dataclasses.replace(_config(), use_router=True, router_epochs=1,
                              router_batch=2)
    first = tdriver.ContinualDriver(cfg, log=None,
                                    checkpoint_dir=str(tmp_path), device="cpu")
    first.net = _two_task_net()
    for t in range(2):
        first._eval_rows[t] = {u: _row(t + u) for u in range(t + 1)}
    first._save(1, "task_done")
    router = SceneRouter(2, seed=0, device="cpu")
    router.trained_task = trained_task
    tstate.save_router(str(tmp_path), router)
    drv = _Spy(cfg, log=None, checkpoint_dir=str(tmp_path), device="cpu")
    drv.run(*_scenes(), resume=True)
    assert drv.evaluated == [(1, 0), (1, 1)]   # the router report's oracle
    assert drv.routers == ([1] if retrained else [])
    assert tstate.load_router(str(tmp_path), device="cpu").trained_task == 1
    assert drv.router_eval is not None


# -- (d) the cost volume's backward --------------------------------------------

def _graph_names(fn):
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        todo += [g for g, _ in f.next_functions]
    return {type(f).__name__ for f in seen}


def test_cost_volume_backward_is_deterministic():
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(2, 24, 64, 8, generator=gen, requires_grad=True)
    y = torch.randn(2, 24, 64, 8, generator=gen, requires_grad=True)
    g = torch.randn(2, 16, 16, 24, 64, generator=gen)
    out = cost_volume_cf(x, y, 16)
    assert not [n for n in _graph_names(out.grad_fn) if n.startswith("Index")]
    grads = [torch.autograd.grad(cost_volume_cf(x, y, 16), (x, y), g)
             for _ in range(3)]
    for gx, gy in grads[1:]:
        assert torch.equal(gx, grads[0][0]) and torch.equal(gy, grads[0][1])
    small = [torch.randn(1, 2, 5, 2, generator=gen, dtype=torch.float64,
                         requires_grad=True) for _ in range(2)]
    for d in (3, 7):
        assert torch.autograd.gradcheck(lambda a, b: cost_volume_cf(a, b, d),
                                        small)
