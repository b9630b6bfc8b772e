"""The monocular-depth variant against the JAX package, on the CPU.

- ``depth_metrics`` and ``silog_loss`` on seeded maps in float64 within
  1e-12 relative.
- The committed ``logs/canonical_depth_r3b`` (4 tasks, ``variant:
  "depth"``): it loads into the port (2D matching stems, the shared depth
  head with ``bias1``), ``trainable_sites`` adds ``depth_head`` at t = 0
  only, every task path's ``depth_forward`` at 48x96 in float64 matches
  rag_tpu's within 1e-10 of the largest depth, the port's rewrite of the
  checkpoint reads back through rag_tpu's ``load_checkpoint`` leaf for
  leaf, and its ``router.npz`` loads as a router on "image" that routes
  frames as rag_tpu's does.
- The depth supernet: its init tree has rag_tpu's keys and shapes (the
  head's 'w' and 'b'; ``convert.supernet_to_torch`` refuses a head keyed
  as the depth net's); its forward in train and eval mode matches in
  float64 (1e-9 of the largest, statistics 1e-12); one float64
  ``DepthCellSearch`` epoch samples the same ops and keeps p within 1e-12.
- One float64 ``make_depth_train_step`` step of the committed task 0's
  stage (every site and the depth head train): dp/lr and momentum within
  1e-9 of each leaf's largest, statistics within 1e-12, the loss within
  1e-12 relative.
- Data: ``SyntheticDepthDataset`` bytes equal rag_tpu's for each style and
  two seeds; ``DepthDataset`` gives the same training crops and padded
  evaluation frames from a PNG list the test writes.
- The driver: a port-only 2-task ``DepthContinualDriver.run`` with
  ``matrix[1, 0] == matrix[0, 0]`` in all ten metrics and a checkpoint
  rag_tpu reads. Slow: the same run in both packages in float64 within
  1e-9.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from learn_parity import (
    Inits,
    Recorder,
    assert_stats_close,
    assert_trees_equal,
    assert_update_close,
    flat,
    np_tree,
    opt0,
    shapes,
)
from rag_tpu.continual import depth_driver as jdd
from rag_tpu.continual import driver as jdriver
from rag_tpu.continual import state as jstate
from rag_tpu.data import depth_dataset as jdata
from rag_tpu.metrics import depth as jmetrics
from rag_tpu.models import depth as jdepth
from rag_tpu.models import supernet as jsupernet
from rag_tpu.search import mdenas as jmdenas
from rag_tpu.train import losses as jlosses
from rag_tpu.train import trainer as jtrainer
from rag_tpu_torch.continual import depth_driver as tdd
from rag_tpu_torch.continual import state as tstate
from rag_tpu_torch.convert import supernet_to_torch, to_torch
from rag_tpu_torch.data import depth_dataset as tdata
from rag_tpu_torch.data.synthetic import WEATHER_STYLES
from rag_tpu_torch.metrics import depth as tmetrics
from rag_tpu_torch.models import depth as tdepth
from rag_tpu_torch.models import supernet as tsupernet
from rag_tpu_torch.models.growable import GrowableDepthNet
from rag_tpu_torch.models.stereo import SITE_NAMES
from rag_tpu_torch.search import mdenas as tmdenas
from rag_tpu_torch.train import losses as tlosses
from rag_tpu_torch.train.trainer import make_depth_train_step, make_optimizer
from test_torch_port_continual import _J, _T, _JaxOpSearch
from test_torch_port_train_slice import _jax_in

ROOT = Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "logs" / "canonical_depth_r3b")
H, W = 48, 96
METRICS = ("loss",) + tmetrics.DEPTH_METRIC_NAMES
FWD_TOL = 1e-10   # depth, float64: of the largest depth
UPD_TOL, STATS_TOL, LOSS_TOL = 1e-9, 1e-12, 1e-12
LR, WD = 0.001, 0.003


def _maps(seed, b=2, h=12, w=20):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.5, 60.0, (b, h, w))
    gt[:, :2] = 0.0
    pred = gt * rng.uniform(0.7, 1.4, (b, h, w))
    pred[0, -1] = 0.0          # below the 1e-12 floor
    return pred, gt, gt > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_depth_metrics_and_silog(seed):
    pred, gt, mask = _maps(seed)
    with _jax_in(np.float64):
        ref = {k: float(v) for k, v in
               jmetrics.depth_metrics(pred, gt, mask).items()}
        ref_loss = float(jlosses.silog_loss(pred, gt, mask))
    got = tmetrics.depth_metrics(*(torch.from_numpy(a) for a in (pred, gt, mask)))
    assert sorted(got) == sorted(ref) == sorted(tmetrics.DEPTH_METRIC_NAMES)
    for k, v in ref.items():
        assert abs(float(got[k]) - v) <= 1e-12 * max(abs(v), 1e-300), k
    loss = tlosses.silog_loss(*(torch.from_numpy(a) for a in (pred, gt, mask)))
    assert abs(float(loss) - ref_loss) <= 1e-12 * ref_loss


@pytest.fixture(scope="module")
def nets():
    return jstate.load_checkpoint(CKPT)[0], tstate.load_checkpoint(
        CKPT, device="cpu")[0]


def test_committed_checkpoint_loads(nets):
    jnet, tnet = nets
    assert isinstance(tnet, GrowableDepthNet) and tnet.variant == "depth"
    assert tnet.archis == jnet.archis and len(tnet.archis) == 4
    assert tnet.units["stem_3d0"][0].spec.ndim == 2
    for s in SITE_NAMES:
        for u, v in zip(tnet.units[s], jnet.units[s]):
            assert dataclasses.asdict(u.spec) == dataclasses.asdict(v.spec), s
    assert tnet.units["cell_3d4"][0].spec.ndim == 2
    assert sorted(tnet.depth_head.params) == ["bias1", "w"]
    assert_trees_equal(tnet.depth_head.params,
                       np_tree(jnet.depth_head.params))
    assert tnet.num_params() == jnet.num_params()
    for t in range(4):
        assert tnet.trainable_sites(t) == jnet.trainable_sites(t)
        assert ("depth_head" in tnet.trainable_sites(t)) == (t == 0)


_FWD = {}


def _frames(seed, n=2, h=H, w=W):
    kw = dict(seed=seed, style=WEATHER_STYLES[seed % 4])
    return (tdd.SyntheticDepthDataset(n, h, w, device="cpu", **kw),
            jdd.SyntheticDepthDataset(n, h, w, **kw))


@pytest.mark.parametrize("task", [0, 1, 2, 3])
def test_depth_forward_committed_paths(nets, task):
    jnet, tnet = nets
    specs_j, params_j, stats_j = jnet.path(jnet.archis[task])
    specs_t, _, _ = tnet.path(tnet.archis[task])
    params = np_tree(jax.tree_util.tree_map(np.asarray, params_j), np.float64)
    stats = np_tree(jax.tree_util.tree_map(np.asarray, stats_j), np.float64)
    image = tdd.SyntheticDepthDataset(2, H, W, seed=30 + task,
                                      style=WEATHER_STYLES[task],
                                      device="cpu")._samples()["image"]
    image = image.astype(np.float64)
    with _jax_in(np.float64):
        fwd = opt0(jax.jit(lambda p, s, x: jdepth.depth_forward(
            specs_j, p, s, x)[0]))
        ref = np.asarray(fwd(params, stats, image))
    got, new_stats = tdepth.depth_forward(specs_t, to_torch(params, "cpu"),
                                          to_torch(stats, "cpu"),
                                          torch.from_numpy(image))
    assert got.shape == (2, H, W) and got.dtype == torch.float64
    # in [0, MAX_DEPTH] up to the float32 interpolation weights' sum
    assert float(got.min()) >= 0
    assert float(got.max()) <= tdepth.MAX_DEPTH * (1 + 1e-6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=FWD_TOL * float(np.abs(ref).max()))
    assert_trees_equal(new_stats, stats)   # eval mode: statistics unchanged


def test_checkpoint_rewrite_reads_back_in_rag_tpu(nets, tmp_path):
    jnet, tnet = nets
    tstate.save_checkpoint(str(tmp_path), tnet, task=3, extra={"stage": "x"})
    with open(tmp_path / "manifest_task3.json") as f:
        assert json.load(f)["variant"] == "depth"
    back, manifest = jstate.load_checkpoint(str(tmp_path), 3)
    assert type(back).__name__ == "GrowableDepthNet"
    assert manifest["extra"] == {"stage": "x"}
    with np.load(Path(CKPT) / "arrays_task3.npz") as a, \
            np.load(tmp_path / "arrays_task3.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for s in SITE_NAMES:
        for u, v in zip(back.units[s], jnet.units[s]):
            assert dataclasses.asdict(u.spec) == dataclasses.asdict(v.spec)
            assert u.born_task == v.born_task
            assert_trees_equal(np_tree(u.params), np_tree(v.params))
    assert_trees_equal(np_tree(back.depth_head.params),
                       np_tree(jnet.depth_head.params))


def test_committed_router_routes_on_image():
    tr = tstate.load_router(CKPT, device="cpu")
    jr = jstate.load_router(CKPT)
    assert tr.input_key == jr.input_key == "image"
    for t in range(4):
        td, jd = _frames(30 + t, n=3, h=96, w=192)
        imgs = jd._samples()["image"]
        np.testing.assert_array_equal(td._samples()["image"], imgs)
        np.testing.assert_array_equal(tr.predict(torch.from_numpy(imgs)),
                                      jr.predict(imgs))


@pytest.mark.parametrize("style", [0, 1, 2, 3])
def test_synthetic_depth_bytes(style):
    for seed in (5, 31):
        kw = dict(seed=seed, style=WEATHER_STYLES[style])
        t = tdd.SyntheticDepthDataset(5, 18, 29, device="cpu", **kw)
        j = jdd.SyntheticDepthDataset(5, 18, 29, **kw)
        for k, v in j._samples().items():
            assert t._samples()[k].dtype == v.dtype
            np.testing.assert_array_equal(t._samples()[k], v, err_msg=k)
        got = list(t.batches(2, True, seed=4, drop_last=False))
        ref = list(j.batches(2, True, seed=4, drop_last=False))
        assert len(got) == len(ref) == 3
        for b, r in zip(got, ref):
            for k in r:
                np.testing.assert_array_equal(b[k].numpy(), r[k], err_msg=k)


def _depth_list(tmp_path, n=3, h=40, w=80, columns=3):
    rng = np.random.default_rng(7)
    lines = []
    for i in range(n):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        depth = rng.integers(0, 60 * 256, (h, w)).astype(np.uint16)
        paths = [str(tmp_path / f"img{i}.png"), str(tmp_path / f"dep{i}.png")]
        Image.fromarray(img).save(paths[0])
        Image.fromarray(depth).save(paths[1])
        lines.append(" ".join([paths[0]] * (columns - 1) + [paths[1]]))
    lst = tmp_path / f"list{columns}.txt"
    lst.write_text("\n".join(lines) + "\n")
    return str(lst)


@pytest.mark.parametrize("columns", [2, 3])
def test_depth_dataset_matches(tmp_path, columns):
    lst = _depth_list(tmp_path, columns=columns)
    for training, kw in ((True, dict(crop=(48, 24))), (False, dict(pad=(96, 48)))):
        t = tdata.DepthDataset(lst, training, device="cpu", **kw)
        j = jdata.DepthDataset(lst, training, **kw)
        bs = 2 if training else 1
        got = list(t.batches(bs, training, seed=3, drop_last=False))
        ref = list(j.batches(bs, training, seed=3, drop_last=False))
        assert len(got) == len(ref) > 0
        for b, r in zip(got, ref):
            for k in ("image", "depth"):
                np.testing.assert_array_equal(b[k].numpy(), r[k], err_msg=k)


# -- the depth supernet ----------------------------------------------------------

SB, SH, SW = 2, 24, 48


@pytest.fixture(scope="module")
def sweights():
    p, s = opt0(jax.jit(jsupernet.init_depth_supernet))(jax.random.PRNGKey(0))
    return np_tree(p, np.float64), np_tree(s, np.float64)


def test_depth_supernet_init_and_head_names(sweights):
    pt, st = tsupernet.init_depth_supernet(torch.Generator().manual_seed(0),
                                           "cpu")
    assert shapes(pt) == shapes(sweights[0])
    assert shapes(st) == shapes(sweights[1])
    assert sorted(pt["depth_head"]) == ["b", "w"]
    p, s = supernet_to_torch(*sweights, device="cpu")
    assert_trees_equal(p, sweights[0])
    bad = dict(sweights[0], depth_head={"w": sweights[0]["depth_head"]["w"],
                                        "bias1": np.zeros(1)})
    with pytest.raises(ValueError, match="bias1"):
        supernet_to_torch(bad, sweights[1], device="cpu")


def _sbatch(seed):
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((SB, SH, SW, 3))
    depth = rng.uniform(0.0, 60.0, (SB, SH, SW))
    depth[:, :3] = 0.0
    return image, depth


@pytest.mark.parametrize("train", [True, False])
def test_depth_supernet_forward(sweights, train):
    params, stats = sweights
    fea_ops = np.random.default_rng(5).integers(0, 2, 9).astype(np.int32)
    mat_ops = fea_ops[::-1].copy()
    image, _ = _sbatch(1)
    with _jax_in(np.float64):
        fwd = opt0(jax.jit(lambda p, s, x, f, m: jsupernet.depth_supernet_forward(
            p, s, x, f, m, train=train)))
        dj, nsj = fwd(params, stats, image, fea_ops, mat_ops)
        dj, nsj = np.asarray(dj), np_tree(nsj)
    p_t, s_t = supernet_to_torch(params, stats, device="cpu")
    dt, nst = tsupernet.depth_supernet_forward(p_t, s_t, torch.from_numpy(image),
                                               fea_ops, mat_ops, train)
    assert dt.shape == (SB, SH, SW) and dt.dtype == torch.float64
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0,
                               atol=1e-9 * float(np.abs(dj).max()))
    assert_stats_close(nst, nsj)


class _DepthArrays:
    """A fixed float64 depth scene both packages read (numpy for rag_tpu,
    CPU tensors for the port), in the datasets' order."""

    def __init__(self, n, h, w, seed, style=0, torch_out=False):
        ds = tdd.SyntheticDepthDataset(n, h, w, seed=seed,
                                       style=WEATHER_STYLES[style], device="cpu")
        self.data = {k: v.astype(np.float64) for k, v in ds._samples().items()}
        self.n, self.seed, self.torch_out = n, seed, torch_out

    def __len__(self):
        return self.n

    def twin(self):
        other = _DepthArrays.__new__(_DepthArrays)
        other.__dict__.update(self.__dict__, torch_out=not self.torch_out)
        return other

    def batches(self, batch_size, shuffle=True, seed=0, indices=None,
                drop_last=True):
        idx = np.asarray(indices if indices is not None else np.arange(self.n))
        if shuffle:
            idx = np.random.default_rng(self.seed + seed).permutation(idx)
        stop = len(idx) - (len(idx) % batch_size) if drop_last else len(idx)
        for i in range(0, stop, batch_size):
            b = {k: v[idx[i:i + batch_size]] for k, v in self.data.items()}
            yield ({k: torch.from_numpy(v) for k, v in b.items()}
                   if self.torch_out else b)


def test_depth_cell_search_one_epoch(sweights):
    cfg = jmdenas.CellSearchConfig(epochs=1, batch=SB, seed=3)

    class Injected(jmdenas.DepthCellSearch):
        @staticmethod
        def _init_net(key):
            return sweights

    scene = _DepthArrays(4, SH, SW, seed=11, style=1)
    ops_j, ops_t, rec_j, rec_t = [], [], Recorder(), Recorder()

    def record(cs, out):
        step = cs._train_step

        def run(*a):
            out.append((np.asarray(a[-2]).copy(), np.asarray(a[-1]).copy()))
            return step(*a)
        cs._train_step = run

    with _jax_in(np.float64):
        cs = Injected(cfg, log=None)
        cs._train_step, cs._eval_step = opt0(cs._train_step), opt0(cs._eval_step)
        record(cs, ops_j)
        geno_j = cs.search(scene, writer=rec_j, task=1)
        p_j, params_j, stats_j = cs.p, np_tree(cs.params), np_tree(cs.stats)
    ts = tmdenas.DepthCellSearch(
        tmdenas.CellSearchConfig(**dataclasses.asdict(cfg)), log=None,
        device="cpu", weights=supernet_to_torch(*sweights, device="cpu"))
    record(ts, ops_t)
    geno_t = ts.search(scene.twin(), writer=rec_t, task=1)
    assert len(ops_t) == len(ops_j) == 1
    for (fj, mj), (ft, mt) in zip(ops_j, ops_t):
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(mt, mj)
    for k in p_j:
        np.testing.assert_allclose(ts.p[k], p_j[k], rtol=0, atol=1e-12)
    assert (geno_t.normal, geno_t.reduce) == (geno_j.normal, geno_j.reduce)
    (_, _, v_j), = rec_j.records
    (_, _, v_t), = rec_t.records
    for k in v_j:
        assert abs(v_t[k] - v_j[k]) <= 1e-12 * max(1.0, abs(v_j[k])), k
    assert_update_close(ts.params, params_j, sweights[0], cfg.lr)
    assert_stats_close(ts.stats, stats_j)


def test_depth_train_step_task0(nets):
    """One float64 step of task 0's stage: every site trains with its
    BatchNorm in train mode, and the shared depth head trains."""
    jnet, tnet = nets
    sites = tnet.trainable_sites(0)
    specs_j, params_j, stats_j = jnet.path(jnet.archis[0])
    specs_t, _, _ = tnet.path(tnet.archis[0])
    params = np_tree(jax.tree_util.tree_map(np.asarray, params_j), np.float64)
    stats = np_tree(jax.tree_util.tree_map(np.asarray, stats_j), np.float64)
    b = next(_DepthArrays(2, H, W, seed=12, style=2).batches(2, True))
    lr = LR
    opt_j = jtrainer.make_optimizer(WD)
    with _jax_in(np.float64):
        step_j = opt0(jtrainer.make_depth_train_step(specs_j, sites, opt_j))
        p_j, s_j, o_j, sc_j = jax.tree_util.tree_map(np.asarray, step_j(
            params, stats, opt_j.init(params), lr, b["image"], b["depth"]))
    opt_t = make_optimizer(WD)
    p_t = to_torch(params, "cpu")
    p_t, s_t, o_t, sc_t = make_depth_train_step(specs_t, sites, opt_t)(
        p_t, to_torch(stats, "cpu"), opt_t.init(p_t), lr,
        torch.from_numpy(b["image"]), torch.from_numpy(b["depth"]))
    assert "depth_head" in sites and set(params) <= sites
    assert_update_close(p_t, p_j, params, lr, UPD_TOL)
    tr_t, tr_j = flat(o_t), flat(o_j[2].trace)
    assert sorted(tr_t) == sorted(tr_j)
    for k in tr_j:
        np.testing.assert_allclose(tr_t[k], tr_j[k], rtol=0, err_msg=k,
                                   atol=UPD_TOL * float(np.abs(tr_j[k]).max()))
    assert_stats_close(s_t, s_j, STATS_TOL)
    assert sorted(sc_t) == sorted(sc_j)
    for k in sc_j:
        assert abs(float(sc_t[k]) - float(sc_j[k])) <= \
            LOSS_TOL * max(abs(float(sc_j[k])), 1e-300), k


# -- the driver --------------------------------------------------------------------

def _depth_config(ns):
    return ns.ExperimentConfig(
        cell=ns.CellSearchConfig(epochs=2, batch=2, seed=0),
        op=ns.OpSearchConfig(epochs=2, batch=2, o_size=1, lr_a=0.5, seed=0),
        train=ns.TrainConfig(epochs=2, batch=2), num_tasks=2, seed=0)


def _depth_scenes(n=4, torch_out=True):
    mk = lambda seed, t: _DepthArrays(n, SH, SW, seed=seed, style=t,
                                      torch_out=torch_out)
    return ([mk(10 + t, t) for t in range(2)], [mk(20 + t, t) for t in range(2)],
            [mk(30 + t, t) for t in range(2)])


def test_two_task_depth_run_port(tmp_path):
    train, valid, test = _depth_scenes()
    for group in (train, valid, test):
        for s in group:
            s.data = {k: v.astype(np.float32) for k, v in s.data.items()}
    cfg = dataclasses.replace(_depth_config(_T), use_router=True,
                              router_epochs=1, router_batch=2)
    lines = []
    drv = tdd.DepthContinualDriver(cfg, log=lines.append,
                                   checkpoint_dir=str(tmp_path), device="cpu")
    matrix = drv.run(train, valid, test)
    assert matrix.metric_names == METRICS
    for k in METRICS:
        assert matrix.m[k][1, 0] == matrix.m[k][0, 0], k
        assert np.isfinite(matrix.m[k]).all()
    assert sum(ln.startswith("[depth_train t") for ln in lines) == 4
    assert any(ln.startswith(">>> after task 1: test task 0 silog") for ln in lines)
    assert drv.router.input_key == "image" and drv.router_eval["routed_silog"]
    jnet, manifest = jstate.load_checkpoint(str(tmp_path), 1)
    assert manifest["variant"] == "depth" and jnet.archis == drv.net.archis
    back, _ = tstate.load_checkpoint(str(tmp_path), 1, device="cpu")
    assert_trees_equal(back.depth_head.params, np_tree(drv.net.depth_head.params))


@pytest.mark.slow
def test_two_task_depth_run_matches_rag_tpu(monkeypatch):
    """Both depth drivers, 2 tasks, float64, from equal initial weights."""
    cells, heads = [], []

    class JaxCellSearch(jmdenas.DepthCellSearch):
        @staticmethod
        def _init_net(key):
            out = np_tree(opt0(jax.jit(jsupernet.init_depth_supernet))(key))
            cells.append(out)
            return out

    class JaxDriver(jdd.DepthContinualDriver):
        def _cell_search_cls(self):
            return JaxCellSearch

    init_head = jdepth.init_depth_head

    def record_head(key):
        out = init_head(key)
        heads.append(tuple(np_tree(t) for t in out))
        return out

    inits = Inits(monkeypatch)
    monkeypatch.setattr(jdepth, "init_depth_head", record_head)
    monkeypatch.setattr(jdriver, "OpSearch", _JaxOpSearch)
    train, valid, test = _depth_scenes(torch_out=False)
    with _jax_in(np.float64):
        jdrv = JaxDriver(_depth_config(_J), log=None)
        jm = jdrv.run(train, valid, test)

    f64 = lambda t: to_torch(np_tree(t, np.float64), "cpu")
    draws = [tuple(f64(t) for t in a + b)
             for a, b in zip(inits.drawn[::2], inits.drawn[1::2])]

    class Driver(tdd.DepthContinualDriver):
        def _cell_search(self, t):
            cs = super()._cell_search(t)
            cs.params, cs.stats = supernet_to_torch(
                *(np_tree(x, np.float64) for x in cells[t]), device="cpu")
            cs.opt_state = cs.optimizer.init(cs.params)
            return cs

        def _grow(self, t, genotype):
            if t == 0:
                self.net = GrowableDepthNet.initial(
                    genotype, device="cpu",
                    weights=draws[0] + tuple(f64(x) for x in heads[0]))
            else:
                self.net.expand(t, genotype, weights=draws[t])

    tdrv = Driver(_depth_config(_T), log=None, device="cpu")
    tm = tdrv.run(*(tuple(s.twin() for s in g) for g in (train, valid, test)))
    assert [(g.normal, g.reduce) for g in tdrv.net.genotypes] == \
        [(g.normal, g.reduce) for g in jdrv.net.genotypes]
    assert tdrv.net.archis == jdrv.net.archis
    assert tdrv.net.model_to_train == jdrv.net.model_to_train
    for k in METRICS:
        np.testing.assert_allclose(tm.m[k], jm.m[k], rtol=1e-9, atol=0,
                                   err_msg=k)

