"""The self-supervised variant against the JAX package, on the CPU.

- The warp: the port's gather warp equals rag_tpu's ``warp_by_disparity``
  within 1e-6 in float32 (bit for bit, measured) and 1e-12 in float64,
  and its gather-free ``warp_by_disparity_scan`` within 1e-12 in float64;
  in float32 the scan and the gather round the source column apart, so
  the scan is held at that rounding's bound (eps * (W + max disp) * 2 *
  max |image|). Disparities at integers, past W and between.
- ``ssim``, ``photometric_loss`` and ``silog_loss``: values and gradients
  (``jax.grad`` against ``torch.autograd``) in float64 within 1e-10 of
  the largest, on inputs that put SSIM at its clip's lower bound and
  silog's floor at a tie (JAX splits a tie's gradient in half there).
- ``transfer_color`` and ``ColorTransferDataset`` batches equal rag_tpu's
  bit for bit (the transfer runs in numpy on the host in both).
- One float64 ``make_selfsup_train_step`` step of task 2's fine-tune stage
  of ``logs/canonical_selfsup_r5`` (B = 2, 48x96, maxdisp 96) on styled
  synthetic batches: dp/lr and momentum within 1e-9 of each leaf's
  largest, statistics within 1e-12 of max(1, |stat|), the loss and EPE
  within 1e-12 relative.
- The driver: ``pretrain`` is skipped where ``finetune_t{t}.npz`` exists
  and runs where it does not; one ``OpSearch`` epoch with split_frac 0.8
  and eval_max_batches 1 samples the same ops as rag_tpu's, keeps p
  within 1e-12, the same valid D1, and the valid loss after its 8 steps
  within 1e-8 relative (the net's training amplifies rounding ~10x a
  step); a port-only 2-task ``SelfSupContinualDriver.run`` with
  pretrain and proxy data has ``matrix[1, 0] == matrix[0, 0]`` bit for
  bit. Slow: the same 2-task run in both packages in float64 within 1e-9.

Float64 JAX runs take x64 with its float32 policy pointed at float64
(``_jax_in``).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from learn_parity import (
    ArrayScene,
    Inits,
    Recorder,
    assert_stats_close,
    assert_trees_equal,
    assert_update_close,
    flat,
    np_tree,
    opt0,
)
from rag_tpu.continual import driver as jdriver
from rag_tpu.continual import self_supervised as jself
from rag_tpu.continual.state import load_checkpoint as jax_load_checkpoint
from rag_tpu.data import transfer as jtransfer
from rag_tpu.data.synthetic import SyntheticStereoDataset as JaxSynthetic
from rag_tpu.models import supernet as jsupernet
from rag_tpu.search import growth as jgrowth
from rag_tpu.search import mdenas as jmdenas
from rag_tpu.train import losses as jlosses
from rag_tpu.train import trainer as jtrainer
from rag_tpu_torch.continual import self_supervised as tself
from rag_tpu_torch.continual.state import load_checkpoint
from rag_tpu_torch.convert import to_torch
from rag_tpu_torch.data import transfer as ttransfer
from rag_tpu_torch.data.synthetic import WEATHER_STYLES, SyntheticStereoDataset
from rag_tpu_torch.models.growable import GrowableStereoNet
from rag_tpu_torch.search import growth as tgrowth
from rag_tpu_torch.train import losses as tlosses
from rag_tpu_torch.train.trainer import cosine_lr, make_optimizer, make_selfsup_train_step
from test_torch_port_continual import (
    _J,
    _T,
    METRICS,
    _expanded,
    _JaxOpSearch,
    _scenes,
    _sel,
)
from test_torch_port_train_slice import _jax_in

ROOT = Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "logs" / "canonical_selfsup_r5")
WARP_TOL = {np.float32: 1e-6, np.float64: 1e-12}
GRAD_RTOL = 1e-10   # float64 values and gradients, of the largest
UPD_TOL, STATS_TOL, LOSS_TOL = 1e-9, 1e-12, 1e-12
LR, WD = 0.001, 0.003
OP_LOSS_RTOL = 1e-8  # the op search's valid loss after 8 float64 steps
MAXDISP = 96         # the step test: cost volume D = 32 = W/3 at 48x96


def _warp_inputs(dtype):
    rng = np.random.default_rng(0)
    b, h, w = 2, 6, 20
    image = rng.standard_normal((b, h, w, 3)).astype(dtype)
    disp = rng.uniform(0.0, w + 4.0, (b, h, w))
    disp[0, :2] = np.arange(w)[None, :] % 7          # integers, 0 included
    disp[1, 0] = w + 3.0                              # past W
    disp[1, 1] = w - 1.0
    return image, disp.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_warp_matches_gather_and_scan(dtype):
    image, disp = _warp_inputs(dtype)
    out_t, valid_t = tlosses.warp_by_disparity(torch.from_numpy(image),
                                               torch.from_numpy(disp))
    assert out_t.dtype == torch.from_numpy(image).dtype
    with _jax_in(dtype):
        refs = [np.asarray(x) for x in jlosses.warp_by_disparity(image, disp)]
        scan = np.asarray(jlosses.warp_by_disparity_scan(
            image, disp, max_disp=image.shape[2])[0])
    np.testing.assert_array_equal(valid_t.numpy(), refs[1])
    np.testing.assert_allclose(out_t.numpy(), refs[0], rtol=0,
                               atol=WARP_TOL[dtype])
    # the scan weighs each shift d by 1 - |disp - d|, the gather by the
    # fraction of the source column w - disp: the two forms round that
    # coordinate apart, by up to eps * (W + max disp), times the largest
    # step between neighbours (1.37e-6 here in float32, rag_tpu's own gap)
    tol = max(WARP_TOL[dtype], float(np.finfo(dtype).eps)
              * (image.shape[2] + float(disp.max()))
              * 2 * float(np.abs(image).max()))
    np.testing.assert_allclose(out_t.numpy(), scan, rtol=0, atol=tol)


def _grad_case(seed=0):
    """left/right, a disparity and depth maps in float64, with ties: two
    3x3 windows where left == warped right exactly (SSIM 0) and depth
    estimates at silog's 1e-8 floor."""
    rng = np.random.default_rng(seed)
    b, h, w = 2, 12, 24
    left = rng.standard_normal((b, h, w, 3))
    right = rng.standard_normal((b, h, w, 3))
    disp = rng.uniform(0.5, 6.0, (b, h, w))
    x, y = left.copy(), rng.standard_normal((b, h, w, 3))
    y[0, :3, :3] = x[0, :3, :3]          # SSIM exactly 0 in this window
    x[1, 3:6, 3:6] = 0.5
    y[1, 3:6, 3:6] = 0.5                 # flat and equal: exactly 0
    y[0, 6:9, 6:9] = -x[0, 6:9, 6:9]     # anticorrelated: near 1
    est = rng.uniform(0.5, 60.0, (b, h, w))
    est[0, 0, :4] = 1e-8
    est[0, 1, :4] = 1e-9
    gt = rng.uniform(0.0, 60.0, (b, h, w))
    gt[:, -1] = 0.0
    return left, right, disp, x, y, est, gt


def _close(got, ref, tol=GRAD_RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(float(np.abs(ref).max()), 1e-300))


def test_ssim_value_and_grads():
    _, _, _, x, y, _, _ = _grad_case()
    wts = np.random.default_rng(1).uniform(0.5, 1.5, (2, 4, 8, 3))
    with _jax_in(np.float64):
        val_j = np.asarray(jlosses.ssim(x, y))
        gx_j, gy_j = jax.grad(lambda a, c: jnp.sum(jlosses.ssim(a, c) * wts),
                              argnums=(0, 1))(x, y)
    assert (val_j == 0).sum() >= 6     # the clip's lower bound, a tie
    xt, yt = (torch.from_numpy(a).requires_grad_(True) for a in (x, y))
    val_t = tlosses.ssim(xt, yt)
    (val_t * torch.from_numpy(wts)).sum().backward()
    _close(val_t.detach().numpy(), val_j)
    _close(xt.grad.numpy(), gx_j)
    _close(yt.grad.numpy(), gy_j)


def test_photometric_loss_value_and_grad():
    left, right, disp, _, _, _, _ = _grad_case()
    with _jax_in(np.float64):
        val_j, g_j = jax.value_and_grad(
            lambda d: jlosses.photometric_loss(d, left, right))(disp)
    dt = torch.from_numpy(disp).requires_grad_(True)
    val_t = tlosses.photometric_loss(dt, torch.from_numpy(left),
                                     torch.from_numpy(right))
    val_t.backward()
    assert abs(float(val_t) - float(val_j)) <= GRAD_RTOL * abs(float(val_j))
    _close(dt.grad.numpy(), g_j)


def test_silog_value_and_grad():
    _, _, _, _, _, est, gt = _grad_case()
    mask = gt > 0
    with _jax_in(np.float64):
        val_j, g_j = jax.value_and_grad(
            lambda e: jlosses.silog_loss(e, gt, mask))(est)
    et = torch.from_numpy(est).requires_grad_(True)
    val_t = tlosses.silog_loss(et, torch.from_numpy(gt), torch.from_numpy(mask))
    val_t.backward()
    assert abs(float(val_t) - float(val_j)) <= GRAD_RTOL * abs(float(val_j))
    g_j = np.asarray(g_j)
    # the floor's tie takes half the gradient in both
    assert g_j[0, 0, 0] != 0 and g_j[0, 1, 0] == 0
    _close(et.grad.numpy(), g_j)


@pytest.mark.parametrize("shape", [(10, 14, 3), (2, 10, 14, 3)])
def test_transfer_color_bit_equal(shape):
    rng = np.random.default_rng(len(shape))
    target = rng.uniform(0, 1, shape).astype(np.float32)
    source = (rng.uniform(0, 1, shape) ** 2).astype(np.float32)
    np.testing.assert_array_equal(ttransfer.transfer_color(target, source),
                                  jtransfer.transfer_color(target, source))


def test_color_transfer_dataset_bit_equal():
    kw = dict(seed=888, max_disp=20.0)
    real_t = SyntheticStereoDataset(4, 24, 48, seed=10, style=WEATHER_STYLES[2],
                                    device="cpu")
    real_j = JaxSynthetic(4, 24, 48, seed=10, style=WEATHER_STYLES[2])
    pool_t = torch.cat([b["left"] for b in real_t.batches(2, False, seed=0)])
    pool_j = np.concatenate([b["left"] for b in real_j.batches(2, False, seed=0)])
    np.testing.assert_array_equal(pool_t.numpy(), pool_j)
    ds_t = ttransfer.ColorTransferDataset(
        SyntheticStereoDataset(6, 24, 48, device="cpu", **kw), pool_t)
    ds_j = jtransfer.ColorTransferDataset(JaxSynthetic(6, 24, 48, **kw), pool_j)
    assert len(ds_t) == len(ds_j) == 6
    got = list(ds_t.batches(2, True, seed=3))
    ref = list(ds_j.batches(2, True, seed=3))
    assert len(got) == len(ref) == 3
    for b, r in zip(got, ref):
        for k in r:
            assert b[k].device.type == "cpu"
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(r[k]),
                                          err_msg=k)


def test_selfsup_step_canonical_task2():
    jnet = jax_load_checkpoint(CKPT, 2)[0]
    tnet = load_checkpoint(CKPT, 2, device="cpu")[0]
    sites = tnet.trainable_sites(2)
    assert sites == jnet.trainable_sites(2)
    specs_j, params_j, stats_j = jnet.path(jnet.archis[2])
    specs_t, _, _ = tnet.path(tnet.archis[2])
    params = np_tree(jax.tree_util.tree_map(np.asarray, params_j), np.float64)
    stats = np_tree(jax.tree_util.tree_map(np.asarray, stats_j), np.float64)
    kw = dict(seed=21, max_disp=40.0, style=WEATHER_STYLES[2])
    b = next(SyntheticStereoDataset(2, 48, 96, device="cpu", **kw)
             .batches(2, True, seed=0))
    r = next(JaxSynthetic(2, 48, 96, **kw).batches(2, True, seed=0))
    for k in r:
        np.testing.assert_array_equal(b[k].numpy(), r[k], err_msg=k)
    args = [r[k].astype(np.float64) for k in ("left", "right", "disparity")]
    lr = cosine_lr(LR, 10, 0)

    opt_j = jtrainer.make_optimizer(WD)
    with _jax_in(np.float64):
        step_j = opt0(jtrainer.make_selfsup_train_step(specs_j, sites, opt_j,
                                                          maxdisp=MAXDISP))
        p_j, s_j, o_j, sc_j = step_j(params, stats, opt_j.init(params), lr,
                                     *args)
        p_j, s_j, o_j, sc_j = jax.tree_util.tree_map(
            np.asarray, (p_j, s_j, o_j, sc_j))
    opt_t = make_optimizer(WD)
    p_t = to_torch(params, "cpu")
    step_t = make_selfsup_train_step(specs_t, sites, opt_t, maxdisp=MAXDISP)
    p_t, s_t, o_t, sc_t = step_t(p_t, to_torch(stats, "cpu"), opt_t.init(p_t),
                                 lr, *(torch.from_numpy(a) for a in args))

    trained = {k: v for k, v in params.items() if k in sites}
    assert trained
    assert_update_close({k: p_t[k] for k in trained},
                        {k: p_j[k] for k in trained}, trained, lr, UPD_TOL)
    frozen = {k: v for k, v in params.items() if k not in sites}
    assert_trees_equal({k: p_t[k] for k in frozen}, frozen)
    tr_t, tr_j = flat({k: o_t[k] for k in trained}), flat(
        {k: o_j[2].trace[k] for k in trained})
    for k in tr_j:
        np.testing.assert_allclose(tr_t[k], tr_j[k], rtol=0, err_msg=k,
                                   atol=UPD_TOL * float(np.abs(tr_j[k]).max()))
    assert_stats_close(s_t, s_j, STATS_TOL)
    assert sorted(sc_t) == sorted(sc_j)
    for k in ("loss", "EPE"):
        assert abs(float(sc_t[k]) - float(sc_j[k])) <= \
            LOSS_TOL * abs(float(sc_j[k])), k
    for k in ("D1", "Thres1", "Thres2", "Thres3"):
        assert abs(float(sc_t[k]) - float(sc_j[k])) <= 1e-12, k


def _selfsup_cfg(ns, **kw):
    base = _config_fields(ns)
    return ns.SelfSupConfig(**base, pretrain_epochs=1, pretrain_batch=2,
                            op_eval_max_batches=1, **kw)


def _config_fields(ns):
    return dict(cell=ns.CellSearchConfig(epochs=2, batch=2, seed=0),
                op=ns.OpSearchConfig(epochs=2, batch=2, o_size=1, lr_a=0.5,
                                     seed=0),
                train=ns.TrainConfig(epochs=2, batch=2), num_tasks=2, seed=0,
                maxdisp=48)


class _TS(_T):
    SelfSupConfig = tself.SelfSupConfig


class _JS(_J):
    SelfSupConfig = jself.SelfSupConfig


def test_pretrain_skipped_where_finetune_file_exists(tmp_path):
    ran = []

    class Driver(tself.SelfSupContinualDriver):
        def pretrain(self, t):
            ran.append(t)

    drv = Driver(_selfsup_cfg(_TS), pretrain_data=ArrayScene(2, 24, 48, 1),
                 log=None, checkpoint_dir=str(tmp_path), device="cpu")
    drv._pre_finetune(0)
    (tmp_path / "finetune_t1.npz").write_bytes(b"")
    drv._pre_finetune(1)
    assert ran == [0]
    drv.stage_checkpoint_every = 0     # no stage files: pretrain runs
    drv._pre_finetune(1)
    assert ran == [0, 1]
    assert not Driver(_selfsup_cfg(_TS), log=None,
                      device="cpu")._should_pretrain(0)


def test_op_search_split_and_eval_cut(monkeypatch):
    """One OpSearch epoch on the self-supervised search's 0.8 split with
    scoring cut to 1 of the held-out half's 2 batches."""
    jnet, tnet = _expanded(monkeypatch)
    cfg = dict(epochs=1, batch=1, o_size=10, seed=4, maxdisp=48,
               split_frac=0.8, eval_max_batches=1)
    scene = ArrayScene(10, 24, 48, seed=15, style=2)
    calls = []
    evaluate = tgrowth.make_eval_step

    def counted(*a, **kw):
        step = evaluate(*a, **kw)
        return lambda *b: calls.append(1) or step(*b)

    monkeypatch.setattr(tgrowth, "make_eval_step", counted)
    log_j, log_t, rec_j, rec_t = [], [], Recorder(), Recorder()
    with _jax_in(np.float64):
        _JaxOpSearch(jnet, jgrowth.OpSearchConfig(**cfg),
                     log=log_j.append).search(1, scene, writer=rec_j)
    tgrowth.OpSearch(tnet, tgrowth.OpSearchConfig(**cfg),
                     log=log_t.append).search(1, scene.twin(), writer=rec_t)
    assert len(calls) == 1
    assert _sel(log_t) == _sel(log_j) and len(_sel(log_t)) == 1
    for pt, pj in zip(tnet.p, jnet.p):
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-12)
    (_, _, v_j), = rec_j.records
    (_, _, v_t), = rec_t.records
    assert (v_t["valid_d1"], v_t["n_new"]) == (v_j["valid_d1"], v_j["n_new"])
    # eight float64 steps: this tiny random net's training amplifies the
    # packages' rounding ~10x a step (params 2e-16 apart after step 1,
    # 2.5e-10 after step 8, measured), so the loss after them is held at
    # 1e-8 relative; p reads D1 and n_new only
    assert abs(v_t["valid_loss"] - v_j["valid_loss"]) <= \
        OP_LOSS_RTOL * abs(v_j["valid_loss"])


def _f32(scenes):
    for group in scenes:
        for s in group:
            s.data = {k: v.astype(np.float32) for k, v in s.data.items()}
    return scenes


def test_two_task_selfsup_run_port(tmp_path):
    """The port's self-supervised driver end to end on the CPU: cell
    search, pretrain, proxy op search, photometric fine-tune; zero
    forgetting bit for bit and a checkpoint both packages read."""
    train, valid, test = _f32(_scenes(4))
    proxy = SyntheticStereoDataset(6, 24, 48, seed=888, max_disp=28.8,
                                   device="cpu")
    lines = []
    drv = tself.SelfSupContinualDriver(
        _selfsup_cfg(_TS),
        pretrain_data=_f32([[ArrayScene(4, 24, 48, 777, torch_out=True)]])[0][0],
        proxy_search_data=proxy, log=lines.append,
        checkpoint_dir=str(tmp_path), device="cpu")
    matrix = drv.run(train, valid, test)
    assert [ln.split(" loss")[0] for ln in lines
            if ln.startswith("[pretrain")] == ["[pretrain t0] epoch 0",
                                               "[pretrain t1] epoch 0"]
    assert sum(ln.startswith("[selfsup t") for ln in lines) == 4
    assert any(ln.startswith("[op-search t1] epoch") for ln in lines)
    for k in METRICS:
        assert matrix.m[k][1, 0] == matrix.m[k][0, 0], k
        assert np.isfinite(matrix.m[k]).all()
    jnet, manifest = jax_load_checkpoint(str(tmp_path), 1)
    assert manifest["variant"] == "stereo"
    assert jnet.archis == drv.net.archis


@pytest.mark.slow
def test_two_task_selfsup_run_matches_rag_tpu(monkeypatch):
    """Both self-supervised drivers, 2 tasks, float64, from equal initial
    weights; the colour-transferred proxy batches (float32, as both
    packages make them) are cast back to float64 in both."""
    cells = []

    class JaxCellSearch(jmdenas.CellSearch):
        @staticmethod
        def _init_net(key):
            out = np_tree(opt0(jax.jit(jsupernet.init_supernet))(key))
            cells.append(out)
            return out

    class Cast64:
        def __init__(self, ds, torch_out):
            self.ds, self.torch_out = ds, torch_out

        def __len__(self):
            return len(self.ds)

        def batches(self, *a, **kw):
            for b in self.ds.batches(*a, **kw):
                yield {k: (v.double() if self.torch_out else
                           np.asarray(v, np.float64)) for k, v in b.items()}

    class JaxDriver(jself.SelfSupContinualDriver):
        def _cell_search_cls(self):
            return JaxCellSearch

        def _search_data_for(self, t, train_data):
            return Cast64(super()._search_data_for(t, train_data), False)

    inits = Inits(monkeypatch)
    monkeypatch.setattr(jdriver, "OpSearch", _JaxOpSearch)
    train, valid, test = _scenes(4, torch_out=False)
    pre, proxy = ArrayScene(4, 24, 48, 777), ArrayScene(6, 24, 48, 888)
    with _jax_in(np.float64):
        jdrv = JaxDriver(_selfsup_cfg(_JS), pretrain_data=pre,
                         proxy_search_data=proxy, log=None)
        jm = jdrv.run(train, valid, test)

    draws = iter([tuple(to_torch(np_tree(t, np.float64), "cpu") for t in a + b)
                  for a, b in zip(inits.drawn[::2], inits.drawn[1::2])])

    class Driver(tself.SelfSupContinualDriver):
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

        def _search_data_for(self, t, train_data):
            return Cast64(super()._search_data_for(t, train_data), True)

    tdrv = Driver(_selfsup_cfg(_TS), pretrain_data=pre.twin(),
                  proxy_search_data=proxy.twin(), log=None, device="cpu")
    tm = tdrv.run(*(tuple(s.twin() for s in g) for g in (train, valid, test)))
    assert [(g.normal, g.reduce) for g in tdrv.net.genotypes] == \
        [(g.normal, g.reduce) for g in jdrv.net.genotypes]
    assert tdrv.net.archis == jdrv.net.archis
    assert tdrv.net.model_to_train == jdrv.net.model_to_train
    for k in METRICS:
        np.testing.assert_allclose(tm.m[k], jm.m[k], rtol=1e-9, atol=0,
                                   err_msg=k)
