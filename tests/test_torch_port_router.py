"""The port's Scene Router path against the JAX package, on the CPU.

  * synthetic data: ``synthetic_stereo_batch`` and
    ``SyntheticStereoDataset`` give rag_tpu's bytes for every weather style
    (the rain style's noise draw too) at an even and an odd size, and
    ``batches`` its order; ``DeviceCache`` keeps sets under its budget,
    least recently used out, and a set over the budget on the host;
  * the router: logits and task ids of the committed
    ``logs/canonical_learn_r4/router.npz`` at an even and an odd size (the
    two cases of "SAME" padding at stride 2), one Adam step in float64,
    ``SceneRouter.train`` over two epochs, and ``router.npz`` files read
    across the packages;
  * routed serving: ``RoutedInference(net, router)`` with the committed
    checkpoint and router, ``predict`` and ``evaluate`` with task=None.

Weights and optimizer state pass between the packages through
``state_arrays`` / ``load_arrays``; inputs are made with numpy from seeds.

Tolerances. Logits in float32: 1e-5 of the largest |logit| (three convs
and two reductions summed in another order). In float64 (JAX with x64 for
the call): one step's params, mu and nu within 1e-12 of each leaf's
largest value, the loss within 1e-12 relative; two epochs' params within
1e-10 of each leaf's largest value (8 steps of Adam divide by sqrt(nu),
which amplifies rounding where a gradient is near zero). Disparity and
metrics at tests/test_torch_port_slice.py's bounds.
"""

import contextlib
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rag_tpu.continual.inference import RoutedInference as JaxRoutedInference
from rag_tpu.continual.state import load_checkpoint as jax_load_checkpoint
from rag_tpu.continual.state import load_router as jax_load_router
from rag_tpu.continual.state import save_router as jax_save_router
from rag_tpu.data import synthetic as jsyn
from rag_tpu.models import router as jrouter
from rag_tpu_torch.continual.inference import RoutedInference
from rag_tpu_torch.continual.state import load_checkpoint, load_router, save_router
from rag_tpu_torch.data import synthetic as tsyn
from rag_tpu_torch.models import router as trouter

ROOT = Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "logs" / "canonical_learn_r4")
DISP_ATOL = 1e-3       # px, every pixel (tests/test_torch_port_slice.py)
DISP_MEAN_ATOL = 1e-4  # px, mean over the image
LOGIT_RTOL = 1e-5      # of max |logit|, float32
STEP_RTOL = 1e-12      # of a leaf's max |value|, one step in float64
TRAIN_RTOL = 1e-10     # of a leaf's max |value|, two epochs in float64


@contextlib.contextmanager
def _jax_float64():
    """rag_tpu in float64: x64 on and jnp.float32 pointed at float64 until
    the block ends (as tests/test_torch_port_train_slice.py does)."""
    saved = jnp.float32, os.environ.get("RAG_TPU_COMPUTE_DTYPE")
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    os.environ["RAG_TPU_COMPUTE_DTYPE"] = "float64"
    try:
        yield
    finally:
        jnp.float32 = saved[0]
        if saved[1] is None:
            os.environ.pop("RAG_TPU_COMPUTE_DTYPE")
        else:
            os.environ["RAG_TPU_COMPUTE_DTYPE"] = saved[1]
        jax.config.update("jax_enable_x64", False)


def _scene(pkg, t, n, h, w, seed0=30, **kw):
    """Styled scene t of either package (port: on the CPU)."""
    if pkg is tsyn:
        kw.setdefault("device", "cpu")
    return pkg.SyntheticStereoDataset(n, h, w, seed=seed0 + t, max_disp=24.0,
                                      style=pkg.WEATHER_STYLES[t], **kw)


# -- synthetic data ----------------------------------------------------------

SIZES = [(24, 48), (23, 47)]


@pytest.mark.parametrize("hw", SIZES, ids=["even", "odd"])
@pytest.mark.parametrize("style", range(4))
def test_synthetic_bytes(style, hw):
    """The same draws in the same order: equal bytes for one batch and for
    a dataset of two chunks (16 + 2 samples)."""
    assert tsyn.WEATHER_STYLES == jsyn.WEATHER_STYLES
    ref = jsyn.synthetic_stereo_batch(np.random.default_rng(style), 3, *hw,
                                      20.0, style=jsyn.WEATHER_STYLES[style])
    got = tsyn.synthetic_stereo_batch(np.random.default_rng(style), 3, *hw,
                                      20.0, style=tsyn.WEATHER_STYLES[style])
    ref_set = _scene(jsyn, style, 18, *hw)._samples()
    got_set = _scene(tsyn, style, 18, *hw)._samples()
    for r, g in ((ref, got), (ref_set, got_set)):
        assert sorted(g) == sorted(r) == ["disparity", "left", "right"]
        for k in r:
            assert g[k].dtype == r[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batches_order(seed, drop_last):
    """Shuffled and in-order batches, with and without ``indices``: the
    reference's samples in the reference's order, as CPU tensors."""
    ref_ds, got_ds = _scene(jsyn, 2, 7, 12, 24), _scene(tsyn, 2, 7, 12, 24)
    for kw in ({"shuffle": True, "seed": seed},
               {"shuffle": False, "seed": seed},
               {"shuffle": True, "seed": seed, "indices": [6, 1, 4, 3, 0]}):
        ref = list(ref_ds.batches(3, drop_last=drop_last, **kw))
        got = list(got_ds.batches(3, drop_last=drop_last, **kw))
        assert len(got) == len(ref) > 0
        for r, g in zip(ref, got):
            assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                       for v in g.values())
            for k in r:
                np.testing.assert_array_equal(g[k].numpy(), r[k], err_msg=k)


def _set_bytes(ds):
    return sum(v.nbytes for v in ds._samples().values())


def test_device_cache_within_budget():
    cache = tsyn.DeviceCache(2**30)
    ds = _scene(tsyn, 0, 2, 16, 32, cache=cache)
    b = next(ds.batches(2, False))
    assert ds._dev is not None and cache.nbytes == _set_bytes(ds)
    assert cache.lru == [ds]
    np.testing.assert_array_equal(b["left"].numpy(), ds._samples()["left"])


def test_device_cache_over_budget_copies_batches(capsys):
    """A set over the budget stays on the host, says so, and still yields
    the same batches as tensors on its device."""
    cache = tsyn.DeviceCache(0)
    ds = _scene(tsyn, 1, 3, 16, 32, cache=cache)
    got = list(ds.batches(2, True, seed=1, drop_last=False))
    assert ds._dev is None and cache.nbytes == 0 and cache.lru == []
    assert "exceeds the device cache budget" in capsys.readouterr().out
    ref = list(_scene(jsyn, 1, 3, 16, 32).batches(2, True, seed=1,
                                                  drop_last=False))
    assert len(got) == len(ref) == 2
    for r, g in zip(ref, got):
        for k in r:
            np.testing.assert_array_equal(g[k].numpy(), r[k])


def test_device_cache_lru_eviction(capsys):
    """Room for 1.5 sets: caching the second evicts the first; touching the
    first again evicts the second."""
    one = _set_bytes(_scene(tsyn, 0, 2, 16, 32))
    cache = tsyn.DeviceCache(int(one * 1.5))
    a = _scene(tsyn, 0, 2, 16, 32, cache=cache)
    b = _scene(tsyn, 1, 2, 16, 32, cache=cache)
    next(a.batches(2))
    next(b.batches(2))
    assert a._dev is None and b._dev is not None and cache.lru == [b]
    assert "evicting" in capsys.readouterr().out
    next(a.batches(2))
    assert b._dev is None and a._dev is not None and cache.lru == [a]
    assert cache.nbytes == one


def test_device_cache_recency_protects_hot_set():
    one = _set_bytes(_scene(tsyn, 0, 2, 16, 32))
    cache = tsyn.DeviceCache(int(one * 2.5))
    a, b, c = (_scene(tsyn, t, 2, 16, 32, cache=cache) for t in range(3))
    for ds in (a, b, a, c):
        next(ds.batches(2))
    assert b._dev is None and a._dev is not None and c._dev is not None
    assert cache.lru == [a, c] and cache.nbytes == 2 * one


# -- the router ----------------------------------------------------------------

@pytest.fixture(scope="module")
def routers():
    return jax_load_router(CKPT), load_router(CKPT, device="cpu")


@pytest.mark.parametrize("hw", [(96, 192), (95, 191)], ids=["even", "odd"])
def test_router_logits_committed(routers, hw):
    """Two frames from each styled scene; an odd size pads (1, 1) where an
    even one pads (0, 1)."""
    jr, tr = routers
    left = np.concatenate([_scene(jsyn, t, 2, *hw)._samples()["left"]
                           for t in range(4)])
    ref = np.asarray(jrouter.router_logits(jr.params, left))
    got = trouter.router_logits(tr.params, torch.from_numpy(left)).numpy()
    assert got.shape == ref.shape == (8, 4)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=LOGIT_RTOL * np.abs(ref).max())
    np.testing.assert_array_equal(tr.predict(left), jr.predict(left))
    np.testing.assert_array_equal(tr.predict(left), np.repeat(range(4), 2))


def test_same_padding_matches_xla():
    """_same_pad is XLA's "SAME" at stride 2 with a 3-tap kernel."""
    for n in range(1, 40):
        lo, hi = trouter._same_pad(n)
        pads = jax.lax.padtype_to_pads((n,), (3,), (2,), "SAME")
        assert (lo, hi) == tuple(pads[0]), n


def _leaf_close(got, ref, rtol):
    for k in sorted(ref):
        r = np.asarray(ref[k])
        assert got[k].dtype == r.dtype, k
        if r.dtype.kind == "i":
            np.testing.assert_array_equal(got[k], r, err_msg=k)
            continue
        np.testing.assert_allclose(got[k], r, rtol=0, err_msg=k,
                                   atol=rtol * max(float(np.abs(r).max()),
                                                   1e-300))


def _as(arrays, dtype):
    return {k: v.astype(dtype) if v.dtype.kind == "f" else v
            for k, v in arrays.items()}


@pytest.mark.parametrize("state", ["fresh", "committed"])
def test_router_train_step_float64(state):
    """One make_router_train_step from an equal state (a fresh router's, at
    count 0, or the committed file's, at count 864) and an equal batch of
    mixed scenes: params, mu and nu within 1e-12 of each leaf's max, the
    count equal, the loss within 1e-12."""
    with _jax_float64():
        jr = jrouter.SceneRouter(4, seed=3)
        if state == "committed":
            jr.load_arrays(dict(np.load(os.path.join(CKPT, "router.npz"))))
        arrays = _as(jr.state_arrays(), np.float64)
        jr.load_arrays(arrays)
        left = np.concatenate([_scene(jsyn, t, 2, 24, 48)._samples()["left"]
                               for t in range(4)]).astype(np.float64)
        labels = np.array([0, 1, 1, 2, 3, 3, 0, 2], np.int32)
        params, opt_state, loss_j = jr._step(jr.params, jr.opt_state, left,
                                             labels)
        jr.params, jr.opt_state = params, opt_state
        ref = jr.state_arrays()
        loss_j = float(loss_j)
    tr = trouter.SceneRouter(4, device="cpu")
    tr.load_arrays(arrays)
    tr.params, tr.opt_state, loss_t = tr._step(
        tr.params, tr.opt_state, torch.from_numpy(left),
        torch.from_numpy(labels).long())
    got = tr.state_arrays()
    assert sorted(got) == sorted(ref) and len(ref) == 16
    assert ref["router_leaf_5"].dtype == np.int32
    assert int(got["router_leaf_5"]) == int(arrays["router_leaf_5"]) + 1
    _leaf_close(got, ref, STEP_RTOL)
    np.testing.assert_allclose(float(loss_t), loss_j, rtol=STEP_RTOL)


def _train_scenes(pkg):
    return [_scene(pkg, t, 4, 24, 48, seed0=10) for t in (1, 2)]


class _Float64:
    """A dataset whose batches are cast to float64 (rag_tpu's convs take
    one dtype)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def batches(self, *a, **kw):
        for b in self.ds.batches(*a, **kw):
            yield {k: v.astype(np.float64) for k, v in b.items()}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_scene_router_train(dtype):
    """Two epochs of SceneRouter.train on two styled scenes of 4 pairs,
    batch 2, from an equal state: in float64 every leaf within 1e-10 of its
    max; in float32 the same predictions on held-out frames."""
    ctx = _jax_float64() if dtype is np.float64 else contextlib.nullcontext()
    held_out = np.concatenate([_scene(jsyn, t, 3, 24, 48)._samples()["left"]
                               for t in (1, 2)])
    with ctx:
        jr = jrouter.SceneRouter(2, seed=5)
        arrays = _as(jr.state_arrays(), dtype)
        jr.load_arrays(arrays)
        scenes = _train_scenes(jsyn)
        if dtype is np.float64:
            scenes = [_Float64(d) for d in scenes]
        jr.train(scenes, epochs=2, batch=2)
        ref = jr.state_arrays()
        ref_pred = jr.predict(held_out.astype(dtype))
    tr = trouter.SceneRouter(2, device="cpu")
    tr.load_arrays(arrays)
    lines = []
    losses = tr.train(_train_scenes(tsyn), epochs=2, batch=2, log=lines.append)
    got = tr.state_arrays()
    assert int(got["router_leaf_5"]) == int(ref["router_leaf_5"]) == 8
    assert lines == [f"[router] epoch {e} loss {x:.4f}"
                     for e, x in enumerate(losses)]
    if dtype is np.float64:
        _leaf_close(got, ref, TRAIN_RTOL)
    np.testing.assert_array_equal(tr.predict(held_out), ref_pred)


def test_router_files_across_packages(tmp_path, routers):
    """A router.npz written by either package loads in the other with the
    same leaves, predicts the same ids and keeps trained_task."""
    jr, tr = routers
    left = np.concatenate([_scene(jsyn, t, 1, 48, 96)._samples()["left"]
                           for t in range(4)])
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    saved, tr.trained_task = tr.trained_task, 3
    try:
        save_router(str(port_dir), tr)
    finally:
        tr.trained_task = saved
    from_port = jax_load_router(str(port_dir))
    assert from_port.trained_task == 3 and from_port.num_tasks == 4
    saved, jr.trained_task = jr.trained_task, 2
    try:
        jax_save_router(str(jax_dir), jr)
    finally:
        jr.trained_task = saved
    from_jax = load_router(str(jax_dir), device="cpu")
    assert from_jax.trained_task == 2 and from_jax.input_key == "left"
    for a, b in ((from_port.state_arrays(), tr.state_arrays()),
                 (from_jax.state_arrays(), jr.state_arrays())):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ids = jr.predict(left)
    for r in (from_port, from_jax, tr):
        np.testing.assert_array_equal(r.predict(left), ids)
    assert load_router(str(tmp_path / "none"), device="cpu") is None


def test_committed_router_file(routers):
    """The committed file has no trained_task (-1), 16 leaves in the
    reference's order, count 864, and round-trips unchanged."""
    jr, tr = routers
    with np.load(os.path.join(CKPT, "router.npz")) as npz:
        data = dict(npz)
    assert "trained_task" not in data and tr.trained_task == -1
    assert tr.num_tasks == 4 and tr.input_key == "left"
    got = tr.state_arrays()
    assert sorted(got) == sorted(k for k in data if k.startswith("router_"))
    for k, v in got.items():
        assert v.dtype == data[k].dtype, k
        np.testing.assert_array_equal(v, data[k], err_msg=k)
    assert int(got["router_leaf_5"]) == 864
    flat, _ = jax.tree_util.tree_flatten((jr.params, jr.opt_state))
    assert [tuple(np.shape(x)) for x in flat] == [v.shape for v in got.values()]
    with pytest.raises(ValueError):
        trouter.SceneRouter(3, device="cpu").load_arrays(data)


# -- routed serving ----------------------------------------------------------

@pytest.fixture(scope="module")
def nets():
    return (jax_load_checkpoint(CKPT, 3)[0],
            load_checkpoint(CKPT, 3, device="cpu")[0])


def test_routed_predict_committed(nets, routers):
    """A batch of frames from scenes 1 and 2 at 96x192: routed per frame
    to two task paths, as rag_tpu routes them, and the same disparity."""
    (jnet, tnet), (jr, tr) = nets, routers
    ref_sets = [_scene(jsyn, t, 1, 96, 192)._samples() for t in (1, 2)]
    left, right = (np.concatenate([s[k] for s in ref_sets])
                   for k in ("left", "right"))
    ri = RoutedInference(tnet, router=tr, device="cpu")
    jri = JaxRoutedInference(jnet, router=jr)
    np.testing.assert_array_equal(ri.route(left), jri.route(left))
    np.testing.assert_array_equal(ri.route(left), [1, 2])
    ref = jri.predict(left, right)
    out = ri.predict(left, right)
    assert out.shape == (2, 96, 192) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=DISP_ATOL, rtol=0)
    assert np.abs(out - ref).mean() <= DISP_MEAN_ATOL
    np.testing.assert_array_equal(out[1:], ri.predict(left[1:], right[1:],
                                                      task=2))


def test_routed_evaluate_committed(nets, routers):
    """evaluate(dataset, task=None) on a styled scene of the port (CPU
    tensors) and of rag_tpu (numpy): loss and EPE within DISP_ATOL, the
    rates within one pixel's weight."""
    (jnet, tnet), (jr, tr) = nets, routers
    ref = JaxRoutedInference(jnet, router=jr).evaluate(
        _scene(jsyn, 3, 2, 48, 96))
    ri = RoutedInference(tnet, router=tr, device="cpu")
    got = ri.evaluate(_scene(tsyn, 3, 2, 48, 96))
    assert sorted(got) == sorted(ref)
    one_pixel = 1.0 / (48 * 96 * 0.5)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=DISP_ATOL if k in ("loss", "EPE")
                                   else one_pixel + 1e-7)
    assert got == ri.evaluate(_scene(tsyn, 3, 2, 48, 96), task=3)
