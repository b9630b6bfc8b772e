"""Shared pieces of the continual-learning parity tests
(test_torch_port_{supernet,growth,continual}.py): a fixed scene both
packages read in float64, tree helpers, and the comparisons.

``ArrayScene`` holds the host samples of a styled ``SyntheticStereoDataset``
(the port's; its bytes equal rag_tpu's, tests/test_torch_port_router.py)
in float64 and yields them in the datasets' order: ``indices`` (default
all), permuted by ``default_rng(seed_base + seed)`` when shuffled. With
``torch=True`` it yields CPU tensors for the port, else numpy for rag_tpu.
"""

import functools

import jax
import numpy as np
import torch

from rag_tpu.models import growable as jgrowable
from rag_tpu.models import stereo as jstereo
from rag_tpu_torch.convert import to_torch
from rag_tpu_torch.data.synthetic import WEATHER_STYLES, SyntheticStereoDataset

KEYS = ("left", "right", "disparity")
UPD_TOL = 1e-9     # dp/lr, float64: of each leaf's largest |dp/lr|
STATS_TOL = 1e-12  # BN statistics, float64: of max(1, |stat|)


class ArrayScene:
    def __init__(self, n, h, w, seed, style=0, max_disp=12.0, torch_out=False):
        ds = SyntheticStereoDataset(n, h, w, seed=seed, max_disp=max_disp,
                                    style=WEATHER_STYLES[style], device="cpu")
        self.data = {k: v.astype(np.float64) for k, v in ds._samples().items()}
        self.seed = seed
        self.n = n
        self.torch_out = torch_out

    def __len__(self):
        return self.n

    def twin(self):
        """The same scene yielding the other package's arrays."""
        other = ArrayScene.__new__(ArrayScene)
        other.__dict__.update(self.__dict__, torch_out=not self.torch_out)
        return other

    def batches(self, batch_size, shuffle=True, seed=0, indices=None,
                drop_last=True):
        idx = np.asarray(indices if indices is not None else np.arange(self.n))
        if shuffle:
            idx = np.random.default_rng(self.seed + seed).permutation(idx)
        stop = len(idx) - (len(idx) % batch_size) if drop_last else len(idx)
        for i in range(0, stop, batch_size):
            sel = idx[i:i + batch_size]
            b = {k: self.data[k][sel] for k in KEYS}
            yield ({k: torch.from_numpy(v) for k, v in b.items()}
                   if self.torch_out else b)


def np_tree(tree, dtype=None):
    """A nested dict of arrays/tensors as numpy (cast to dtype if given)."""
    if isinstance(tree, dict):
        return {k: np_tree(v, dtype) for k, v in tree.items()}
    # a copy: in-place updates of the tensor must not reach the snapshot
    a = (tree.detach().cpu().numpy().copy() if isinstance(tree, torch.Tensor)
         else np.asarray(tree))
    return a if dtype is None else a.astype(dtype)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np_tree(v)
    return out


def shapes(tree):
    return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def assert_update_close(new_t, new_j, old, lr, tol=UPD_TOL):
    """dp/lr of every leaf within tol of that leaf's largest |dp/lr| (a
    leaf that did not move must not move in either)."""
    new_t, new_j, old = flat(new_t), flat(new_j), flat(old)
    assert sorted(new_t) == sorted(new_j) == sorted(old)
    for k in old:
        du_j = (new_j[k] - old[k]) / lr
        du_t = (new_t[k] - old[k]) / lr
        np.testing.assert_allclose(du_t, du_j, rtol=0, err_msg=k,
                                   atol=tol * float(np.abs(du_j).max()))


def assert_stats_close(st_t, st_j, tol=STATS_TOL):
    st_t, st_j = flat(st_t), flat(st_j)
    assert sorted(st_t) == sorted(st_j)
    for k in st_j:
        np.testing.assert_allclose(
            st_t[k], st_j[k], rtol=0, err_msg=k,
            atol=tol * max(1.0, float(np.abs(st_j[k]).max())))


def assert_trees_equal(a, b):
    a, b = flat(a), flat(b)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# XLA's lowest optimization level: the JAX side's compile time dominates
# these tests, and its numerics stay float64
OPT0 = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def opt0(jitted):
    """``jitted`` compiled with OPT0 at its first call's argument types."""
    compiled = []

    def run(*args):
        if not compiled:
            compiled.append(jitted.lower(*args).compile(OPT0))
        return compiled[0](*args)

    return run


class Recorder:
    """A MetricWriter stand-in that keeps every scalars() record."""

    def __init__(self):
        self.records = []

    def scalars(self, tag, values, step=0):
        self.records.append((tag, step, {k: float(v) for k, v in values.items()}))

    def text(self, tag, value, step=0):
        self.records.append((tag, step, value))


_INIT = {}


def fast_init_sites(key, specs):
    """rag_tpu's init_sites, compiled once per spec set (its eager form
    spends tens of seconds compiling each random op)."""
    sig = (tuple(sorted(specs.items())), jax.config.jax_enable_x64)
    if sig not in _INIT:
        _INIT[sig] = opt0(jax.jit(functools.partial(jstereo.init_sites,
                                                    specs=dict(specs))))
    return _INIT[sig](key)


class Inits:
    """Patches rag_tpu's growable registry to the compiled init_sites and
    keeps every (params, stats) it draws, as numpy."""

    def __init__(self, monkeypatch):
        self.drawn = []

        def init(key, specs):
            out = fast_init_sites(key, specs)
            self.drawn.append(tuple(np_tree(t) for t in out))
            return out

        monkeypatch.setattr(jgrowable, "init_sites", init)

    def last_two(self):
        """(site params, site stats, head params, head stats) of the last
        draw of sites and heads, as the port's injected weights."""
        (sp, ss), (hp, hs) = self.drawn[-2:]
        return tuple(to_torch(t, "cpu") for t in (sp, ss, hp, hs))
