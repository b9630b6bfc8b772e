"""Float32 precision of a train step where BatchNorm trains, in both
packages, measured against float64 (ROADMAP Queue 3, "Float32 train-step
parity where BatchNorm trains"). Run with ``-s`` to print the numbers.

  * BatchNorm's running variance, ``E[x^2] - mean^2`` in float32, for a
    channel whose mean is 20x its spread: the port's error against a
    float64 evaluation of the same formula, and the reference's;
  * the disparity of task 3's fine-tune stage (the committed checkpoint,
    13 BN-train sites, B=2, 48x96, maxdisp 192) in float32, against the
    port in float64 (which equals the reference in float64 to ~1e-11,
    tests/test_torch_port_train_slice.py);
  * one float32 train step of each package from an equal state, random
    weights with every site BN-train ((a) of the slice test): the gap of
    the updates dp/lr in relative L2 over all trainable leaves, and of
    the new statistics.

The port's float32 error is held to bounds that leave it well inside the
reference's; the reference's is printed, and the float32 step gap is held
to a bound that pins its present size (a change in either package's
float32 arithmetic shows here first).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_tpu.continual.state import load_checkpoint as jax_load_checkpoint
from rag_tpu.models import stereo as jstereo
from rag_tpu.ops.convbr_cf import batch_norm_cf as jax_batch_norm_cf
from rag_tpu.train import trainer as jtrainer
from rag_tpu_torch.continual.state import load_checkpoint
from rag_tpu_torch.convert import to_torch
from rag_tpu_torch.models.stereo import stereo_forward
from rag_tpu_torch.ops.convbr_cf import batch_norm_cf
from rag_tpu_torch.train.trainer import make_optimizer, make_train_step
from test_torch_port_train_slice import CKPT, LR, WD, _batch, _flat, _random_state


def test_bn_running_variance_float32_accuracy():
    rng = np.random.default_rng(0)
    x = (10.0 + 0.5 * rng.standard_normal((2, 64, 12, 16, 32))).astype(np.float32)
    p = {"scale": np.ones(12, np.float32), "bias": np.zeros(12, np.float32)}
    s = {"mean": np.zeros(12, np.float32), "var": np.ones(12, np.float32)}
    x64 = x.astype(np.float64)
    mean = x64.mean(axis=(0, 1, 3, 4))
    var = (x64 ** 2).mean(axis=(0, 1, 3, 4)) - mean ** 2
    n = x.size // 12
    ref = 0.9 + 0.1 * var * n / (n - 1)
    _, ns_j = jax_batch_norm_cf(jnp.asarray(x), p, s, True)
    _, ns_t = batch_norm_cf(torch.from_numpy(x), to_torch(p, "cpu"),
                            to_torch(s, "cpu"), True)
    err_j = float(np.abs(np.asarray(ns_j["var"]) - ref).max() / ref.max())
    err_t = float(np.abs(ns_t["var"].numpy() - ref).max() / ref.max())
    print(f"\nrunning variance, mean/spread 20: float32 error vs float64 "
          f"port {err_t:.2e}, reference {err_j:.2e}")
    assert err_t <= 5e-5


def _cast_tree(tree, dtype):
    return {k: _cast_tree(v, dtype) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, dtype)) for k, v in tree.items()}


def test_bn_train_stage_disparity_float32():
    jnet, _ = jax_load_checkpoint(CKPT, 3)
    tnet, _ = load_checkpoint(CKPT, 3, device="cpu")
    sites = tnet.trainable_sites(3)
    specs_j, params_j, stats_j = jnet.path(jnet.archis[3])
    specs_t, _, _ = tnet.path(tnet.archis[3])
    params = jax.tree_util.tree_map(np.asarray, params_j)
    stats = jax.tree_util.tree_map(np.asarray, stats_j)
    left, right, _ = _batch(np.random.default_rng(3), 2, 48, 96, 192)
    disp_j, _ = jstereo.stereo_forward(specs_j, params, stats, left, right,
                                       train_sites=sites, cf_matching=True,
                                       maxdisp=192)
    disp = {}
    for dt in (np.float32, np.float64):
        with torch.no_grad():
            d, _ = stereo_forward(specs_t, _cast_tree(params, dt),
                                  _cast_tree(stats, dt),
                                  torch.from_numpy(left.astype(dt)),
                                  torch.from_numpy(right.astype(dt)),
                                  train_sites=sites, maxdisp=192)
        disp[dt] = d.double().numpy()
    gap_t = float(np.abs(disp[np.float32] - disp[np.float64]).max())
    gap_j = float(np.abs(np.asarray(disp_j, np.float64) - disp[np.float64]).max())
    print(f"\ntask 3 fine-tune stage, float32 disparity vs float64: port "
          f"{gap_t:.2e} px, reference {gap_j:.2e} px")
    assert gap_t <= 5e-3


@pytest.mark.parametrize("seed", [0])
def test_bn_train_step_float32_gap(seed):
    specs_j, specs_t, params, stats, rng = _random_state(seed)
    left, right, gt = _batch(rng, 2, 48, 96, 48)
    bn = frozenset(specs_j)
    opt_j = jtrainer.make_optimizer(WD)
    step_j = jtrainer.make_train_step(
        specs_j, bn, opt_j,
        forward=functools.partial(jstereo.stereo_forward, cf_matching=True),
        maxdisp=48)
    p_j, s_j, _, _ = step_j(params, stats, opt_j.init(params), LR, left,
                            right, gt)
    p_t = to_torch(params, "cpu")
    opt_t = make_optimizer(WD)
    p_t, s_t, _, _ = make_train_step(specs_t, bn, opt_t, maxdisp=48)(
        p_t, to_torch(stats, "cpu"), opt_t.init(p_t), LR,
        torch.from_numpy(left), torch.from_numpy(right), torch.from_numpy(gt))
    old, new_j, new_t = _flat(params), _flat(p_j), _flat(p_t)
    num = sum(float(((new_t[k].astype(np.float64) - new_j[k]) ** 2).sum())
              for k in old)
    den = sum(float(((new_j[k].astype(np.float64) - old[k]) ** 2).sum())
              for k in old)
    st_j, st_t = _flat(s_j), _flat(s_t)
    stats_gap = max(float(np.abs(st_t[k] - st_j[k]).max()
                          / max(1.0, float(np.abs(st_j[k]).max()))) for k in st_j)
    rel_l2 = (num / den) ** 0.5
    print(f"\nfloat32 step, every site BN-train: dp/lr gap {rel_l2:.2e} in "
          f"relative L2, statistics {stats_gap:.2e}")
    assert rel_l2 <= 5e-2 and stats_gap <= 1e-4
