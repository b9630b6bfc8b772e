"""The port's plain ops against the JAX package, on the CPU, frozen BN.

Same numpy inputs and weights go to both packages (weights through
rag_tpu_torch.convert). Tolerances: interpolation matrices and the cost
volume are exact; convs and cells agree to f32 summation-order noise,
1e-5 of the output's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_tpu.metrics.stereo import stereo_metrics as jax_stereo_metrics
from rag_tpu.ops import cell as jcell
from rag_tpu.ops import convbr as jconvbr
from rag_tpu.ops.convbr_cf import apply_convbr_cf as jax_apply_convbr_cf
from rag_tpu.ops.convbr_cf import batch_norm_cf as jax_batch_norm_cf
from rag_tpu.ops.cost_volume import cost_volume_cf as jax_cost_volume_cf
from rag_tpu.ops.pallas_resize import resize_cf as jax_resize_cf
from rag_tpu.ops.resize import _interp_matrix_np as jax_interp_matrix_np
from rag_tpu.ops.resize import resize_linear as jax_resize_linear
from rag_tpu.ops.resize import scale_dimension as jax_scale_dimension
from rag_tpu.search.genotype import default_genotype as jax_default_genotype
from rag_tpu.train.trainer import supervised_loss as jax_supervised_loss
from rag_tpu_torch.convert import to_torch
from rag_tpu_torch.metrics.stereo import stereo_metrics
from rag_tpu_torch.ops import cell as tcell
from rag_tpu_torch.ops.convbr import ConvBRSpec, apply_convbr, batch_norm
from rag_tpu_torch.ops.convbr_cf import apply_convbr_cf, batch_norm_cf
from rag_tpu_torch.ops.cost_volume import cost_volume_cf
from rag_tpu_torch.ops.resize import (
    _interp_matrix_np,
    resize_cf,
    resize_linear,
    scale_dimension,
)
from rag_tpu_torch.search.genotype import default_genotype
from rag_tpu_torch.train.trainer import supervised_loss

RTOL = 1e-5  # of max |ref|


def _close(out, ref, rtol=RTOL):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rtol * max(1.0, float(np.abs(ref).max())))


def _rand(rng, shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _convbr_tree(rng, spec_j):
    """Random params/stats for a JAX ConvBRSpec, BN stats away from identity."""
    k = (spec_j.kernel,) * spec_j.ndim
    p = {"w": _rand(rng, k + (spec_j.cin, spec_j.cout), 0.3)}
    s = {}
    if spec_j.bn:
        p["scale"] = _rand(rng, (spec_j.cout,), 0.3) + 1.0
        p["bias"] = _rand(rng, (spec_j.cout,), 0.2)
        s = {"mean": _rand(rng, (spec_j.cout,), 0.2),
             "var": (rng.random(spec_j.cout) + 0.5).astype(np.float32)}
    return p, s


def _cell_tree(rng, spec_j):
    """Random params/stats for a JAX CellSpec (init_cell's tree shape)."""
    p_j, _ = jcell.init_cell(jax.random.PRNGKey(0), spec_j)

    def fill(cin, cout, kern):
        return _convbr_tree(rng, jconvbr.ConvBRSpec(spec_j.ndim, cin, cout, kern))

    params, stats = {"ops": {}}, {"ops": {}}
    if "pre" in p_j:
        params["pre"], stats["pre"] = fill(spec_j.c_pp, spec_j.c_out, 1)
    params["prep"], stats["prep"] = fill(spec_j.c_p, spec_j.c_out, 1)
    for e in p_j["ops"]:
        params["ops"][e], stats["ops"][e] = fill(spec_j.c_out, spec_j.c_out, 3)
    return params, stats


@pytest.mark.parametrize("n_in,n_out", [(5, 10), (10, 5), (64, 192), (7, 4),
                                        (32, 16), (1, 3), (4, 1), (6, 6)])
@pytest.mark.parametrize("ac", [True, False])
def test_interp_matrix_bit_exact(n_in, n_out, ac):
    np.testing.assert_array_equal(_interp_matrix_np(n_in, n_out, ac),
                                  jax_interp_matrix_np(n_in, n_out, ac))


def test_scale_dimension():
    for dim in range(1, 40):
        for s in (0.5, 2.0):
            assert scale_dimension(dim, s) == jax_scale_dimension(dim, s)


@pytest.mark.parametrize("ac", [True, False])
def test_resize_linear_nhwc(ac):
    x = _rand(np.random.default_rng(1), (2, 9, 14, 5))
    for target in [(5, 7), (18, 28), (9, 3)]:
        _close(resize_linear(torch.from_numpy(x), target, (1, 2), ac),
               jax_resize_linear(jnp.asarray(x), target, (1, 2), ac))


@pytest.mark.parametrize("ac", [True, False])
def test_resize_cf(ac):
    x = _rand(np.random.default_rng(2), (1, 6, 3, 8, 10))
    for d2, h2, w2 in [(3, 4, 5), (12, 16, 20), (6, 8, 10)]:
        _close(resize_cf(torch.from_numpy(x), d2, h2, w2, ac),
               jax_resize_cf(jnp.asarray(x), d2, h2, w2, ac))


def test_cost_volume_cf_exact():
    rng = np.random.default_rng(3)
    x, y = _rand(rng, (2, 5, 9, 4)), _rand(rng, (2, 5, 9, 4))
    out = cost_volume_cf(torch.from_numpy(x), torch.from_numpy(y), 6)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jax_cost_volume_cf(jnp.asarray(x), jnp.asarray(y), 6)))


# 2D blocks of the feature net: stem_2d0, the stride-3 stem_2d1 (padding 1),
# stem_2d2, and the bn/relu-free 1x1 last_3_2d
CONVBR_2D = [(3, 6, 3, 1, True, True), (6, 12, 3, 3, True, True),
             (12, 12, 3, 1, True, True), (12, 12, 1, 1, False, False)]


@pytest.mark.parametrize("cin,cout,k,stride,bn,relu", CONVBR_2D)
def test_apply_convbr_2d(cin, cout, k, stride, bn, relu):
    rng = np.random.default_rng(cin + cout + k + stride)
    spec_j = jconvbr.ConvBRSpec(2, cin, cout, k, stride, bn, relu)
    p, s = _convbr_tree(rng, spec_j)
    x = _rand(rng, (2, 24, 30, cin))
    ref, _ = jconvbr.apply_convbr(spec_j, p, s, jnp.asarray(x), False)
    stats = to_torch(s, "cpu")
    out, new_stats = apply_convbr(ConvBRSpec(2, cin, cout, k, stride, bn, relu),
                                  to_torch(p, "cpu"), stats, torch.from_numpy(x))
    _close(out, ref)
    assert new_stats is stats


def test_batch_norm_frozen_both_layouts():
    rng = np.random.default_rng(4)
    spec_j = jconvbr.ConvBRSpec(3, 4, 6, 1)
    p, s = _convbr_tree(rng, spec_j)
    x = _rand(rng, (2, 3, 5, 4, 6))
    ref, _ = jconvbr.batch_norm(jnp.asarray(x), p, s, False)
    _close(batch_norm(torch.from_numpy(x), to_torch(p, "cpu"), to_torch(s, "cpu"))[0], ref)
    xc = _rand(rng, (2, 3, 6, 4, 5))
    ref_cf, _ = jax_batch_norm_cf(jnp.asarray(xc), p, s, False)
    _close(batch_norm_cf(torch.from_numpy(xc), to_torch(p, "cpu"),
                         to_torch(s, "cpu"))[0], ref_cf)


# channel-first 3D blocks: stem_3d1, the Cout=1 head, merged Cout=48,
# and the 1x1 pre/prep/head convs
CONVBR_CF = [(12, 12, 3, True, True), (12, 1, 3, False, False),
             (16, 48, 3, True, True), (24, 12, 1, True, True),
             (48, 24, 1, True, True)]


@pytest.mark.parametrize("cin,cout,k,bn,relu", CONVBR_CF)
def test_apply_convbr_cf(cin, cout, k, bn, relu):
    rng = np.random.default_rng(cin * 3 + cout + k)
    spec_j = jconvbr.ConvBRSpec(3, cin, cout, k, 1, bn, relu)
    p, s = _convbr_tree(rng, spec_j)
    x = _rand(rng, (1, 4, cin, 8, 11))
    ref, _ = jax_apply_convbr_cf(spec_j, p, s, jnp.asarray(x), False)
    stats = to_torch(s, "cpu")
    out, new_stats = apply_convbr_cf(ConvBRSpec(3, cin, cout, k, 1, bn, relu),
                                     to_torch(p, "cpu"), stats, torch.from_numpy(x))
    _close(out, ref)
    assert new_stats is stats


GENES = [
    ((0, 1), (1, 1), (2, 1), (3, 1), (5, 1), (6, 1)),     # default: all conv
    ((0, 1), (1, 0), (2, 1), (4, 1), (6, 1), (7, 1)),     # skips + node edges
    ((0, 0), (1, 1), (3, 1), (4, 0), (7, 0), (8, 1)),
]


def test_gene_helpers_match():
    assert default_genotype().normal == jax_default_genotype().normal
    for g in GENES:
        shuffled = list(reversed(g))
        assert tcell.canonicalize_gene(shuffled) == jcell.canonicalize_gene(shuffled)
        assert tcell._edge_groups(g) == jcell._edge_groups(g)
    with pytest.raises(ValueError):
        tcell.canonicalize_gene([(0, 1), (1, 1), (2, 1), (3, 1), (5, 1), (9, 1)])


# 2D cells: (c_pp, c_p, c_out, downup) from the feature-net plan
CELL2D = [(12, 12, 8, -1), (12, 24, 4, +1), (24, 12, 8, -1)]


@pytest.mark.parametrize("gene", GENES)
@pytest.mark.parametrize("cpp,cp,cout,downup", CELL2D)
def test_apply_cell_2d(gene, cpp, cp, cout, downup):
    rng = np.random.default_rng(cpp + cp + cout + downup + len(str(gene)))
    spec_j = jcell.CellSpec(2, cpp, cp, cout, downup, gene)
    p, s = _cell_tree(rng, spec_j)
    s1 = _rand(rng, (2, 12, 16, cp))
    s0 = _rand(rng, (2, 12, 16, cpp) if downup == -1 else (2, 24, 32, cpp))
    ref, _ = jcell.apply_cell(spec_j, p, s, jnp.asarray(s0), jnp.asarray(s1), False)
    out, _ = tcell.apply_cell(tcell.CellSpec(2, cpp, cp, cout, downup, gene),
                           to_torch(p, "cpu"), to_torch(s, "cpu"),
                           torch.from_numpy(s0), torch.from_numpy(s1))
    _close(out, ref)


# 3D cells from the matching-net plan: keep, halve (Cout 16 -> merged 48),
# double
CELL3D = [(12, 12, 4, 0), (12, 24, 16, -1), (24, 48, 8, +1)]


@pytest.mark.parametrize("gene", GENES)
@pytest.mark.parametrize("cpp,cp,cout,downup", CELL3D)
def test_apply_cell_cf(gene, cpp, cp, cout, downup):
    rng = np.random.default_rng(cpp * 2 + cp + cout + downup + len(str(gene)))
    spec_j = jcell.CellSpec(3, cpp, cp, cout, downup, gene)
    p, s = _cell_tree(rng, spec_j)
    s1 = _rand(rng, (1, 4, cp, 8, 10))
    s0 = _rand(rng, (1, 4, cpp, 8, 10) if downup != 1 else (1, 8, cpp, 16, 20))
    ref, _ = jcell.apply_cell_cf(spec_j, p, s, jnp.asarray(s0), jnp.asarray(s1), False)
    out, _ = tcell.apply_cell_cf(tcell.CellSpec(3, cpp, cp, cout, downup, gene),
                              to_torch(p, "cpu"), to_torch(s, "cpu"),
                              torch.from_numpy(s0), torch.from_numpy(s1))
    _close(out, ref)


def test_metrics_and_loss_per_image_rule():
    """D1/EPE/Thres and the masked loss, with one image kept, one skipped
    by the <10% coverage rule and one without any gt > 0."""
    rng = np.random.default_rng(5)
    gt = (rng.random((3, 12, 16)) * 60).astype(np.float32)
    gt[1, :, :] = 250.0          # all gt > 0 but outside maxdisp: skipped
    gt[1, 0, :3] = 5.0
    gt[2] = 0.0                  # no gt > 0: weight 0
    est = gt + _rand(rng, gt.shape, 4.0)
    loss_t, mask_t = supervised_loss(torch.from_numpy(est), torch.from_numpy(gt), 192)
    loss_j, mask_j = jax_supervised_loss(jnp.asarray(est), jnp.asarray(gt), 192)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    got = stereo_metrics(torch.from_numpy(est), torch.from_numpy(gt), mask_t)
    ref = jax_stereo_metrics(jnp.asarray(est), jnp.asarray(gt), mask_j)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6, atol=1e-7)
