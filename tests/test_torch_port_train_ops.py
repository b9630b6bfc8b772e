"""The port's train-mode ops against the JAX package, on the CPU.

Train-mode BatchNorm (``halves`` 1 and 2, both layouts), and the ConvBR
blocks and cells in train and frozen mode: the output, the new running
statistics (merged same-input conv edges split back per edge), and the
gradient of a random linear scalar of the output with respect to the
input and every parameter leaf, against ``jax.grad`` with the same
weights. The port's 3x3x3 convs run through ``conv3d_brc_cf``'s
``torch.autograd.Function`` (kernel A's and D's plain versions here).

Tolerances: outputs and gradients 1e-5 of the largest magnitude (float32
sums in another order); running statistics 1e-5 of max(1, |stat|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_tpu.ops import cell as jcell
from rag_tpu.ops import convbr as jconvbr
from rag_tpu.ops.convbr_cf import apply_convbr_cf as jax_apply_convbr_cf
from rag_tpu.ops.convbr_cf import batch_norm_cf as jax_batch_norm_cf
from rag_tpu_torch.ops import cell as tcell
from rag_tpu_torch.ops.convbr import ConvBRSpec, apply_convbr, batch_norm
from rag_tpu_torch.ops.convbr_cf import apply_convbr_cf, batch_norm_cf

RTOL = 1e-5
GENES = [
    ((0, 1), (1, 1), (2, 1), (3, 1), (5, 1), (6, 1)),     # default: all conv
    ((0, 1), (1, 0), (2, 1), (4, 1), (6, 1), (7, 1)),     # skips + node edges
]


def _rand(rng, shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _close(out, ref, rtol=RTOL, floor=0.0, msg=""):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (msg, out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0, err_msg=msg,
                               atol=rtol * max(floor, float(np.abs(ref).max())))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _convbr_tree(rng, ndim, cin, cout, k, bn=True):
    p = {"w": _rand(rng, (k,) * ndim + (cin, cout), 0.3)}
    s = {}
    if bn:
        p["scale"] = _rand(rng, (cout,), 0.3) + 1.0
        p["bias"] = _rand(rng, (cout,), 0.2)
        s = {"mean": _rand(rng, (cout,), 0.2),
             "var": (rng.random(cout) + 0.5).astype(np.float32)}
    return p, s


def _cell_tree(rng, spec_j):
    p_j, _ = jcell.init_cell(jax.random.PRNGKey(0), spec_j)
    params, stats = {"ops": {}}, {"ops": {}}
    nd = spec_j.ndim
    if "pre" in p_j:
        params["pre"], stats["pre"] = _convbr_tree(rng, nd, spec_j.c_pp, spec_j.c_out, 1)
    params["prep"], stats["prep"] = _convbr_tree(rng, nd, spec_j.c_p, spec_j.c_out, 1)
    for e in p_j["ops"]:
        params["ops"][e], stats["ops"][e] = _convbr_tree(rng, nd, spec_j.c_out,
                                                         spec_j.c_out, 3)
    return params, stats


def _torch_tree(tree, grad):
    return {k: _torch_tree(v, grad) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)).requires_grad_(grad)
            for k, v in tree.items()}


def _check(fn_j, fn_t, params, stats, inputs, rng):
    """Output, new stats, and d(sum(out * g))/d(inputs, params) of both."""
    def loss_j(p, xs):
        out, ns = fn_j(p, stats, *xs)
        return jnp.sum(out * g), (out, ns)

    out_shape = jax.eval_shape(lambda p, xs: fn_j(p, stats, *xs)[0], params,
                               inputs).shape
    g = _rand(rng, out_shape)
    (_, (out_j, ns_j)), (gp_j, gx_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(params, inputs)

    p_t = _torch_tree(params, True)
    x_t = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    out_t, ns_t = fn_t(p_t, _torch_tree(stats, False), *x_t)
    (out_t * torch.from_numpy(g)).sum().backward()

    _close(out_t, out_j, msg="out")
    fs_j, fs_t = _flat(ns_j), _flat(ns_t)
    assert sorted(fs_t) == sorted(fs_j)
    for k in fs_j:
        _close(fs_t[k], fs_j[k], floor=1.0, msg=k)
    for xt, gx in zip(x_t, gx_j):
        _close(xt.grad, gx, msg="dx")
    fp_j, fp_t = _flat(gp_j), _flat(p_t)
    for k in fp_j:
        grad = fp_t[k].grad
        _close(torch.zeros(fp_t[k].shape) if grad is None else grad, fp_j[k],
               msg=k)


@pytest.mark.parametrize("halves", [1, 2])
def test_batch_norm_train(halves):
    rng = np.random.default_rng(halves)
    p, s = _convbr_tree(rng, 2, 4, 5, 1)
    x = _rand(rng, (4, 6, 7, 5), 2.0) + 0.5
    _check(lambda p_, s_, x_: jconvbr.batch_norm(x_, p_, s_, True, halves=halves),
           lambda p_, s_, x_: batch_norm(x_, p_, s_, True, halves=halves),
           p, s, [x], rng)


def test_batch_norm_cf_train():
    rng = np.random.default_rng(3)
    p, s = _convbr_tree(rng, 3, 4, 6, 1)
    x = _rand(rng, (2, 3, 6, 4, 5), 2.0) - 0.3
    _check(lambda p_, s_, x_: jax_batch_norm_cf(x_, p_, s_, True),
           lambda p_, s_, x_: batch_norm_cf(x_, p_, s_, True),
           p, s, [x], rng)


# 2D blocks: stem_2d0, the stride-3 stem_2d1, the bn/relu-free last_3_2d
@pytest.mark.parametrize("cin,cout,k,stride,bn,relu",
                         [(3, 6, 3, 1, True, True), (6, 12, 3, 3, True, True),
                          (12, 12, 1, 1, False, False)])
@pytest.mark.parametrize("train,halves", [(True, 2), (True, 1), (False, 1)])
def test_apply_convbr_train(cin, cout, k, stride, bn, relu, train, halves):
    rng = np.random.default_rng(cin + cout + k + stride + halves)
    p, s = _convbr_tree(rng, 2, cin, cout, k, bn)
    spec_j = jconvbr.ConvBRSpec(2, cin, cout, k, stride, bn, relu)
    spec_t = ConvBRSpec(2, cin, cout, k, stride, bn, relu)
    x = _rand(rng, (4, 12, 15, cin))
    _check(lambda p_, s_, x_: jconvbr.apply_convbr(spec_j, p_, s_, x_, train,
                                                   halves=halves),
           lambda p_, s_, x_: apply_convbr(spec_t, p_, s_, x_, train, halves),
           p, s, [x], rng)


# channel-first 3D blocks: stem_3d1 (kernel A + train BN), the Cout=1
# head, merged Cout 48, a 1x1x1 pre conv
@pytest.mark.parametrize("cin,cout,k,bn,relu",
                         [(12, 12, 3, True, True), (12, 1, 3, False, False),
                          (16, 48, 3, True, True), (24, 12, 1, True, True)])
@pytest.mark.parametrize("train", [True, False])
def test_apply_convbr_cf_train(cin, cout, k, bn, relu, train):
    rng = np.random.default_rng(cin * 3 + cout + k + train)
    p, s = _convbr_tree(rng, 3, cin, cout, k, bn)
    spec_j = jconvbr.ConvBRSpec(3, cin, cout, k, 1, bn, relu)
    spec_t = ConvBRSpec(3, cin, cout, k, 1, bn, relu)
    x = _rand(rng, (2, 4, cin, 6, 9))
    _check(lambda p_, s_, x_: jax_apply_convbr_cf(spec_j, p_, s_, x_, train),
           lambda p_, s_, x_: apply_convbr_cf(spec_t, p_, s_, x_, train),
           p, s, [x], rng)


@pytest.mark.parametrize("gene", GENES)
@pytest.mark.parametrize("cpp,cp,cout,downup", [(12, 24, 4, +1), (24, 12, 8, -1)])
def test_apply_cell_train(gene, cpp, cp, cout, downup):
    rng = np.random.default_rng(cpp + cp + cout + downup + len(str(gene)))
    spec_j = jcell.CellSpec(2, cpp, cp, cout, downup, gene)
    spec_t = tcell.CellSpec(2, cpp, cp, cout, downup, gene)
    p, s = _cell_tree(rng, spec_j)
    s1 = _rand(rng, (4, 6, 8, cp))
    s0 = _rand(rng, (4, 6, 8, cpp) if downup == -1 else (4, 12, 16, cpp))
    _check(lambda p_, st, a, b: jcell.apply_cell(spec_j, p_, st, a, b, True,
                                                 halves=2),
           lambda p_, st, a, b: tcell.apply_cell(spec_t, p_, st, a, b, True, 2),
           p, s, [s0, s1], rng)


@pytest.mark.parametrize("gene", GENES)
@pytest.mark.parametrize("cpp,cp,cout,downup", [(12, 12, 4, 0), (12, 24, 16, -1),
                                                (24, 48, 8, +1)])
@pytest.mark.parametrize("train", [True, False])
def test_apply_cell_cf_train(gene, cpp, cp, cout, downup, train):
    rng = np.random.default_rng(cpp * 2 + cp + cout + downup + train)
    spec_j = jcell.CellSpec(3, cpp, cp, cout, downup, gene)
    spec_t = tcell.CellSpec(3, cpp, cp, cout, downup, gene)
    p, s = _cell_tree(rng, spec_j)
    s1 = _rand(rng, (2, 4, cp, 6, 8))
    s0 = _rand(rng, (2, 4, cpp, 6, 8) if downup != 1 else (2, 8, cpp, 12, 16))
    _check(lambda p_, st, a, b: jcell.apply_cell_cf(spec_j, p_, st, a, b, train),
           lambda p_, st, a, b: tcell.apply_cell_cf(spec_t, p_, st, a, b, train),
           p, s, [s0, s1], rng)
