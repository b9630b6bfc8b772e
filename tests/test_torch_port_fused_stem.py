"""The shear-collapsed stem in plain PyTorch (rag_tpu_torch/ops/
fused_stem.py::cost_stem_z) against rag_tpu's jnp one (rag_tpu/ops/
fused_stem.py), and as a reference of the port's stem kernels, on the CPU.

- ``cost_stem_z`` equals rag_tpu's bit for bit on integer inputs at
  tests/test_fused_stem.py's five shapes (D > W, one plane, D = 2 among
  them), and equals the materialized volume + conv of the port.
- Its gradients in x, y and w3 (autograd) against jax.grad of rag_tpu's
  within rtol = atol = 1e-5.
- No path of the port runs it (rag_tpu's ``RAG_TPU_FUSED_STEM`` branch
  has no counterpart: it lost to kernel B on the card). It holds, builds
  no volume, the plain versions behind kernel B's serving and training
  stems (B; E and F) and the shear stem's (J; K), in float32 and with
  bf16 features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rag_tpu.ops import fused_stem as jfused
from rag_tpu_torch.ops import cvstem as cvstem_mod
from rag_tpu_torch.ops import fused_stem as tfused
from rag_tpu_torch.ops import shear as shear_mod
from rag_tpu_torch.ops.conv3d import conv3d_brc_cf_plain
from rag_tpu_torch.ops.cost_volume import cost_volume_cf

GRAD_TOL = 1e-5
F32_RTOL = 1e-5  # of the largest |value|: float32 sums in another order

SHAPES = [
    (2, 3, 8, 10, 5, 4),
    (1, 2, 5, 6, 7, 3),     # D > W (the all-zero band j - d <= -3)
    (1, 4, 6, 12, 4, 5),
    (1, 1, 4, 5, 1, 2),     # one disparity plane (both D fixes on d = 0)
    (1, 2, 4, 4, 2, 2),
]


@pytest.mark.parametrize("b,c,h,w,d,co", SHAPES)
def test_cost_stem_z_bit_exact(b, c, h, w, d, co):
    rng = np.random.default_rng(b * 100 + w + d)
    x = rng.integers(-3, 4, (b, c, h, w)).astype(np.float32)
    y = rng.integers(-3, 4, (b, c, h, w)).astype(np.float32)
    w3 = rng.integers(-2, 3, (3, 3, 3, 2 * c, co)).astype(np.float32)
    ref = np.asarray(jfused.cost_stem_z(jnp.asarray(x), jnp.asarray(y),
                                        jnp.asarray(w3), d))
    xt, yt, wt = (torch.from_numpy(a) for a in (x, y, w3))
    got = tfused.cost_stem_z(xt, yt, wt, d)
    assert got.shape == (b, d, co, h, w) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    vol = cost_volume_cf(xt.permute(0, 2, 3, 1), yt.permute(0, 2, 3, 1), d)
    mat = conv3d_brc_cf_plain(vol, wt, torch.ones(co), torch.zeros(co), False)
    np.testing.assert_array_equal(got.numpy(), mat.numpy())


def test_cost_stem_z_gradients_match_jax():
    rng = np.random.default_rng(0)
    b, c, h, w, d, co = 1, 2, 6, 8, 4, 3
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    y = rng.standard_normal((b, c, h, w)).astype(np.float32)
    w3 = (rng.standard_normal((3, 3, 3, 2 * c, co)) * 0.3).astype(np.float32)
    g = rng.standard_normal((b, d, co, h, w)).astype(np.float32)
    ref = jax.grad(lambda a, b_, c_: (jfused.cost_stem_z(a, b_, c_, d)
                                      * g).sum(), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w3))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, y, w3)]
    (tfused.cost_stem_z(*ts, d) * torch.from_numpy(g)).sum().backward()
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def _stem_inputs(seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
    c, co = 12, 8
    x, y = (f(1, c, 6, 16).to(dtype) for _ in range(2))
    w3 = 0.2 * f(3, 3, 3, 2 * c, co)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, co).astype(np.float32))
    return x, y, w3, scale, 0.1 * f(co)


def _close(got, ref, bf16=False):
    """Within F32_RTOL of the largest |ref|, plus one bf16 ulp of each
    element where ``got`` is stored in bf16."""
    tol = F32_RTOL * float(ref.abs().max())
    if bf16:
        assert got.dtype == torch.bfloat16
        tol = tol + ref.abs() * 2.0 ** -7
    assert bool(((got.float() - ref).abs() <= tol).all()), \
        float((got.float() - ref).abs().max())


@pytest.mark.parametrize("fn,dtype", [
    ("cvstem_brc", torch.float32), ("cvstem_brc", torch.bfloat16),
    ("shear_stem_brc", torch.float32)],
    ids=["cvstem_brc-f32", "cvstem_brc-bf16", "shear_stem_brc-f32"])
def test_serving_stems_match_cost_stem_z(fn, dtype):
    """The serving stems with the folded BatchNorm and the ReLU, kernel B's
    (cvstem_brc) and the shear stem's (tap maps + kernel J), against
    relu(cost_stem_z * scale + bias) on the upcast features, D = 8. Kernel
    B's bf16 instance rounds once, its output; the shear stem also rounds
    its tap maps to bf16 (rag_tpu's design), so it is held in float32."""
    x, y, w3, scale, bias = _stem_inputs(1, dtype)
    mod = cvstem_mod if fn == "cvstem_brc" else shear_mod
    got = getattr(mod, fn)(x, y, w3, scale, bias, 8, True)
    ref = torch.relu(tfused.cost_stem_z(x.float(), y.float(), w3, 8)
                     * scale.view(1, 1, -1, 1, 1) + bias.view(1, 1, -1, 1, 1))
    _close(got, ref, dtype == torch.bfloat16)


@pytest.mark.parametrize("fn", ["cvstem_conv", "shear_stem_z"])
def test_training_stems_match_cost_stem_z(fn):
    """The training stems, kernel B with E and F behind it (cvstem_conv)
    and the shear stem with K behind it (shear_stem_z), against
    cost_stem_z: the pre-BN output, and dX, dY and dW (autograd through
    cost_stem_z) at GRAD_TOL of each gradient's largest magnitude."""
    x, y, w3, _, _ = _stem_inputs(2)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 8, 8, 6, 16)).astype(np.float32))
    mod = cvstem_mod if fn == "cvstem_conv" else shear_mod
    outs, grads = [], []
    for f in (getattr(mod, fn), tfused.cost_stem_z):
        leaves = [v.clone().requires_grad_(True) for v in (x, y, w3)]
        z = f(*leaves, 8)
        (z * g).sum().backward()
        outs.append(z.detach())
        grads.append([v.grad for v in leaves])
    _close(outs[0], outs[1])
    for got, ref in zip(*grads):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL * float(ref.abs().max()))
