"""The matching stem's conv over the concat cost volume, collapsed along
the volume's shear, in plain PyTorch: ``cost_stem_z``.

Counterpart of rag_tpu/ops/fused_stem.py, which is plain jnp (no Pallas
kernel) behind rag_tpu's ``RAG_TPU_FUSED_STEM``, a branch rag_tpu keeps
off. The port takes no such branch: on the H100 this function ran 2.6x
slower than kernel B per request (PERF.md), so no path runs it. It stays
as an independent plain reference of the stem's conv, one that builds no
volume, against which the tests hold kernels B, E and F and the shear
stem (J, K), and chip_smoke.py times it beside kernel B. With
u = j - d the Y half of the volume, cost_y[d, h, j] = Y[h, j - d], is a
shear of the right feature map and the X half is constant along d, so the
3x3x3 conv is eighteen (3,1) convs on the feature maps plus masked,
sheared sums:

    z[d, h, j] = sum_c  1[j - d >= c]  * XG_c[h, j]
               + sum_e  1[j - d >= -e] * YG_e[h, j - d + e]
               - (edge corrections)

where XG_c sums the X pieces of the taps with dd - dw = c and YG_e the Y
pieces with dw - dd = e. The corrections: at j = W - 1 the dw = 2 taps
read the volume's zero W padding, where the sheared lookup read Y; on the
planes d = 0 and D - 1 the dd = 0 and dd = 2 taps read the zero D
padding. The (B, D, 2C, H, W) volume is never built; the five sheared
gathers and the masked adds each write a volume-sized tensor, which is
why rag_tpu keeps the branch off (slower than its conv kernel on v5e).

Differentiable through autograd, as rag_tpu's is through jax.grad: no
custom Function and no kernel. The sums run in float32 (or the inputs'
float64) on the upcast features, and z comes back in the features' dtype
(the bf16-at-rest policy, ops.precision).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rag_tpu_torch.ops.precision import wide


def _conv31(x_cf: torch.Tensor, k31: torch.Tensor) -> torch.Tensor:
    """(3,1)-kernel conv over H on a (B, C, H, W) map. k31: (3, C, co)."""
    return F.conv2d(x_cf, k31.permute(2, 1, 0).unsqueeze(-1), padding=(1, 0))


def _shift_w(x_cf: torch.Tensor, s: int) -> torch.Tensor:
    """Shift along W by s in {-1, 0, 1} with zero fill (x[..., j + s])."""
    if s == 0:
        return x_cf
    if s > 0:
        return F.pad(x_cf[..., s:], (0, s))
    return F.pad(x_cf[..., :s], (-s, 0))


def cost_stem_z(x_cf: torch.Tensor, y_cf: torch.Tensor, w3: torch.Tensor,
                num_disp: int) -> torch.Tensor:
    """z = conv3d(cost_volume_cf(x, y, D), w3), pre-BN, without the volume.

    x_cf, y_cf: (B, C, H, W) channel-first left/right features; w3: (3, 3,
    3, 2C, co) stem weights. Returns (B, D, co, H, W) in x_cf's dtype."""
    out_dtype = x_cf.dtype
    x_cf, y_cf = wide(x_cf), wide(y_cf)
    w3 = w3.to(x_cf.dtype)
    b, c, h, w = x_cf.shape
    d = num_disp
    if w3.shape[:3] != (3, 3, 3) or w3.shape[3] != 2 * c:
        raise ValueError(f"cost_stem_z: w3 {tuple(w3.shape)} for C={c}")
    wx, wy = w3[:, :, :, :c], w3[:, :, :, c:]   # (dd, dh, dw, C, co)

    # per-(dd, dw) pieces: px[dd][dw] sums the X taps of column dw in
    # D-plane offset dd; py[dd][dw] is the Y piece in sheared v-space
    sx = [_shift_w(x_cf, dw - 1) for dw in range(3)]
    px = [[_conv31(sx[dw], wx[dd, :, dw]) for dw in range(3)]
          for dd in range(3)]
    py = [[_conv31(y_cf, wy[dd, :, dw]) for dw in range(3)]
          for dd in range(3)]

    dev = x_cf.device
    j = torch.arange(w, device=dev)[None, :]       # (1, W)
    dv = torch.arange(d, device=dev)[:, None]      # (D, 1)
    kap = j - dv                                   # (D, W): j - d
    zero = x_cf.new_zeros(())

    # mains: X groups by c = dd - dw (mask 1[kap >= c]), Y groups by
    # e = dw - dd (mask 1[kap + e >= 0], gathered at v = j - d + e)
    z = x_cf.new_zeros((b, d, px[0][0].shape[1], h, w))
    for cg in range(-2, 3):
        xg = None
        for dd in range(3):
            dw = dd - cg
            if 0 <= dw < 3:
                xg = px[dd][dw] if xg is None else xg + px[dd][dw]
        m = (kap >= cg)[None, :, None, None, :]
        z = z + torch.where(m, xg[:, None], zero)
    for e in range(-2, 3):
        yg = None
        for dd in range(3):
            dw = dd + e
            if 0 <= dw < 3:
                yg = py[dd][dw] if yg is None else yg + py[dd][dw]
        idx = (kap + e).clamp(0, w - 1)                    # (D, W)
        g = yg[..., idx].permute(0, 3, 1, 2, 4)            # (B, D, co, H, W)
        m = (kap + e >= 0)[None, :, None, None, :]
        z = z + torch.where(m, g, zero)

    # W-edge fix: at j = W-1 the dw = 2 taps read the volume's zero pad,
    # but the sheared lookup used interior Y values; subtract the (dd, 2)
    # pieces there, skipping the dd taps the D-plane fixes remove
    jw = w - 1
    d1 = dv[:, 0]
    fix = 0.0
    for dd in range(3):
        vv = (jw + 1 - (d1 + dd - 1)).clamp(0, w - 1)       # (D,)
        valid_d = (d1 + dd - 1 >= 0) & (d1 + dd - 1 <= d - 1)
        mm = ((jw - d1) + (2 - dd) >= 0) & valid_d
        val = py[dd][2][..., vv].permute(0, 3, 1, 2)       # (B, D, co, H)
        fix = fix + torch.where(mm[None, :, None, None], val, zero)
    z = torch.cat([z[..., :jw], (z[..., jw] - fix)[..., None]], dim=-1)

    # D-plane fixes: the dd = 0 taps at d = 0 (and dd = 2 at d = D-1) read
    # the volume's zero D padding; subtract those pieces with the same
    # masks (and the same clamped gather) the mains applied
    for dplane, dd in ((0, 0), (d - 1, 2)):
        sub = 0.0
        for dw in range(3):
            mj = (j[0] - dplane + dw - dd >= 0)            # (W,)
            vj = (j[0] + dw - 1 - (dplane + dd - 1)).clamp(0, w - 1)
            yv = py[dd][dw][..., vj]                       # (B, co, H, W)
            sub = sub + torch.where(mj[None, None, None, :],
                                    px[dd][dw] + yv, zero)
        z = torch.cat([z[:, :dplane], (z[:, dplane] - sub)[:, None],
                       z[:, dplane + 1:]], dim=1)
    return z.to(out_dtype)
