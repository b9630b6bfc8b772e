#!/usr/bin/env python3
"""Smoke run of the rag_tpu_torch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--profile DIR] [--small-only]

Two paths run through every phase: the default path (kernels A-G) and the
variant path, KernelVariants(conv3d_dblock, resize_kernel, shear_stem) all
on, where kernel H (kernel A's engine with four output planes a block)
takes kernel A's place, kernel I the matrix resizes, and the shear stem
(tap maps + kernels J and K) kernels B, E and F.

Phases, in order; any failure exits non-zero and no phase swallows an
exception:

  1. device        require CUDA (no CPU fallback), print the card;
  2. build         compile the port's CUDA kernels from rag_tpu_torch/csrc
                   with nvcc (one process per source, all at once), load them;
  3. record        restore the committed 4-task checkpoint
                   logs/canonical_learn_r4 onto the card and answer one
                   1x480x960 request per task path, on each path, with each
                   kernel's PLAIN version in its wrapper's place, recording
                   every call each kernel would get (its shapes and its real
                   activations);
  4. record-train  the same for one training step of each training
                   configuration (task 3's fine-tune stage, task 0's stage;
                   batch 4, 192x384 crops, maxdisp 192), on each path,
                   keeping the plain step's updates and statistics;
  5. kernels       hold all eleven kernels (A-C, H-J forward, D-G, K
                   backward) against their plain versions on the card, at
                   every recorded shape and at small shapes, and time kernel,
                   plain version and a library yardstick with CUDA events
                   (H beside kernel A at its own plan, I beside
                   F.interpolate or aten's upsample_trilinear3d_backward
                   and through its C entry alone, J and K beside kernels
                   B and E+F; A with one output plane per block and with
                   its 4-byte copies, E at other chunk sizes, D's two
                   passes apart;
                   B beside kernel A on the materialized cost volume, F
                   beside kernel D on it, alone and with the volume's build,
                   and F's two passes apart; G's two passes apart, as
                   CUDA-graph replays);
                   kernel A's weight pass is held bit for bit against its
                   plain version (kernel B's plan among its plans), two
                   launches of kernels C, D, F, G, J and K on the same
                   inputs against each other, and J and K against their
                   plain versions bit for bit on integer-valued inputs;
  6. serve         per path, in turns (default, variants, variants,
                   default): set every launch count to 0, answer 3 requests
                   per task path through RoutedInference.predict, read the
                   counts (each kernel of the path must have launched, no
                   other), and check every disparity: finite, in [0, 191],
                   within tolerance of the path's plain disparity (the
                   variant path's also of the default path's);
  7. route         load the committed Scene Router (logs/canonical_learn_r4/
                   router.npz) onto the card and build the canonical run's
                   four styled test scenes there (SyntheticStereoDataset,
                   16 frames of 480x960 each, seeds 30-33, one weather style
                   each); route all 64 left frames on the card and again on
                   the CPU in float32 (the ids must be equal) and print the
                   scene accuracy and confusion matrix beside result.json's;
                   then per path, in the same turns, every launch count set
                   to 0: each scene through RoutedInference(net, router)
                   .evaluate(task=None) against evaluate(task=t) (equal
                   metrics where every frame was routed to its own task;
                   D1 and EPE printed beside result.json's routed values),
                   3 routed requests per scene beside the same requests with
                   the task given (ms/request, equal disparity where routed
                   right), the counts read (each kernel of the path
                   launched, no other); the router alone timed with CUDA
                   events; a fresh router trained on the card for 3 epochs
                   of batch 8 on four styled scenes of 32 pairs at 192x384
                   (its first Adam step within 1e-4 relative L2 of the same
                   step on the CPU, losses finite and falling; accuracy on
                   the test scenes printed, not gated);
  8. train         per path, in the same turns: set every launch count to 0,
                   take 3 steps of each training configuration through
                   make_train_step, read the counts, check the loss and
                   every updated leaf finite and the first step against the
                   path's plain step of phase 4; print ms/step, training
                   pairs/s and peak memory;
  9. report        one JSON line of the route phase ("route": its figures
                   and the card's name and power limit), one of kernels
                   (launches: the serve, route and train runs), the card's
                   name and power limit, and as the last line
                   {"ok": true, "device": {...}}.

--small-only runs phases 1, 2 and 5 at the small shapes alone (a quick
build-and-check) and prints no report.

Float32 throughout: TF32 is off for cuDNN and matmuls; kernel A's tensor-core
products are 3xTF32, which keeps float32 accuracy (its lines also carry
bound_tf32x3_ms, the bound of those products at the TF32 peak, beside the
float32 bound_ms; so do kernel B's, which runs A's engine). Kernel A's,
B's, D's, E's, F's, H's and I's lines carry their plan: A's tile, splits
and blocks per launch; B's and H's the same, with A's plan for the call
beside it; D's and F's blocks, tile, row groups, planes per block, channel
chunks and workspace (F's also the share of its blocks' plane steps that
run, and D's plan for the materialized volume); E's chunks, blocks and
workspace; I's tile, runs of output planes, taps a table row, staged rows
x columns and shared memory; C's its instance (D of the periodic one, or
0 for the general one) and blocks, G's its instance, strips, warps,
blocks of its two passes and workspace; J's and K's their grid, block,
staged bytes, planes, columns and pieces (J) or runs (K) a row, copy
width, splits and column splits, as the library reports them. D's report entry lists its shapes in a step of task 0's stage.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

from rag_tpu_torch.continual.inference import RoutedInference  # noqa: E402
from rag_tpu_torch.continual.state import (  # noqa: E402
    load_checkpoint,
    load_router,
)
from rag_tpu_torch.data.synthetic import (  # noqa: E402
    WEATHER_STYLES,
    DeviceCache,
    SyntheticStereoDataset,
)
from rag_tpu_torch.metrics.stereo import stereo_metrics  # noqa: E402
from rag_tpu_torch.models.router import (  # noqa: E402
    SceneRouter,
    make_router_train_step,
    router_logits,
)
from rag_tpu_torch.ops import conv3d as conv3d_mod  # noqa: E402
from rag_tpu_torch.ops import cuda_lib  # noqa: E402
from rag_tpu_torch.ops import cvstem as cvstem_mod  # noqa: E402
from rag_tpu_torch.ops import disparity as disparity_mod  # noqa: E402
from rag_tpu_torch.ops import resize as resize_mod  # noqa: E402
from rag_tpu_torch.ops import shear as shear_mod  # noqa: E402
from rag_tpu_torch.ops.cost_volume import cost_volume_cf  # noqa: E402
from rag_tpu_torch.ops.resize import _interp_matrix_np  # noqa: E402
from rag_tpu_torch.ops.variants import KernelVariants  # noqa: E402
from rag_tpu_torch.train.trainer import (  # noqa: E402
    cosine_lr,
    make_optimizer,
    make_train_step,
)

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "logs" / "canonical_learn_r4"
H, W, MAXDISP = 480, 960, 192
TRUE_DISP = 24                 # the synthetic pair is one fronto-parallel plane
REQUESTS = 3                   # per task path; the first is reported apart
REPS = 10                      # timed launches per kernel at main-path shapes
TRAIN_B, TRAIN_H, TRAIN_W = 4, 192, 384  # the reference's training crops
TRAIN_STEPS = 3                # per configuration; the first is reported apart
TRAIN_EPOCHS = 10              # cosine schedule length; step i takes epoch i's lr
LR, WD = 0.001, 0.003
STEM_C = 12                    # feature channels into the matching stem
PATHS = {"default": KernelVariants(),
         "variants": KernelVariants(conv3d_dblock=True, resize_kernel=True,
                                    shear_stem=True)}
TURNS = ("default", "variants", "variants", "default")  # serve, route, train
# the route phase: the canonical run's four styled test scenes (scene t
# styled WEATHER_STYLES[t], seed 30 + t, disparity up to 64 px;
# rag_tpu/cli.py:260-267) and its router training (rag_tpu's driver
# defaults, continual/driver.py:61-62, on the train sets' seeds 10 + t)
RESULT = ROOT / "logs" / "drivingstereo_rag_0_canonical_learn_r4" / "result.json"
SCENE_FRAMES, SCENE_DISP = 16, 64.0
ROUTE_REQUESTS = 3             # per scene, routed and with the task given
ROUTER_TRAIN_PAIRS, ROUTER_TRAIN_H, ROUTER_TRAIN_W = 32, 192, 384
ROUTER_EPOCHS, ROUTER_BATCH = 3, 8

# H100 SXM data-sheet peaks (dense, no sparsity) at the 700 W limit
PEAK_FP32_FLOPS = 67e12        # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12       # TF32 on the tensor cores
PEAK_HBM_BYTES = 3.35e12

# Tolerances, with their reasons:
CONV_RTOL = 1e-5   # of max |plain|: float32 sums of <= 27*48 products in
                   # another order; a wrong tap or channel is O(1) off
DISP_ATOL = 1e-3   # px, kernel C alone: float32 softmin over 192 levels
BWD_RTOL = 1e-4    # kernels D-F: of the largest sum of the products'
                   # magnitudes (the plain version on |inputs|), the scale of
                   # float32 error in sums of up to 2M (D, F) or 64 planes x
                   # 27 taps x 12 (E) terms taken in another order, where
                   # real gradients cancel; G: of max |plain|. A wrong tap or
                   # mask is O(1) off
STEP_RTOL = 1e-2   # a train step, kernels vs plain: relative L2 of dp/lr over
                   # all trainable leaves; float32 sums in another order
                   # through ~25 layers, where a ReLU input within float32
                   # noise of zero takes the other branch (ROADMAP Queue 3)
STATS_RTOL = 1e-3  # of max(1, |stat|), new BN running statistics of that step
ROUTER_STEP_RTOL = 1e-4  # the router's first Adam step, card vs CPU: relative
                   # L2 of the update, mu and nu; float32 convs and
                   # reductions summed in another order (~1e-6)
SERVE_ATOL = 1e-2  # px, whole request: ~25 float32 layers summed in another
                   # order, amplified by the softmin; 1% of the 1-px Thres1


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over reps launches, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of fn()'s launches captured once as a CUDA graph
    and replayed (free of the host's launch time), after warm-up."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


# -- bounds: the least time the card could take for one call ---------------

def _taps(n: int) -> int:
    """(output, tap) pairs of a 3-tap zero-padded axis that read inside."""
    return 3 * n - 2 if n > 1 else 1


def _bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def conv_bound(x_shape, cout, tf32x3=False):
    """Multiply-adds that read an in-range voxel (padding zeros excluded);
    bytes: input, weights, affine read once, output written once. With
    tf32x3: kernel A's three TF32 products of each on the tensor cores."""
    b, d, cin, h, w = x_shape
    flops = 2.0 * b * _taps(d) * _taps(h) * _taps(w) * cin * cout
    nbytes = 4.0 * (b * d * h * w * (cin + cout) + 27 * cin * cout + 2 * cout)
    if tf32x3:
        return max(3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    return _bound(flops, nbytes)


def _stem_products(nd, w, dv_needed=False):
    """(plane, column, kd, kw) combinations of the stem's conv whose product
    is not structurally zero. Forward and dW: the volume voxel read,
    (d+kd-1, j+kw-1), lies inside the planes and right of the diagonal.
    dX/dY (dv_needed): the conv of dz lands on an output (d, j) the
    volume's adjoint keeps (j >= d) and reads dz inside the planes."""
    d = np.arange(nd)[:, None, None, None]
    dd = np.arange(3)[None, :, None, None]
    j = np.arange(w)[None, None, :, None]
    kw = np.arange(3)[None, None, None, :]
    dv, jv = d + dd - 1, j + kw - 1
    inside = (dv >= 0) & (dv < nd) & (jv >= 0) & (jv < w)
    inside &= (j >= d) if dv_needed else (jv >= dv)
    return int(inside.sum())


def cvstem_bound(x_shape, nd, cout, flops_only=False):
    """Multiply-adds that read a voxel of the cost volume that is not a
    structural zero (outside the planes, left of the diagonal, or padding);
    bytes: the two feature maps, weights, affine in, the output out. With
    flops_only: the time of those operations alone at the float32 peak."""
    b, c, h, w = x_shape
    flops = 2.0 * b * _stem_products(nd, w) * _taps(h) * 2 * c * cout
    if flops_only:
        return flops / PEAK_FP32_FLOPS * 1e3
    nbytes = 4.0 * (2 * b * c * h * w + b * nd * cout * h * w
                    + 27 * 2 * c * cout + 2 * cout)
    return _bound(flops, nbytes)


def disp_bound(x_shape, maxdisp, scale):
    """Per output pixel: a bilinear blend of each of the D cost levels
    (9 flops) and, per disparity level, the D-axis lerp (3), the running
    max (1), exp (1), and the two sums (3). Bytes: cost in, disparity out."""
    b, d, h, w = x_shape
    pixels = b * h * scale * w * scale
    flops = pixels * (9.0 * d + 8.0 * maxdisp)
    nbytes = 4.0 * (b * d * h * w + pixels)
    return _bound(flops, nbytes)


def dw_bound(x_shape, cout):
    """Kernel D: the forward's multiply-adds that read an in-range voxel;
    bytes: x and dz in, dW out."""
    b, d, cin, h, w = x_shape
    flops = 2.0 * b * _taps(d) * _taps(h) * _taps(w) * cin * cout
    nbytes = 4.0 * (b * d * h * w * (cin + cout) + 27 * cin * cout)
    return _bound(flops, nbytes)


def cvstem_dxy_bound(dz_shape, c2, nd):
    """Kernel E: for every volume voxel the adjoint keeps, the in-range
    products of the dx conv over 27 taps and Cout; bytes: dz and weights
    in, dX and dY out."""
    b, _, cout, h, w = dz_shape
    flops = 2.0 * b * _stem_products(nd, w, dv_needed=True) * _taps(h) \
        * c2 * cout
    nbytes = 4.0 * (b * nd * cout * h * w + 27 * c2 * cout + b * c2 * h * w)
    return _bound(flops, nbytes)


def cvstem_dw_bound(x_shape, dz_shape, nd):
    """Kernel F: the forward's products (the same (voxel, tap) pairs);
    bytes: X, Y and dz in, dW out."""
    b, c, h, w = x_shape
    cout = dz_shape[2]
    flops = 2.0 * b * _stem_products(nd, w) * _taps(h) * 2 * c * cout
    nbytes = 4.0 * (2 * b * c * h * w + b * nd * cout * h * w
                    + 27 * 2 * c * cout)
    return _bound(flops, nbytes)


def disp_bwd_bound(x_shape, maxdisp, scale):
    """Kernel G: per output pixel, kernel C's work (9 per cost level, 8
    per disparity level) plus the third walk over the levels (lerp 3, exp
    1, p 1, dy 4, the D fold into two taps 4); per input voxel, the gather
    over its inverse H and W taps (2*KW + 2 per H tap). Bytes: x and g in,
    dx out."""
    b, d, h, w = x_shape
    kh, kw = (int(np.count_nonzero(_interp_matrix_np(n, n * scale, False),
                                   axis=0).max()) for n in (h, w))
    pixels = b * h * scale * w * scale
    flops = (pixels * (9.0 * d + 21.0 * maxdisp)
             + b * d * h * w * kh * (2.0 * kw + 2.0))
    nbytes = 4.0 * (2 * b * d * h * w + pixels)
    return _bound(flops, nbytes)


def resize_bound(x_shape, d2, h2, w2, align_corners=True, transposed=False):
    """Kernel I: the multiply-adds of the separable form (each axis that
    changes, one per nonzero tap of its table, over the volume at that
    stage); bytes: x in, the output out."""
    b, d, c, h, w = x_shape
    nnz = []
    for n, n2 in ((d, d2), (h, h2), (w, w2)):
        if n == n2:
            nnz.append(0)
            continue
        _, wts = resize_mod._taps_np(*((n2, n) if transposed else (n, n2)),
                                     align_corners, transposed)
        nnz.append(int(np.count_nonzero(wts)))
    flops = 2.0 * (nnz[0] * b * c * h * w + nnz[1] * b * d2 * c * w
                   + nnz[2] * b * d2 * c * h2)
    nbytes = 4.0 * (b * d * c * h * w + b * d2 * c * h2 * w2)
    return _bound(flops, nbytes)


def _shear_terms(nd, w):
    """(plane, column, term) adds of the shear assembly that its masks
    keep: the px term where the gate and j >= s hold, the py term where
    also j <= W - dw."""
    d = np.arange(nd)[:, None]
    j = np.arange(w)[None, :]
    n = 0
    for dd, dw in shear_mod.T9:
        s = d + dd - dw
        xm = (j >= s) & (d + dd - 1 >= 0) & (d + dd - 1 <= nd - 1)
        n += int(xm.sum()) + int((xm & (j <= w - dw)).sum())
    return n


def shear_bound(px_shape, nd, relu=False):
    """Kernel J: the kept adds plus the affine (2) and ReLU (1) per output;
    bytes: the two tap-map stacks and the affine in, the output out."""
    b, _, co, h, w = px_shape
    flops = b * co * h * (_shear_terms(nd, w) + (3.0 if relu else 2.0) * nd * w)
    nbytes = 4.0 * (2 * b * 9 * co * h * w + b * nd * co * h * w + 2 * co)
    return _bound(flops, nbytes)


def shear_adj_bound(dz_shape, nd):
    """Kernel K: the same kept adds, taken back; bytes: dz in, the two
    tap-map gradients out."""
    b, _, co, h, w = dz_shape
    flops = float(b * co * h * _shear_terms(nd, w))
    nbytes = 4.0 * (b * nd * co * h * w + 2 * b * 9 * co * h * w)
    return _bound(flops, nbytes)


# -- the eleven kernels: wrapper, plain version, yardstick, bound -----------

def _ncdhw(v):
    return v.permute(0, 2, 1, 3, 4).contiguous()


def _conv_library(x, w, scale, bias, relu):
    """cuDNN F.conv3d on NCDHW with the affine folded into weights and
    bias, then ReLU (the layout change is made once, outside the timing)."""
    x_n = _ncdhw(x)
    w_n = (w * scale).permute(4, 3, 0, 1, 2).contiguous()

    def run():
        y = F.conv3d(x_n, w_n, bias, padding=1)
        return torch.relu_(y) if relu else y
    return run


def _cvstem_library(x_cf, y_cf, w3, scale, bias, nd, relu):
    """The materialized cost volume, then cuDNN F.conv3d as above."""
    x = x_cf.permute(0, 2, 3, 1).contiguous()
    y = y_cf.permute(0, 2, 3, 1).contiguous()
    w_n = (w3 * scale).permute(4, 3, 0, 1, 2).contiguous()

    def run():
        vol = cost_volume_cf(x, y, nd).permute(0, 2, 1, 3, 4)
        out = F.conv3d(vol, w_n, bias, padding=1)
        return torch.relu_(out) if relu else out
    return run


def _dw_library(x, dz):
    """cuDNN's weight gradient (conv3d_weight) on NCDHW."""
    x_n, dz_n = _ncdhw(x), _ncdhw(dz)
    shape = (dz.shape[2], x.shape[2], 3, 3, 3)
    return lambda: torch.nn.grad.conv3d_weight(x_n, shape, dz_n, padding=1)


def _dxy_library(dz, w3, nd):
    """cuDNN's input gradient (conv3d_input) of the materialized volume,
    then the volume's adjoint: the masked sum over d for dX, the shifted
    sum for dY."""
    b, _, _, h, w = dz.shape
    c2 = w3.shape[3]
    c = c2 // 2
    dz_n = _ncdhw(dz)
    w_n = w3.permute(4, 3, 0, 1, 2).contiguous()
    j = torch.arange(w, device=dz.device)
    mask = (j[None, :] >= torch.arange(nd, device=dz.device)[:, None]).float()

    def run():
        dv = torch.nn.grad.conv3d_input((b, c2, nd, h, w), w_n, dz_n,
                                        padding=1)
        dx = (dv[:, :c] * mask[None, None, :, None, :]).sum(2)
        dy = torch.zeros_like(dx)
        for d in range(min(nd, w)):
            dy[..., :w - d] += dv[:, c:, d, :, d:]
        return dx, dy
    return run


def _cvstem_dw_library(x_cf, y_cf, dz, nd):
    """The materialized cost volume, then cuDNN's conv3d_weight."""
    x = x_cf.permute(0, 2, 3, 1).contiguous()
    y = y_cf.permute(0, 2, 3, 1).contiguous()
    dz_n = _ncdhw(dz)
    shape = (dz.shape[2], 2 * x_cf.shape[1], 3, 3, 3)

    def run():
        vol = cost_volume_cf(x, y, nd).permute(0, 2, 1, 3, 4)
        return torch.nn.grad.conv3d_weight(vol, shape, dz_n, padding=1)
    return run


def _resize_library(x, d2, h2, w2, align_corners=True, transposed=False):
    """One call of F.interpolate(mode="trilinear") on the volume permuted
    to NCDHW (made once, outside the timing); for the adjoint, one call of
    its backward, aten's upsample_trilinear3d_backward."""
    b, d, c, h, w = x.shape
    x_n = _ncdhw(x)
    if not transposed:
        return lambda: F.interpolate(x_n, size=(d2, h2, w2), mode="trilinear",
                                     align_corners=align_corners)
    return lambda: torch.ops.aten.upsample_trilinear3d_backward(
        x_n, [d, h, w], [b, c, d2, h2, w2], align_corners)


def _stem_inputs(b, h, w, co, dev, grad=False):
    """Random features and stem weights at the shapes the stem is given."""
    def t(*shape):
        return torch.randn(*shape, device=dev).requires_grad_(grad)
    return t(b, STEM_C, h, w), t(b, STEM_C, h, w), t(3, 3, 3, 2 * STEM_C, co)


def _dblock_beside(x, w, scale, bias, relu):
    """Kernel A (its own plan) at kernel H's arguments."""
    return {"kernel_a_ms":
            lambda: conv3d_mod.conv3d_affine_cf(x, w, scale, bias, relu)}


def _dblock_plan(x, w, scale, bias, relu):
    """Kernel H's plan (kernel A's engine, db = 4) and kernel A's plan for
    the same call beside it."""
    def fields(p):
        return {"blocks": p.blocks, "tile": f"{p.th}x{p.tw}", "mt": p.mt,
                "nt": p.nt, "n_split": p.n_split, "cc": p.cc, "db": p.db}
    return {**fields(conv3d_mod.conv_plan_dblock(*x.shape, w.shape[4])),
            "kernel_a_plan": fields(conv3d_mod.conv_plan(*x.shape,
                                                         w.shape[4]))}


def _resize_beside(x, d2, h2, w2, align_corners=True, transposed=False):
    """Kernel I through its C entry with the plan, tables and output made
    once (the wrapper's host work left out)."""
    plan, itab, ftab = resize_mod.resize_setup(
        tuple(x.shape), d2, h2, w2, align_corners, transposed, x.device)
    out = torch.empty((x.shape[0], d2, x.shape[2], h2, w2), device=x.device)
    return {"entry_ms": lambda: resize_mod.launch_resize(x, itab, ftab, out,
                                                         plan)}


def _resize_plan(x, d2, h2, w2, align_corners=True, transposed=False):
    """Kernel I's plan for the call: tile, output planes per block, taps a
    table row, blocks, staged rows and columns a plane, shared memory."""
    b, d, c, h, w = x.shape
    p = resize_mod.resize_plan(b, d, c, h, w, d2, h2, w2, align_corners,
                               transposed)
    return {"blocks": p.blocks, "tile": f"{p.th}x{p.tw}", "run": p.run,
            "n_runs": p.n_runs, "k": p.k, "staged": f"{p.rows}x{p.pitch}",
            "smem_bytes": p.smem}


def _conv_beside(x, w, scale, bias, relu):
    """Kernel A with one output plane per block, and with its 4-byte copy
    path (x copied to an address 4 bytes past a 16-byte boundary)."""
    plan = conv3d_mod.conv_plan(*x.shape, w.shape[4])
    one = plan._replace(db=1, blocks=plan.blocks // -(-x.shape[1] // plan.db)
                        * x.shape[1])
    x4 = torch.empty(x.numel() + 1, device=x.device)[1:].view_as(x)
    x4.copy_(x)
    return {"db1_ms": lambda: conv3d_mod.launch_conv(x, w, scale, bias, relu,
                                                     one),
            "copy4_ms": lambda: conv3d_mod.launch_conv(x4, w, scale, bias,
                                                       relu, plan)}


def _dxy_beside(dz, w3, nd):
    """Kernel E at chunks of 4 and 8 planes beside its plan's."""
    b, d, cout, h, w = dz.shape
    plan = cvstem_mod.dxy_plan(b, d, cout, w3.shape[3] // 2, h, w)
    runs = {}
    for chunk in (4, 8):
        n = -(-d // chunk)
        p = plan._replace(chunk=chunk, n_chunks=n,
                          blocks=plan.blocks // plan.n_chunks * n,
                          workspace=plan.workspace // plan.n_chunks * n)
        runs[f"chunk{chunk}_ms"] = (lambda p=p:
                                    cvstem_mod.launch_dxy(dz, w3, p))
    return runs


def _conv_plan(x, w, scale, bias, relu):
    """Kernel A's plan for the call: its tile, splits, planes per block and
    blocks, and the 3xTF32 tensor-core bound beside the float32 one."""
    p = conv3d_mod.conv_plan(*x.shape, w.shape[4])
    return {"blocks": p.blocks, "tile": f"{p.th}x{p.tw}", "mt": p.mt,
            "nt": p.nt, "n_split": p.n_split, "cc": p.cc, "db": p.db,
            "bound_tf32x3_ms": conv_bound(x.shape, w.shape[4], True)}


def _dw_beside(x, dz):
    """Kernel D's two passes timed apart: the blocks' partials alone, the
    fixed-order sum alone (over a workspace the first pass filled). Other
    blockings are timed by scripts/torch_dw_sweep.py."""
    plan = conv3d_mod.dw_plan(*x.shape, dz.shape[2])
    return {"partial_ms": lambda: conv3d_mod.launch_dw_plan(x, dz, plan, 1),
            "sum_ms": lambda: conv3d_mod.launch_dw_plan(x, dz, plan, 2)}


def _cvstem_beside(x_cf, y_cf, w3, scale, bias, nd, relu=True):
    """Kernel A on the materialized cost volume (made once, outside the
    timing): the same engine with the volume's bytes."""
    vol = cvstem_mod._volume(x_cf, y_cf, nd).contiguous()
    return {"kernel_a_on_volume_ms": lambda: conv3d_mod.conv3d_affine_cf(
        vol, w3, scale, bias, relu)}


def _cvstem_plan(x_cf, y_cf, w3, scale, bias, nd, relu=True):
    """Kernel B's plan (kernel A's engine on the cost volume), kernel A's
    plan for the materialized volume beside it, and the 3xTF32 bound."""
    b, c, h, w = x_cf.shape
    p = cvstem_mod.cvstem_plan(b, nd, c, h, w, w3.shape[4])
    a = conv3d_mod.conv_plan(b, nd, 2 * c, h, w, w3.shape[4])
    return {"blocks": p.blocks, "tile": f"{p.th}x{p.tw}", "mt": p.mt,
            "nt": p.nt, "n_split": p.n_split, "cc": p.cc, "db": p.db,
            "kernel_a_plan": f"{a.mt},{a.nt},{a.db} {a.th}x{a.tw}",
            "bound_tf32x3_ms": 3 * cvstem_bound(x_cf.shape, nd, w3.shape[4],
                                                flops_only=True)
            * PEAK_FP32_FLOPS / PEAK_TF32_FLOPS}


def _cvstem_dw_beside(x_cf, y_cf, dz, nd):
    """Kernel D on the materialized cost volume: alone (the volume made
    once, outside the timing) and with the volume's build, as the plain
    path would run it; kernel F's two passes apart."""
    vol = cvstem_mod._volume(x_cf, y_cf, nd).contiguous()
    b, c, h, w = x_cf.shape
    plan = cvstem_mod.cvstem_dw_plan(b, nd, c, h, w, dz.shape[2])
    return {"kernel_d_on_volume_ms": lambda: conv3d_mod.conv3d_dw_cf(vol, dz),
            "volume_and_kernel_d_ms": lambda: conv3d_mod.conv3d_dw_cf(
                cvstem_mod._volume(x_cf, y_cf, nd).contiguous(), dz),
            "partial_ms": lambda: cvstem_mod.launch_cvstem_dw(x_cf, y_cf, dz,
                                                              plan, 1),
            "sum_ms": lambda: cvstem_mod.launch_cvstem_dw(x_cf, y_cf, dz,
                                                          plan, 2)}


def _cvstem_dw_plan(x_cf, y_cf, dz, nd):
    """Kernel F's plan (kernel D's engine on the cost volume), the share of
    its blocks' plane steps that run, and kernel D's plan for the
    materialized volume beside it."""
    b, c, h, w = x_cf.shape
    p = cvstem_mod.cvstem_dw_plan(b, nd, c, h, w, dz.shape[2])
    d = conv3d_mod.dw_plan(b, nd, 2 * c, h, w, dz.shape[2])
    return {**_dw_fields(p),
            "live_share": cvstem_mod.cvstem_live_share(p, nd, w),
            "kernel_d_plan": f"{d.th}x{d.tw} db {d.db} co_t {d.co_t} kh_t "
                             f"{d.kh_t}"}


def _dw_fields(p):
    return {"blocks": p.blocks, "threads": p.threads,
            "tile": f"{p.th}x{p.tw}", "groups": p.groups, "db": p.db,
            "ci": p.ci, "n_ci": p.n_ci, "co_t": p.co_t, "n_co": p.n_co,
            "kh_t": p.kh_t, "workspace_bytes": 4 * p.workspace}


def _dw_plan(x, dz):
    """Kernel D's plan for the call: blocks, tile (band of rows x columns),
    row groups, output planes per block, input- and output-channel chunks,
    workspace."""
    return _dw_fields(conv3d_mod.dw_plan(*x.shape, dz.shape[2]))


def _dxy_plan(dz, w3, nd):
    """Kernel E's plan for the call: chunks of planes, blocks, workspace."""
    b, d, cout, h, w = dz.shape
    p = cvstem_mod.dxy_plan(b, d, cout, w3.shape[3] // 2, h, w)
    return {"n_chunks": p.n_chunks, "chunk": p.chunk, "blocks": p.blocks,
            "workspace_bytes": 4 * p.workspace}


def _head_plan(x, maxdisp, scale=3):
    """Kernel C's instance (D of the periodic one, 0 = general) and
    blocks."""
    p = disparity_mod.head_plan(*x.shape, maxdisp, scale)
    return {"instance": p.instance, "blocks": p.blocks}


def _head_bwd_plan(x, g, maxdisp, scale=3):
    """Kernel G's instance, strips a row, warps a block, blocks of its two
    passes and workspace."""
    p = disparity_mod.head_bwd_plan(*x.shape, maxdisp)
    return {"instance": p.instance, "strip": p.strip, "strips": p.strips,
            "warps": p.warps, "fold_blocks": p.fold_blocks,
            "gather_blocks": p.gather_blocks,
            "workspace_bytes": 4 * p.workspace}


def _head_bwd_beside(x, g, maxdisp, scale=3):
    """Kernel G's two passes timed apart, as CUDA-graph replays (the H fold
    alone takes less than the wrapper's host time): the D and W folds into
    the workspace alone, the H fold alone (over a workspace left
    unwritten)."""
    plan = disparity_mod.head_bwd_plan(*x.shape, maxdisp)
    return {"fold_ms": lambda: disparity_mod.launch_head_bwd(x, g, maxdisp,
                                                             plan, 1),
            "gather_ms": lambda: disparity_mod.launch_head_bwd(x, g, maxdisp,
                                                               plan, 2)}


def _shear_fields(p):
    return {"grid": p.blocks, "block": p.threads, "staged_bytes": p.smem,
            "planes": p.planes, "cols": p.cols, "runs": p.runs,
            "copy_bytes": 16 if p.vec else 4, "splits": p.splits,
            "col_splits": p.col_splits}


def _shear_plan(px, py, scale, bias, nd, relu=False):
    """Kernel J's launch: blocks (a row each), threads (a task each: a run
    of planes down a group of columns), shared memory (a piece's staged
    tap-map rows, P and R), planes and columns a piece, pieces a row."""
    b, _, co, h, w = px.shape
    return _shear_fields(shear_mod.shear_plan(False, b, nd, co, h, w))


def _shear_adj_plan(dz, nd):
    """Kernel K's launch: blocks (row, split), threads (walkers), shared
    memory (the staged run of dz), planes a run, the slab's row pitch, runs
    a row, splits a row and the column blocks among them."""
    b, _, co, h, w = dz.shape
    return _shear_fields(shear_mod.shear_plan(True, b, nd, co, h, w))


def _shear_beside(px, py, scale, bias, nd, relu=False):
    """The whole shear stem (tap maps + J) against kernel B, on random
    features of the same shapes (they set the work, not the values)."""
    b, _, co, h, w = px.shape
    x, y, w3 = _stem_inputs(b, h, w, co, px.device)
    return {"stem_ms": lambda: shear_mod.shear_stem_brc(x, y, w3, scale,
                                                        bias, nd, relu),
            "kernel_b_ms": lambda: cvstem_mod.cvstem_affine(
                x, y, w3, scale, bias, nd, relu)}


def _shear_adj_beside(dz, nd):
    """The shear stem's whole backward (K, then autograd through the
    tap-map convs to dX, dY, dW) against kernels E + F, on random features
    of the same shapes."""
    b, _, co, h, w = dz.shape
    x, y, w3 = _stem_inputs(b, h, w, co, dz.device, grad=True)
    z = shear_mod.shear_stem_z(x, y, w3, nd)
    xd, yd, wd = x.detach(), y.detach(), w3.detach()
    return {"stem_bwd_ms": lambda: torch.autograd.grad(
                z, (x, y, w3), dz, retain_graph=True),
            "kernel_ef_ms": lambda: (cvstem_mod.cvstem_dxy(dz, wd, nd),
                                     cvstem_mod.cvstem_dw(xd, yd, dz, nd))}


# name -> the module and attribute where the main path looks the kernel's
# wrapper up (record puts the plain version there), the plain version, the
# TPU kernel it replaces, and how to sign, bound and yardstick one call;
# "path": the path it reports from, "serving": whether that path serves
# through it (else it runs in training only); "beside": other calls timed
# at its arguments and printed beside it ("beside_graph": as replays of a
# CUDA graph, free of the host's launch time).
KERNELS = {
    "conv3d_brc_cf": dict(
        site=(conv3d_mod, "conv3d_affine_cf"),
        plain=conv3d_mod.conv3d_brc_cf_plain,
        source="rag_tpu_torch/csrc/conv3d.cu",
        replaces="rag_tpu/ops/pallas_conv3d.py:257",
        sig=lambda x, w, scale, bias, relu: (tuple(x.shape), w.shape[4], relu),
        bound=lambda x, w, scale, bias, relu: conv_bound(x.shape, w.shape[4]),
        library=_conv_library, beside=_conv_beside, plan=_conv_plan,
        tol="conv", path="default", serving=True),
    "cvstem_brc": dict(
        site=(cvstem_mod, "cvstem_affine"),
        plain=cvstem_mod.cvstem_brc_plain,
        source="rag_tpu_torch/csrc/cvstem.cu",
        replaces="rag_tpu/ops/pallas_cvstem.py:257",
        sig=lambda x, y, w3, scale, bias, nd, relu=True:
            (tuple(x.shape), w3.shape[4], nd, relu),
        bound=lambda x, y, w3, scale, bias, nd, relu=True:
            cvstem_bound(x.shape, nd, w3.shape[4]),
        library=_cvstem_library, beside=_cvstem_beside, plan=_cvstem_plan,
        tol="conv", path="default", serving=True),
    "fused_soft_argmin": dict(
        site=(disparity_mod, "soft_argmin_fwd"),
        plain=disparity_mod.soft_argmin_disparity,
        source="rag_tpu_torch/csrc/disp_head.cu",
        replaces="rag_tpu/ops/pallas_kernels.py:163",
        sig=lambda x, maxdisp, scale=3: (tuple(x.shape), maxdisp, scale),
        bound=lambda x, maxdisp, scale=3: disp_bound(x.shape, maxdisp, scale),
        library=None, plan=_head_plan, tol="disp", path="default",
        serving=True, bitwise=True),
    "conv3d_dw_cf": dict(
        site=(conv3d_mod, "conv3d_dw_cf"),
        plain=conv3d_mod.conv3d_dw_cf_plain,
        source="rag_tpu_torch/csrc/conv3d_dw.cu",
        replaces="rag_tpu/ops/pallas_conv3d.py:561",
        sig=lambda x, dz: (tuple(x.shape), dz.shape[2]),
        bound=lambda x, dz: dw_bound(x.shape, dz.shape[2]),
        magnitude=lambda x, dz: (x.abs(), dz.abs()),
        library=_dw_library, beside=_dw_beside, plan=_dw_plan, tol="bwd",
        path="default", serving=False, bitwise=True, per_shape=True),
    "cvstem_dxy": dict(
        site=(cvstem_mod, "cvstem_dxy"),
        plain=cvstem_mod.cvstem_dxy_plain,
        source="rag_tpu_torch/csrc/cvstem_dxy.cu",
        replaces="rag_tpu/ops/pallas_cvstem.py:384",
        sig=lambda dz, w3, nd: (tuple(dz.shape), w3.shape[3], nd),
        bound=lambda dz, w3, nd: cvstem_dxy_bound(dz.shape, w3.shape[3], nd),
        magnitude=lambda dz, w3, nd: (dz.abs(), w3.abs(), nd),
        library=_dxy_library, beside=_dxy_beside, plan=_dxy_plan, tol="bwd",
        path="default",
        serving=False),
    "cvstem_dw": dict(
        site=(cvstem_mod, "cvstem_dw"),
        plain=cvstem_mod.cvstem_dw_plain,
        source="rag_tpu_torch/csrc/cvstem_bwd.cu",
        replaces="rag_tpu/ops/pallas_cvstem.py:476",
        sig=lambda x, y, dz, nd: (tuple(x.shape), dz.shape[2], nd),
        bound=lambda x, y, dz, nd: cvstem_dw_bound(x.shape, dz.shape, nd),
        magnitude=lambda x, y, dz, nd: (x.abs(), y.abs(), dz.abs(), nd),
        library=_cvstem_dw_library, beside=_cvstem_dw_beside,
        plan=_cvstem_dw_plan, tol="bwd", path="default", serving=False,
        bitwise=True),
    "soft_argmin_bwd": dict(
        site=(disparity_mod, "soft_argmin_bwd"),
        plain=disparity_mod.soft_argmin_bwd_plain,
        source="rag_tpu_torch/csrc/disp_head.cu",
        replaces="rag_tpu/ops/pallas_kernels.py:295",
        sig=lambda x, g, maxdisp, scale=3: (tuple(x.shape), maxdisp, scale),
        bound=lambda x, g, maxdisp, scale=3:
            disp_bwd_bound(x.shape, maxdisp, scale),
        library=None, beside=_head_bwd_beside, beside_graph=True,
        plan=_head_bwd_plan, tol="bwd", path="default", serving=False,
        bitwise=True),
    "conv3d_dblock_cf": dict(
        site=(conv3d_mod, "conv3d_dblock_cf"),
        plain=conv3d_mod.conv3d_brc_cf_plain,
        source="rag_tpu_torch/csrc/conv3d.cu",
        replaces="rag_tpu/ops/pallas_conv3d.py:314",
        sig=lambda x, w, scale, bias, relu: (tuple(x.shape), w.shape[4], relu),
        bound=lambda x, w, scale, bias, relu: conv_bound(x.shape, w.shape[4]),
        library=_conv_library, beside=_dblock_beside, plan=_dblock_plan,
        tol="conv", path="variants", serving=True),
    "resize_taps_cf": dict(
        site=(resize_mod, "resize_taps_cf"),
        plain=resize_mod.resize_taps_plain,
        source="rag_tpu_torch/csrc/resize_taps.cu",
        replaces="rag_tpu/ops/pallas_resize.py:123",
        sig=lambda x, d2, h2, w2, align_corners=True, transposed=False:
            (tuple(x.shape), (d2, h2, w2), transposed),
        bound=lambda x, *a, **kw: resize_bound(x.shape, *a, **kw),
        library=_resize_library, beside=_resize_beside, plan=_resize_plan,
        tol="conv", path="variants", serving=True),
    "shear_forward": dict(
        site=(shear_mod, "shear_forward"),
        plain=shear_mod.shear_forward_plain,
        source="rag_tpu_torch/csrc/shear.cu",
        replaces="rag_tpu/ops/pallas_shear.py:120",
        sig=lambda px, py, scale, bias, nd, relu=False:
            (tuple(px.shape), nd, relu),
        bound=lambda px, py, scale, bias, nd, relu=False:
            shear_bound(px.shape, nd, relu),
        library=None, beside=_shear_beside, plan=_shear_plan, tol="conv",
        path="variants", serving=True, bitwise=True),
    "shear_adjoint": dict(
        site=(shear_mod, "shear_adjoint"),
        plain=shear_mod.shear_adjoint_plain,
        source="rag_tpu_torch/csrc/shear.cu",
        replaces="rag_tpu/ops/pallas_shear.py:173",
        sig=lambda dz, nd: (tuple(dz.shape), nd),
        bound=lambda dz, nd: shear_adj_bound(dz.shape, nd),
        magnitude=lambda dz, nd: (dz.abs(), nd),
        library=None, beside=_shear_adj_beside, plan=_shear_adj_plan,
        tol="bwd", path="variants", serving=False, bitwise=True),
}
for _k in KERNELS.values():
    _k["wrapper"] = getattr(*_k["site"])
# the kernels each path must run, serving and training (F only where
# stem_3d0 trains); every other kernel must not run on that path
SERVE_KERNELS = {
    "default": ("conv3d_brc_cf", "cvstem_brc", "fused_soft_argmin"),
    "variants": ("conv3d_dblock_cf", "resize_taps_cf", "shear_forward",
                 "fused_soft_argmin")}
TRAIN_KERNELS = {
    "default": SERVE_KERNELS["default"] + (
        "conv3d_dw_cf", "cvstem_dxy", "cvstem_dw", "soft_argmin_bwd"),
    "variants": SERVE_KERNELS["variants"] + (
        "shear_adjoint", "conv3d_dw_cf", "soft_argmin_bwd")}


def small_cases(dev, rng):
    """A few small shapes per kernel: Cout 1 with W not a multiple of 8,
    merged Cout 48, D not a multiple of kernel H's 4 planes, a D == W cost
    volume, num_disp past W, W = 13; for kernels B and F at C = 12 (one
    half of the volume a channel chunk) D past W with W % 4 != 0 (4-byte
    copies) and with W % 4 == 0 (16-byte copies; Y's rows at planes
    p % 4 != 0 and the diagonal's pieces in 4-byte ones, up to the right
    edge of a ragged last tile), a 4-tap and a 3-tap adjoint resize
    table, a 4x downsample (kernel I skips the planes and rows it does not
    read) and its adjoint, batch 2 for every kernel; for kernel A's plans
    W = 80 (a 16-wide tile), Cout 12 and 36 (N padded to 16 and 48) and
    Cin 12 and 36 (K padded per stage, three stages per plane at 36); for
    kernel E's, D not a multiple of its chunk (2 planes at small shapes, 16
    at the last, train-sized case) and W past one 64-wide tile."""
    def t(*shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s)
                                .astype(np.float32)).to(dev)

    def aff(c):
        return t(c, s=0.3) + 1.0, t(c, s=0.1)

    cases = []
    for b, d, cin, h, w, cout, relu in [(1, 4, 12, 16, 24, 12, True),
                                        (1, 3, 12, 8, 13, 1, False),
                                        (2, 3, 16, 9, 70, 48, True),
                                        (1, 7, 12, 12, 40, 16, True),
                                        (1, 1, 4, 8, 8, 4, False),
                                        (1, 3, 12, 10, 80, 36, True),
                                        (2, 2, 36, 9, 80, 12, False),
                                        (1, 5, 36, 20, 33, 36, True)]:
        args = (t(b, d, cin, h, w), t(3, 3, 3, cin, cout, s=0.2),
                *aff(cout), relu)
        cases.append(("conv3d_brc_cf", args))
        cases.append(("conv3d_dblock_cf", args))
        cases.append(("conv3d_dw_cf", (t(b, d, cin, h, w),
                                       t(b, d, cout, h, w))))
    # kernel D alone: Cin 4 -> 4 at W = 13 (4-byte copies), 8 -> 8 at
    # W = 16, and a shape big enough for a main-path plan (row groups, runs
    # of planes, at least 264 blocks)
    for b, d, cin, h, w, cout in [(1, 3, 4, 10, 13, 4), (2, 3, 8, 9, 16, 8),
                                  (2, 9, 4, 32, 64, 4)]:
        cases.append(("conv3d_dw_cf", (t(b, d, cin, h, w),
                                       t(b, d, cout, h, w))))
    for b, c, h, w, nd, cout in [(1, 12, 8, 20, 6, 12), (1, 2, 8, 8, 8, 3),
                                 (2, 3, 6, 11, 5, 4), (1, 2, 5, 6, 9, 3),
                                 (1, 3, 8, 13, 13, 12),
                                 (2, 12, 9, 130, 11, 12),
                                 (1, 12, 7, 21, 24, 12),
                                 (2, 12, 10, 68, 72, 12)]:
        x, y, w3 = t(b, c, h, w), t(b, c, h, w), t(3, 3, 3, 2 * c, cout, s=0.2)
        dz = t(b, nd, cout, h, w)
        cases.append(("cvstem_brc", (x, y, w3, *aff(cout), nd, True)))
        cases.append(("cvstem_dxy", (dz, w3, nd)))
        cases.append(("cvstem_dw", (x, y, dz, nd)))
        px, py = shear_mod.tap_maps(x, y, w3)
        cases.append(("shear_forward", (px.contiguous(), py.contiguous(),
                                        *aff(cout), nd, True)))
        cases.append(("shear_adjoint", (dz, nd)))
    # kernel E at the train shape with D = 60: chunks of 16, the last of 12
    cases.append(("cvstem_dxy", (t(4, 60, 12, 64, 128),
                                 t(3, 3, 3, 2 * STEM_C, 12, s=0.2), 60)))
    for shape, target, tr in [((1, 6, 5, 16, 24), (3, 8, 12), False),
                              ((2, 6, 5, 16, 24), (12, 32, 48), False),
                              ((1, 6, 3, 11, 13), (4, 6, 7), False),
                              ((1, 6, 5, 16, 24), (6, 16, 11), False),
                              ((2, 12, 5, 32, 48), (6, 16, 24), True),
                              ((1, 11, 3, 11, 11), (6, 6, 6), True),
                              ((1, 3, 4, 8, 12), (6, 16, 24), True),
                              ((1, 16, 2, 20, 40), (4, 5, 10), False),
                              ((1, 4, 2, 5, 10), (16, 20, 40), True)]:
        cases.append(("resize_taps_cf", (t(*shape), *target, True, tr)))
    # the head: the periodic instance at D = 8, W = 10; the general one
    # at D = 4 (no instance) and at maxdisp not a multiple of D
    for b, d, h, w, md in [(1, 8, 16, 10, 24), (2, 4, 5, 43, 12),
                           (1, 8, 16, 10, 26)]:
        x = t(b, d, h, w, s=3.0)
        cases.append(("fused_soft_argmin", (x, md, 3)))
        cases.append(("soft_argmin_bwd", (x, t(b, 3 * h, 3 * w), md, 3)))
    return cases


def exact_cases(dev, rng):
    """Kernels J and K on integer-valued inputs, where every order of
    summation is exact and kernel and plain version must agree bit for bit:
    D = 2 (every plane a first or last one) at odd W, the diagonal band,
    the first and last planes and the interior at odd W (4-byte copies)
    and at W % 4 == 0 (16-byte copies and stores), ReLU on and off; D = 1;
    rows wider than one block of K's walkers (K's column and diagonal
    blocks, with runs of planes: W = 520, 2100, 3001) and than one piece of
    J (column tiles: W = 2100, 3001; plane chunks: D = 70); W = 60001, past
    where a whole staged row (J) or plane (K) would fit shared memory."""
    def ints(*shape, lo=-3, hi=4):
        return torch.from_numpy(rng.integers(lo, hi, shape)
                                .astype(np.float32)).to(dev)

    cases = []
    for b, co, h, w, nd, relu in [(2, 3, 5, 13, 2, False),
                                  (1, 4, 6, 21, 9, True),
                                  (1, 4, 5, 24, 7, False),
                                  (1, 3, 4, 12, 1, True),
                                  (1, 2, 2, 520, 40, False),
                                  (1, 1, 2, 2100, 70, True),
                                  (1, 1, 1, 3001, 5, False),
                                  (1, 1, 1, 60001, 3, True)]:
        scale = torch.arange(1, co + 1, dtype=torch.float32, device=dev)
        bias = torch.full((co,), -3.0, device=dev)
        cases.append(("shear_forward", (ints(b, 9, co, h, w),
                                        ints(b, 9, co, h, w), scale, bias,
                                        nd, relu)))
        cases.append(("shear_adjoint", (ints(b, nd, co, h, w), nd)))
    return cases


# -- phases ------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (this script never "
                         "falls back to the CPU)")
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | nvidia-smi: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.lib()
    log(f"[build] {path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in (path.parent / "ptxas.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[build]   {line.strip()}")


def stereo_pair(rng, h, w, disp):
    """A random smooth texture seen by two cameras: right(x) = left(x + d)
    (disparity d everywhere the left pixel has a match)."""
    coarse = rng.standard_normal((h // 4 + 1, (w + disp) // 4 + 2, 3))
    tex = np.repeat(np.repeat(coarse, 4, 0), 4, 1)[:h, :w + disp]
    tex = (tex + 0.3 * rng.standard_normal(tex.shape)).astype(np.float32)
    return tex[None, :, :w].copy(), tex[None, :, disp:disp + w].copy()


@contextlib.contextmanager
def recording(calls, args_of):
    """Every kernel wrapper replaced by its plain version where the main
    path looks it up; each call's (name, signature) is appended to calls
    and the first real arguments of each signature kept in args_of."""
    def recorder(name):
        def run(*args, **kw):
            sig = KERNELS[name]["sig"](*args, **kw)
            calls.append((name, sig))
            if (name, sig) not in args_of:
                args_of[(name, sig)] = (
                    tuple(a.detach().clone() if isinstance(a, torch.Tensor)
                          else a for a in args), dict(kw))
            return KERNELS[name]["plain"](*args, **kw)
        return run

    launches0 = {n: k["wrapper"].launches for n, k in KERNELS.items()}
    try:
        for n, k in KERNELS.items():
            setattr(*k["site"], recorder(n))
        yield
    finally:
        for k in KERNELS.values():
            setattr(*k["site"], k["wrapper"])
    launched = {n: k["wrapper"].launches - launches0[n]
                for n, k in KERNELS.items()}
    if any(launched.values()):
        raise SystemExit(f"chip_smoke: the plain path launched {launched}")


def count_calls(calls):
    return {k: sum(1 for n, _ in calls if n == k) for k in KERNELS}


def check_called(what, counts, expected, optional=()):
    """Every expected kernel called (those in optional may not be), and no
    other kernel."""
    bad = [f"no call to {k}" for k in expected
           if counts[k] < 1 and k not in optional]
    bad += [f"{c} calls to {k}" for k, c in counts.items()
            if c and k not in expected]
    if bad:
        raise SystemExit(f"chip_smoke: {what}: " + "; ".join(bad))


def phase_record(ri, requests, args_of, path):
    """The first request of each task path through RoutedInference.predict
    on one path (ri carries its variants) with each kernel's plain version
    in its wrapper's place. Returns the plain disparities and every kernel
    call per task (name, signature)."""
    calls, plain = {}, {}
    for t, reqs in requests.items():
        calls[t] = []
        with recording(calls[t], args_of):
            plain[t] = ri.predict(*reqs[0], task=t)
        n_calls = count_calls(calls[t])
        log(f"[record] {path} task {t}: plain disparity in "
            f"[{plain[t].min():.2f}, {plain[t].max():.2f}], kernel calls "
            f"{n_calls}")
        # a call site the main path no longer reads would leave the kernel
        # unchecked and the "plain" reference running kernels
        check_called(f"{path} task {t}", n_calls, SERVE_KERNELS[path])
    return plain, calls


def leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


def train_configs(dev):
    """The two training configurations on a fresh copy of the committed
    checkpoint: task 3's fine-tune stage (BN-train = trainable = the 13
    units task 3 trains) and task 0's stage (every site, BN in train
    mode). name -> (specs, params, stats, sites)."""
    net, _ = load_checkpoint(str(CKPT), 3, device=dev)
    out = {}
    for t in (3, 0):
        specs, params, stats = net.path(net.archis[t])
        out[f"task{t}"] = (specs, params, stats, net.trainable_sites(t))
    return out


def train_batch(dev):
    """Batch 4 of seeded synthetic 192x384 pairs, each one fronto-parallel
    plane at its own disparity, with that ground truth (0 = no match)."""
    rng = np.random.default_rng(1)
    lefts, rights, gts = [], [], []
    for i in range(TRAIN_B):
        disp = 8 + 16 * i
        left, right = stereo_pair(rng, TRAIN_H, TRAIN_W, disp)
        gt = np.full((1, TRAIN_H, TRAIN_W), float(disp), np.float32)
        gt[..., :disp] = 0.0
        lefts.append(left), rights.append(right), gts.append(gt)
    return tuple(torch.from_numpy(np.concatenate(a)).to(dev)
                 for a in (lefts, rights, gts))


def train_step(cfg, params, stats, opt_state, lr, batch, path):
    specs, _, _, sites = cfg
    step = make_train_step(specs, sites, make_optimizer(WD), maxdisp=MAXDISP,
                           variants=PATHS[path])
    return step(params, stats, opt_state, lr, *batch)


def phase_record_train(dev, args_of, path):
    """One step of each training configuration on one path with the plain
    versions in the wrappers' places. Returns every kernel call per
    configuration and the plain step's dp/lr and new statistics."""
    calls, plain = {}, {}
    batch = train_batch(dev)
    lr = cosine_lr(LR, TRAIN_EPOCHS, 0)
    for name, cfg in train_configs(dev).items():
        _, params, stats, sites = cfg
        before = {k: v.clone() for k, v in leaves(params)}
        calls[name] = []
        t0 = time.perf_counter()
        with recording(calls[name], args_of):
            params, new_stats, _, sc = train_step(
                cfg, params, stats, make_optimizer(WD).init(params), lr, batch,
                path)
        torch.cuda.synchronize()
        plain[name] = (
            {k: (v - before[k]) / lr for k, v in leaves(params)
             if k.split("/")[0] in sites},
            dict(leaves(new_stats)))
        n_calls = count_calls(calls[name])
        log(f"[record-train] {path} {name} ({len(sites)} trainable sites): "
            f"plain step {(time.perf_counter() - t0) * 1e3:.0f} ms, loss "
            f"{float(sc['loss']):.4f}, kernel calls {n_calls}")
        check_called(f"{path} {name}", n_calls, TRAIN_KERNELS[path],
                     () if "stem_3d0" in sites else ("cvstem_dw",))
    return plain, calls


def _max_err(out, ref):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
    return err, max(float(r.abs().max()) for r in refs)


def check_kernel(name, args, kw, reps, beside, exact=False):
    """Kernel vs plain on one set of arguments (with exact: bit for bit);
    times of kernel, plain, library and (with beside) the calls timed
    beside it. Returns a result dict (no assertion here)."""
    k = KERNELS[name]
    with torch.inference_mode():
        out = k["wrapper"](*args, **kw)
        ref = k["plain"](*args, **kw)
        # a kernel that sums in a fixed order gives the same bits twice
        same = True
        if k.get("bitwise"):
            again = k["wrapper"](*args, **kw)
            same = all(torch.equal(o, a) for o, a in zip(
                out if isinstance(out, tuple) else (out,),
                again if isinstance(again, tuple) else (again,)))
            del again
        torch.cuda.synchronize()
        err, ref_max = _max_err(out, ref)
        del out, ref
        if k["tol"] == "bwd" and "magnitude" in k:
            mags = k["plain"](*k["magnitude"](*args), **kw)
            ref_max = _max_err(mags, mags)[1]
            del mags
        tol = 0.0 if exact else {"conv": CONV_RTOL * max(1.0, ref_max),
                                 "disp": DISP_ATOL,
                                 "bwd": BWD_RTOL * ref_max}[k["tol"]]
        ms = cuda_ms(lambda: k["wrapper"](*args, **kw), reps)
        plain_ms = cuda_ms(lambda: k["plain"](*args, **kw), max(1, reps // 2))
        lib_ms = (cuda_ms(k["library"](*args, **kw), reps)
                  if k["library"] is not None else None)
    extra = {}
    if beside and "beside" in k:
        # outside inference mode: the shear stem's backward is autograd's
        timer = graph_ms if k.get("beside_graph") else cuda_ms
        extra = {f: timer(fn, reps)
                 for f, fn in k["beside"](*args, **kw).items()}
    bound_ms, bound_by = k["bound"](*args, **kw)
    plan = k["plan"](*args, **kw) if "plan" in k else {}
    return dict(err=err, tol=tol, ok=bool(err <= tol) and same, same=same,
                ms=ms,
                plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bound_ms,
                bound_ops_ms=bound_ms if bound_by == "operations" else 0.0,
                bound_by=bound_by, beside=extra, plan=plan)


def check_weight_pass(dev, rng):
    """Kernel A's first pass (the weights' TF32 split, in mma fragment
    order) against its plain version, bit for bit: K padded per stage (Cin
    12, 36), N padded (Cout 1, 12, 36), a Cout split, 16 channels a stage,
    and kernel B's plan at the eval geometry (two stages of 12 a plane)."""
    plans = [((cin, cout), conv3d_mod.conv_plan(b, d, cin, h, w, cout))
             for cin, cout, b, d, h, w in [
                 (12, 12, 1, 64, 160, 320), (12, 1, 1, 64, 160, 320),
                 (36, 36, 1, 3, 10, 80), (16, 48, 1, 16, 40, 80),
                 (48, 16, 4, 16, 16, 32), (4, 8, 1, 64, 160, 320)]]
    # kernel B's at the eval geometry (the stem's 24 -> 12)
    plans.append(((2 * STEM_C, 12), cvstem_mod.cvstem_plan(
        1, MAXDISP // 3, STEM_C, H // 3, W // 3, 12)))
    for (cin, cout), plan in plans:
        wt = torch.from_numpy(rng.standard_normal((3, 3, 3, cin, cout))
                              .astype(np.float32)).to(dev)
        got = conv3d_mod.pack_weights_cuda(wt, plan)
        want = conv3d_mod.pack_weights_tf32(wt, plan)
        if not torch.equal(got, want):
            raise SystemExit(f"chip_smoke: kernel A's weight pass differs "
                             f"from pack_weights_tf32 at Cin {cin} Cout "
                             f"{cout}")
    log("[kernels] kernel A's weight pass equals pack_weights_tf32 bit for "
        f"bit at {len(plans)} plans (kernel B's at the eval geometry)")


def phase_kernels(args_of, dev):
    results, failures = {}, []
    rng = np.random.default_rng(7)
    check_weight_pass(dev, rng)
    todo = [("main", name, sig, args, kw)
            for (name, sig), (args, kw) in args_of.items()]
    todo += [(where, name, KERNELS[name]["sig"](*args), args, {})
             for where, cases in (("small", small_cases(dev, rng)),
                                  ("exact", exact_cases(dev, rng)))
             for name, args in cases]
    for where, name, sig, args, kw in todo:
        main = where == "main"
        r = check_kernel(name, args, kw, REPS if main else 5, main,
                         exact=where == "exact")
        if main:
            results[(name, sig)] = r
        line = {"kernel": name, "at": where, "sig": str(sig),
                "max_abs_err": r["err"], "tol": r["tol"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "library_ms": r["lib_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                **r["beside"], **r["plan"]}
        if KERNELS[name].get("bitwise"):
            line["repeat_bit_identical"] = r["same"]
        log(f"[kernels] {json.dumps(line)}")
        if not r["ok"]:
            failures.append(f"{name} {where} {sig}: max_abs_err {r['err']:.3g}"
                            f" (tolerance {r['tol']:.3g}), two launches "
                            f"bit-identical: {r['same']}")
        KERNELS[name].setdefault("max_err", 0.0)
        KERNELS[name]["max_err"] = max(KERNELS[name]["max_err"], r["err"])
    if failures:
        raise SystemExit("chip_smoke: kernels disagree with their plain "
                         "versions:\n  " + "\n  ".join(failures))
    return results


def check_disparity(what, d):
    if d.shape != (1, H, W) or not np.isfinite(d).all():
        return [f"{what}: shape {d.shape} or non-finite values"]
    if d.min() < 0 or d.max() > MAXDISP - 1:
        return [f"{what}: disparity outside [0, {MAXDISP - 1}]"]
    return []


def phase_serve(ri, requests, plain, path, default_outs=None):
    """REQUESTS requests per task path on one path, every launch count set
    to 0 first. The variant path's first disparity per task is also held
    against the default kernel path's (default_outs)."""
    for k in KERNELS.values():
        k["wrapper"].launches = 0
    outs, times = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for t, reqs in requests.items():
        outs[t], times[t] = [], []
        for left, right in reqs:
            t0 = time.perf_counter()
            disp = ri.predict(left, right, task=t)   # returns on the host
            times[t].append((time.perf_counter() - t0) * 1e3)
            outs[t].append(disp)
    launches = {n: k["wrapper"].launches for n, k in KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[serve] {path}: launches in the main-path run: {launches}; peak "
        f"device memory {peak_gb:.2f} GB")

    failures = [f"{n} never launched" for n in SERVE_KERNELS[path]
                if launches[n] <= 0]
    failures += [f"{n} launched while serving" for n, c in launches.items()
                 if n not in SERVE_KERNELS[path] and c != 0]
    per_task = {}
    for t in requests:
        for i, d in enumerate(outs[t]):
            failures += check_disparity(f"{path} task {t} request {i}", d)
        diff = float(np.abs(outs[t][0] - plain[t]).max())
        if not diff <= SERVE_ATOL:
            failures.append(f"{path} task {t}: kernel path vs plain path "
                            f"{diff:.3g} px > {SERVE_ATOL}")
        vs_default = None
        if default_outs is not None:
            vs_default = float(np.abs(outs[t][0] - default_outs[t][0]).max())
            if not vs_default <= SERVE_ATOL:
                failures.append(f"{path} task {t}: vs the default kernel "
                                f"path {vs_default:.3g} px > {SERVE_ATOL}")
        gt = torch.full((1, H, W), float(TRUE_DISP))
        gt[..., :TRUE_DISP] = 0.0
        m = stereo_metrics(torch.from_numpy(outs[t][0]), gt,
                           (gt > 0) & (gt < MAXDISP))
        steady = times[t][1:] or times[t]
        per_task[t] = dict(first_ms=times[t][0],
                           ms_per_request=float(np.mean(steady)),
                           vs_plain_max_px=diff, vs_default_max_px=vs_default,
                           epe_vs_plane=float(m["EPE"]), d1=float(m["D1"]),
                           peak_gb=peak_gb)
        log(f"[serve] {path} task {t}: {json.dumps(per_task[t])}")
    if failures:
        raise SystemExit("chip_smoke: serve failed:\n  " + "\n  ".join(failures))
    return launches, per_task, outs


def router_bound(params, b, h, w):
    """Least device time of router_logits on (b, h, w, 3) frames: its conv
    products at the float32 peak, or its frames and weights read once."""
    flops, hh, ww = 0, h, w
    for name in ("c0", "c1", "c2"):
        hh, ww = -(-hh // 2), -(-ww // 2)
        kh, kw, cin, cout = params[name].shape
        flops += 2 * b * hh * ww * cout * cin * kh * kw
    nbytes = 4 * (b * h * w * 3 + sum(v.numel() for v in params.values()))
    return _bound(flops, nbytes)


def route_scenes(dev, cache):
    """The canonical run's four styled 480x960 test scenes on the card."""
    return [SyntheticStereoDataset(SCENE_FRAMES, H, W, seed=30 + t,
                                   max_disp=SCENE_DISP,
                                   style=WEATHER_STYLES[t], device=dev,
                                   cache=cache)
            for t in range(len(WEATHER_STYLES))]


def phase_route_setup(dev, cache):
    """Load the committed router onto the card (and onto the CPU), build
    the test scenes on the card, route every left frame on the card and
    again on the CPU in float32: the ids must be equal frame by frame.
    Returns the router, the scenes, the ids per scene and a summary."""
    t0 = time.perf_counter()
    router = load_router(str(CKPT), device=dev)
    router_cpu = load_router(str(CKPT), device="cpu")
    if (router is None or router.num_tasks != 4
            or router.input_key != "left"):
        raise SystemExit(f"chip_smoke: route: {CKPT.relative_to(ROOT)}/"
                         "router.npz missing or not a 4-task router on "
                         "'left' frames")
    scenes = route_scenes(dev, cache)
    ids, failures = [], []
    for t, ds in enumerate(scenes):
        left = next(ds.batches(len(ds), False))["left"]
        if left.device.type != router.device.type:
            raise SystemExit(f"chip_smoke: route: the test scenes are on "
                             f"{left.device}, not on {router.device}")
        ids.append(router.predict(left))
        on_cpu = router_cpu.predict(ds._samples()["left"])
        if not np.array_equal(ids[t], on_cpu):
            failures.append(f"scene {t}: card routes {ids[t].tolist()}, CPU "
                            f"{on_cpu.tolist()}")
    if failures:
        raise SystemExit("chip_smoke: route failed:\n  "
                         + "\n  ".join(failures))
    n = len(scenes)
    confusion = np.zeros((n, router.num_tasks), np.int64)
    for t, i in enumerate(ids):
        np.add.at(confusion[t], i, 1)
    ref = json.loads(RESULT.read_text())["router"]
    summary = dict(scene_accuracy=float(np.trace(confusion) / confusion.sum()),
                   confusion=confusion.tolist(),
                   confusion_result_json=ref["confusion"],
                   card_equals_cpu=True,
                   resident_gb=cache.nbytes / 1e9,
                   setup_s=time.perf_counter() - t0)
    log(f"[route] {CKPT.relative_to(ROOT)}/router.npz on the card; "
        f"{n} scenes x {SCENE_FRAMES} frames of {H}x{W} on the card "
        f"({summary['resident_gb']:.2f} GB); card and CPU route ids equal "
        f"on all {confusion.sum()} frames; scene accuracy "
        f"{summary['scene_accuracy']:.4f}; confusion {summary['confusion']} "
        f"(result.json {ref['confusion']}); {summary['setup_s']:.1f} s")
    return router, scenes, ids, summary


def phase_route(ri, scenes, ids, path):
    """Per path, every launch count set to 0 first: routed evaluation of
    each scene against evaluation on its own task path (equal metrics
    where every frame was routed to its own task), and ROUTE_REQUESTS
    routed requests per scene beside the same requests with the task
    given (equal disparity where the frame was routed right)."""
    for k in KERNELS.values():
        k["wrapper"].launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ref = json.loads(RESULT.read_text())["router"]["routed"]
    per_scene, failures = {}, []
    for t, ds in enumerate(scenes):
        right_scene = bool((ids[t] == t).all())
        routed = ri.evaluate(ds, task=None)
        oracle = ri.evaluate(ds, task=t)
        if right_scene and routed != oracle:
            failures.append(f"{path} scene {t}: routed {routed} != oracle "
                            f"{oracle}")
        host = ds._samples()
        times = {"routed": [], "fixed": []}
        for i in range(ROUTE_REQUESTS):
            left, right = host["left"][i:i + 1], host["right"][i:i + 1]
            order = (("routed", None), ("fixed", t))
            outs = {}
            for kind, task in (order if i % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                outs[kind] = ri.predict(left, right, task=task)
                times[kind].append((time.perf_counter() - t0) * 1e3)
                failures += check_disparity(f"{path} scene {t} {kind} "
                                            f"request {i}", outs[kind])
            if ids[t][i] == t and not np.array_equal(outs["routed"],
                                                     outs["fixed"]):
                failures.append(f"{path} scene {t} request {i}: routed "
                                "disparity != the task's")
        per_scene[t] = dict(
            routed_right=right_scene, routed=routed, oracle=oracle,
            d1_vs_result_json=routed["D1"] - ref["D1"][t],
            epe_vs_result_json=routed["EPE"] - ref["EPE"][t],
            routed_ms_per_request=float(np.mean(times["routed"])),
            fixed_ms_per_request=float(np.mean(times["fixed"])))
        log(f"[route] {path} scene {t}: routed D1 {routed['D1']:.6f} EPE "
            f"{routed['EPE']:.6f} (result.json {ref['D1'][t]:.6f} / "
            f"{ref['EPE'][t]:.6f}, diff {per_scene[t]['d1_vs_result_json']:+.2e}"
            f" / {per_scene[t]['epe_vs_result_json']:+.2e}); routed == oracle "
            f"{routed == oracle}; ms/request routed "
            f"{per_scene[t]['routed_ms_per_request']:.2f}, task given "
            f"{per_scene[t]['fixed_ms_per_request']:.2f}")
    launches = {n: k["wrapper"].launches for n, k in KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[route] {path}: launches in the routed run: {launches}; peak "
        f"device memory {peak_gb:.2f} GB (with the resident scenes)")
    failures += [f"{path}: {n} never launched" for n in SERVE_KERNELS[path]
                 if launches[n] <= 0]
    failures += [f"{path}: {n} launched while serving"
                 for n, c in launches.items()
                 if n not in SERVE_KERNELS[path] and c != 0]
    if failures:
        raise SystemExit("chip_smoke: route failed:\n  "
                         + "\n  ".join(failures))
    return launches, dict(scenes=per_scene, peak_gb=peak_gb, routed_ms=float(
        np.mean([v["routed_ms_per_request"] for v in per_scene.values()])),
        fixed_ms=float(np.mean([v["fixed_ms_per_request"]
                                for v in per_scene.values()])))


def router_time(router, scenes):
    """The router alone on one 1x480x960 frame: its logits timed with CUDA
    events back to back (~20 launches, so the host's launch rate shows)
    and as replays of a CUDA graph (device time alone), the host time of
    a routing decision (logits, argmax and the ids' copy to the host), and
    its bound."""
    frame = next(scenes[0].batches(1, False))["left"]
    with torch.inference_mode():
        ms = cuda_ms(lambda: router_logits(router.params, frame), REPS * 2)
        graph = graph_ms(lambda: router_logits(router.params, frame),
                         REPS * 2)
        router.predict(frame)
        host = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            router.predict(frame)
            host.append((time.perf_counter() - t0) * 1e3)
    bound, bound_by = router_bound(router.params, 1, H, W)
    out = dict(logits_ms=ms, logits_graph_ms=graph,
               route_host_ms=float(np.mean(host)),
               bound_ms=bound, bound_by=bound_by)
    log(f"[route] router alone, 1x{H}x{W}: {json.dumps(out)}")
    return out


def _rel_l2(a, b):
    num = sum(float(((x.double().cpu() - y.double()) ** 2).sum())
              for x, y in zip(a, b))
    den = sum(float((y.double() ** 2).sum()) for y in b)
    return (num / den) ** 0.5


def phase_router_train(dev, scenes):
    """A fresh router on the card: its first Adam step against the same
    step of the port on the CPU from the same state and batch, then
    ROUTER_EPOCHS epochs on four styled train scenes (losses finite and
    falling), and its accuracy on the test scenes (not gated: far fewer
    pairs and epochs than the canonical run)."""
    t0 = time.perf_counter()
    cache = DeviceCache()
    train = [SyntheticStereoDataset(ROUTER_TRAIN_PAIRS, ROUTER_TRAIN_H,
                                    ROUTER_TRAIN_W, seed=10 + t,
                                    max_disp=SCENE_DISP,
                                    style=WEATHER_STYLES[t], device=dev,
                                    cache=cache)
             for t in range(len(WEATHER_STYLES))]
    # the first step of train(): scene 0's first batch of epoch 0, label 0
    frames = next(train[0].batches(ROUTER_BATCH, True, seed=0))["left"]
    labels = torch.zeros(frames.shape[0], dtype=torch.int64)
    steps = {}
    for where, x, y in (("card", frames, labels.to(dev)),
                        ("cpu", frames.cpu(), labels)):
        r = SceneRouter(4, seed=0, device=x.device)
        before = r.params
        p, o, loss = make_router_train_step(r.optimizer)(
            r.params, r.opt_state, x, y)
        steps[where] = ([p[k] - before[k] for k in sorted(p)],
                        [o["mu"][k] for k in sorted(p)],
                        [o["nu"][k] for k in sorted(p)], float(loss),
                        int(o["count"]))
    step_err = {name: _rel_l2(steps["card"][i], steps["cpu"][i])
                for i, name in enumerate(("update", "mu", "nu"))}
    failures = [f"first step, {k} vs the CPU: {v:.3g} > {ROUTER_STEP_RTOL}"
                for k, v in step_err.items() if not v <= ROUTER_STEP_RTOL]
    if steps["card"][4] != steps["cpu"][4]:
        failures.append(f"first step: count {steps['card'][4]} != "
                        f"{steps['cpu'][4]}")

    router = SceneRouter(4, seed=0, device=dev)
    for ds in train:        # make and upload every set before the clock
        next(ds.batches(1, False))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = router.train(train, epochs=ROUTER_EPOCHS, batch=ROUTER_BATCH,
                          log=log)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    if (len(losses) != ROUTER_EPOCHS or not np.isfinite(losses).all()
            or not losses[-1] < losses[0]):
        failures.append(f"router losses {losses}: not finite and falling")
    if failures:
        raise SystemExit("chip_smoke: router training failed:\n  "
                         + "\n  ".join(failures))
    acc = router.accuracy(scenes)
    steps_run = int(router.opt_state["count"])
    out = dict(first_step_vs_cpu=step_err,
               first_loss_card=steps["card"][3], first_loss_cpu=steps["cpu"][3],
               losses=losses, steps=steps_run, train_s=train_s,
               ms_per_step=train_s * 1e3 / steps_run,
               test_accuracy=acc, wall_s=time.perf_counter() - t0)
    log(f"[route] router training on the card: {json.dumps(out)}")
    return out


# kinds of device kernel in a trace, matched in order on the lower-cased
# name (the port's A-K first; kernel_kind sorts B and F apart: they are the
# engines of A and D with the cost-volume policy). Kernel H is kernel A's
# engine: "A (H)" is A on the default path, H on the variant path, which
# runs no kernel A; it also holds B's weight pass. "D (F) sum" holds both
# sum passes
KINDS = (("conv3d_tf32x3_kernel", "A (H)"), ("conv3d_pack_kernel", "A (H)"),
         ("conv3d_dw_kernel", "D"),
         ("conv3d_dw_sum_kernel", "D (F) sum"),
         ("cvstem_dxy", "E"),
         ("soft_argmin_kernel", "C"), ("soft_argmin_fold_kernel", "G"),
         ("soft_argmin_gather_kernel", "G"), ("resize_taps_kernel", "I"),
         ("shear_fwd_kernel", "J"), ("shear_adj_kernel", "K"),
         ("gemm", "GEMM"), ("reduce_kernel", "reductions"),
         ("elementwise", "elementwise"), ("cudnn", "cuDNN"),
         ("grad", "cuDNN"), ("conv", "cuDNN"), ("", "other"))


def kernel_kind(name: str) -> str:
    if "CostVolumeSrc" in name:
        return "F" if "conv3d_dw_kernel" in name else "B"
    low = name.lower()
    return next(kind for key, kind in KINDS if key in low)


def device_breakdown(trace: Path) -> dict:
    """ms of device time by kind in an exported chrome trace: each of the
    port's kernels (A and H also count their dx launches), GEMMs,
    reductions, elementwise, cuDNN, copies and the rest."""
    data = json.loads(trace.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    out = {}
    for e in events:
        cat = e.get("cat")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        kind = kernel_kind(e["name"]) if cat == "kernel" else "copies"
        out[kind] = out.get(kind, 0.0) + e.get("dur", 0) / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profile(fn, label: str, out_dir: Path) -> None:
    """torch.profiler over one call of fn (after one warm-up call): the
    kernel table and trace go to out_dir, the device busy share and the
    top device entries to the log."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # the attribute's name changed across PyTorch releases
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    # device-side entries only (kernels, copies): the host ops that launch
    # them carry the same time again
    dev_us = sum(getattr(e, key) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_{label}.txt").write_text(
        events.table(sort_by=key, row_limit=60))
    trace = out_dir / f"trace_{label}.json"
    prof.export_chrome_trace(str(trace))
    n_dev = sum(e.count for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA)
    log(f"[profile] {label}: wall {wall_ms:.2f} ms, device busy "
        f"{dev_us / 1e3:.2f} ms ({100 * dev_us / 1e3 / wall_ms:.1f}%), "
        f"{n_dev} device operations; ms by kind "
        + json.dumps({k: round(v, 3) for k, v in
                      device_breakdown(trace).items()}))
    for e in sorted(events, key=lambda e: -getattr(e, key))[:24]:
        log(f"[profile]   {getattr(e, key) / 1e3:9.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


def phase_profile(ris, requests, dev, out_dir: Path) -> None:
    """Per path: one steady request of the last task path and one steady
    train step of task 0's stage under the profiler."""
    t = max(requests)
    left, right = requests[t][0]
    batch = train_batch(dev)
    for path, ri in ris.items():
        profile(lambda: ri.predict(left, right, task=t),
                f"serve_task{t}_{path}", out_dir)
        cfg = train_configs(dev)["task0"]
        state = [cfg[1], cfg[2], make_optimizer(WD).init(cfg[1])]

        def step():
            state[:3] = train_step(cfg, *state, LR, batch, path)[:3]
        profile(step, f"train_task0_{path}", out_dir)


def compare_step(name, delta, new_stats, plain):
    """The kernel step's dp/lr and statistics against the plain step's."""
    p_delta, p_stats = plain
    num = sum(float(((delta[k] - p_delta[k]) ** 2).sum()) for k in p_delta)
    den = sum(float((p_delta[k] ** 2).sum()) for k in p_delta)
    rel_l2 = (num / den) ** 0.5
    leaf = max(float((delta[k] - p_delta[k]).abs().max()
                     / p_delta[k].abs().max().clamp(min=1e-30))
               for k in p_delta)
    stats_err = max(float((new_stats[k] - v).abs().max()
                          / max(1.0, float(v.abs().max())))
                    for k, v in p_stats.items())
    log(f"[train] {name}: first step vs plain step: dp/lr relative L2 "
        f"{rel_l2:.3e} (tolerance {STEP_RTOL}), worst leaf max-relative "
        f"{leaf:.3e}; BN statistics {stats_err:.3e} (tolerance {STATS_RTOL})")
    failures = []
    if not rel_l2 <= STEP_RTOL:
        failures.append(f"{name}: dp/lr vs plain step {rel_l2:.3g}")
    if not stats_err <= STATS_RTOL:
        failures.append(f"{name}: statistics vs plain step {stats_err:.3g}")
    return dict(vs_plain_dp_rel_l2=rel_l2, vs_plain_worst_leaf=leaf,
                vs_plain_stats=stats_err), failures


def phase_train(dev, plain, path):
    """TRAIN_STEPS steps of each configuration on one path through
    make_train_step on a fresh copy of the checkpoint, every launch count
    set to 0 first."""
    for k in KERNELS.values():
        k["wrapper"].launches = 0
    batch = train_batch(dev)
    per_cfg, failures = {}, []
    for name, cfg in train_configs(dev).items():
        _, params, stats, sites = cfg
        opt_state = make_optimizer(WD).init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(TRAIN_STEPS):
            lr = cosine_lr(LR, TRAIN_EPOCHS, i)
            before = ({k: v.clone() for k, v in leaves(params)} if i == 0
                      else None)
            t0 = time.perf_counter()
            params, stats, opt_state, sc = train_step(
                cfg, params, stats, opt_state, lr, batch, path)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(sc["loss"]))
            if i == 0:
                delta = {k: (v - before[k]) / lr for k, v in leaves(params)
                         if k.split("/")[0] in sites}
                cmp, bad = compare_step(f"{path} {name}", delta,
                                        dict(leaves(stats)), plain[name])
                failures += bad
                del before, delta
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        trained = [k for k, _ in leaves(params) if k.split("/")[0] in sites]
        finite = all(bool(torch.isfinite(v).all()) for k, v in leaves(params)
                     if k in trained)
        if not (finite and all(np.isfinite(losses))):
            failures.append(f"{path} {name}: non-finite loss {losses} or "
                            "leaves")
        steady = times[1:] or times
        ms = float(np.mean(steady))
        per_cfg[name] = dict(sites=len(sites), leaves_trained=len(trained),
                             first_ms=times[0], ms_per_step=ms,
                             pairs_per_s=TRAIN_B / (ms / 1e3),
                             peak_gb=peak_gb, loss=losses, **cmp)
        log(f"[train] {path} {name}: {json.dumps(per_cfg[name])}")
    launches = {n: k["wrapper"].launches for n, k in KERNELS.items()}
    log(f"[train] {path}: launches in the training run: {launches}")
    failures += [f"{path}: {n} never launched" for n in TRAIN_KERNELS[path]
                 if launches[n] <= 0]
    failures += [f"{path}: {n} launched" for n, c in launches.items()
                 if n not in TRAIN_KERNELS[path] and c != 0]
    if failures:
        raise SystemExit("chip_smoke: train failed:\n  " + "\n  ".join(failures))
    return launches, per_cfg


def per_key(results, calls, name, field):
    """Sum of a per-call number over one request (or step), averaged over
    the task paths (or configurations) that call the kernel."""
    sums = []
    for key_calls in calls.values():
        vals = [results[(n, s)][field] for n, s in key_calls if n == name]
        if not vals:
            continue
        if any(v is None for v in vals):
            return None
        sums.append(sum(vals))
    return float(np.mean(sums))


def kernel_numbers(results, calls, name):
    bound = per_key(results, calls, name, "bound_ms")
    bound_ops = per_key(results, calls, name, "bound_ops_ms")
    out = {"ms": per_key(results, calls, name, "ms"),
           "plain_ms": per_key(results, calls, name, "plain_ms"),
           "bound_ms": bound,
           "bound_by": "operations" if bound_ops >= bound / 2 else "bytes",
           "library_ms": per_key(results, calls, name, "lib_ms")}
    # the calls timed beside the kernel and A's tensor-core bound, summed
    # like its own time
    first = next(results[(n, s)] for c in calls.values() for n, s in c
                 if n == name)
    besides = {key: r["beside"] for key, r in results.items()}
    for field in first["beside"]:
        out[field] = per_key(besides, calls, name, field)
    if "bound_tf32x3_ms" in first["plan"]:
        plans = {key: r["plan"] for key, r in results.items()}
        out["bound_tf32x3_ms"] = per_key(plans, calls, name,
                                         "bound_tf32x3_ms")
    return out


def shape_numbers(results, calls, name):
    """Per distinct call of one kernel in one step: its calls per step and
    its numbers and plan at that shape."""
    sigs = [s for c in calls.values() for n, s in c if n == name]
    out = []
    for sig in dict.fromkeys(sigs):
        r = results[(name, sig)]
        out.append({"sig": str(sig), "calls": sigs.count(sig), "ms": r["ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "plain_ms": r["plain_ms"], "library_ms": r["lib_ms"],
                    **r["beside"], **r["plan"]})
    return out


def side_by_side(runs, key):
    """{path: [{name: {key: v}} per turn]} -> 'name default v, v / variants
    v, v; ...' (each path's turns in order)."""
    names = runs["default"][0]
    return "; ".join(f"{n} " + " / ".join(
        ", ".join(f"{run[n][key]:.2f}" for run in runs[p]) for p in PATHS)
        for n in names)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", type=Path, default=None,
                    help="also profile one request and one train step per "
                         "path; write tables and traces here")
    ap.add_argument("--small-only", action="store_true",
                    help="build and check every kernel at the small shapes "
                         "only; no report")
    opts = ap.parse_args()
    t_start = time.perf_counter()

    smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    if opts.small_only:
        phase_kernels({}, dev)
        log(f"[small-only] all kernels agree at the small shapes; "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0

    t0 = time.perf_counter()
    net, _ = load_checkpoint(str(CKPT), 3, device=dev)
    ris = {p: RoutedInference(net, maxdisp=MAXDISP, device=dev, variants=v)
           for p, v in PATHS.items()}
    log(f"[serve] restored {CKPT.relative_to(ROOT)} task 3 "
        f"({len(net.archis)} task paths) in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    requests = {t: [stereo_pair(rng, H, W, TRUE_DISP)
                    for _ in range(REQUESTS)]
                for t in range(len(net.archis))}

    args_of, plain, calls, plain_train, train_calls = {}, {}, {}, {}, {}
    for p in PATHS:
        plain[p], calls[p] = phase_record(ris[p], requests, args_of, p)
        plain_train[p], train_calls[p] = phase_record_train(dev, args_of, p)
    log(f"[record] {len(args_of)} distinct kernel signatures on the main "
        f"paths ({time.perf_counter() - t_start:.0f} s)")
    results = phase_kernels(args_of, dev)
    del args_of
    torch.cuda.empty_cache()
    log(f"[kernels] done ({time.perf_counter() - t_start:.0f} s)")
    # launches summed over a kernel's runs; times kept per turn
    launches = dict.fromkeys(KERNELS, 0)
    per_task, per_cfg, outs = ({p: [] for p in PATHS} for _ in range(3))
    for p in TURNS:
        n, tasks, o = phase_serve(ris[p], requests, plain[p], p,
                                  outs["default"][0] if p != "default"
                                  else None)
        per_task[p].append(tasks)
        outs[p].append(o)
        launches = {k: launches[k] + n[k] for k in KERNELS}
    t_route = time.perf_counter()
    scene_cache = DeviceCache()
    router, scenes, ids, route = phase_route_setup(dev, scene_cache)
    routed_ris = {p: RoutedInference(net, router=router, maxdisp=MAXDISP,
                                     device=dev, variants=v)
                  for p, v in PATHS.items()}
    per_route = {p: [] for p in PATHS}
    for p in TURNS:
        n, res = phase_route(routed_ris[p], scenes, ids, p)
        per_route[p].append(res)
        launches = {k: launches[k] + n[k] for k in KERNELS}
    route["router_alone"] = router_time(router, scenes)
    route["router_training"] = phase_router_train(dev, scenes)
    del routed_ris, router, scenes, scene_cache
    torch.cuda.empty_cache()
    route["wall_s"] = time.perf_counter() - t_route
    log(f"[route] phase wall time {route['wall_s']:.1f} s")
    for p in TURNS:
        n, cfgs = phase_train(dev, plain_train[p], p)
        per_cfg[p].append(cfgs)
        launches = {k: launches[k] + n[k] for k in KERNELS}
    if opts.profile is not None:
        phase_profile(ris, requests, dev, opts.profile)

    # serving kernels report per request over the task paths of their path
    # (and carry their training numbers apart); backward kernels per
    # training step of task 0's stage, the configuration that runs them all
    report = []
    for name, k in KERNELS.items():
        p = k["path"]
        train0 = {"task0": train_calls[p]["task0"]}
        entry = {"name": name, "route": "cuda", "source": k["source"],
                 "replaces": k["replaces"],
                 "launches": launches[name],
                 "max_abs_err": k["max_err"],
                 **kernel_numbers(results, calls[p] if k["serving"]
                                  else train0, name),
                 "path": p, "status": "ok"}
        if k["serving"]:
            entry["train_step"] = kernel_numbers(results, train0, name)
        if k.get("per_shape"):
            entry["shapes"] = shape_numbers(results, train0, name)
        report.append(entry)
    log("[report] serving kernels: times per request summed over its calls "
        "and averaged over the task paths of their path; every kernel's "
        "\"train_step\" or own numbers: per step of task 0's stage; "
        "launches: every serve and train run of both paths")
    log("[report] ms/request (default turns 1, 4 / variants turns 2, 3): "
        + side_by_side(per_task, "ms_per_request"))
    log("[report] peak GB per request (default / variants): "
        + side_by_side(per_task, "peak_gb"))
    for key in ("ms_per_step", "pairs_per_s", "peak_gb"):
        log(f"[report] {key} (default turns 1, 4 / variants turns 2, 3): "
            + side_by_side(per_cfg, key))
    log("[report] routed ms/request (default turns 1, 4 / variants turns "
        "2, 3): " + " / ".join(", ".join(f"{r['routed_ms']:.2f}"
                                        for r in per_route[p]) for p in PATHS)
        + "; task given: " + " / ".join(
            ", ".join(f"{r['fixed_ms']:.2f}" for r in per_route[p])
            for p in PATHS))
    log(f"[report] total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"route": {"device": smi, **route,
                                "turns": {p: per_route[p] for p in PATHS}}}))
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
