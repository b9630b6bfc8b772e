"""The stereo pipeline: Feature Net -> fused cost volume + matching stem
-> channel-first Matching Net -> fused soft-argmin disparity head.

Counterpart of rag_tpu/models/stereo.py::stereo_forward with
``cf_matching=True, fused_head=True``. A *path* is a dict site -> (spec,
params, stats) over the 18 searchable sites plus the 3 per-task heads;
``stereo_forward`` is a function of (specs, params, stats, inputs,
train_sites) and returns the disparity and the new BatchNorm statistics:
sites in ``train_sites`` run BatchNorm in train mode, every other site
normalizes with its frozen running statistics.

The hand-written kernels run here and in the backward: kernel B
(ops.cvstem, with E and F behind it) for ``stem_3d0``, kernel A
(ops.conv3d, with D) for every 3x3x3 conv after it, and kernel C
(ops.disparity, with G) for the head. ``variants`` (ops.variants.
KernelVariants, all off by default) swaps in the counterparts of rag_tpu's
off-by-default TPU kernels: kernel H for A (``conv3d_dblock``), kernel I
for the matrix resizes (``resize_kernel``), and the shear stem, tap maps
plus kernels J and K, for B, E and F (``shear_stem``).
``precision`` (ops.precision.Precision, float32 by default) casts the
feature net's and the matching half's activations to bf16 at rag_tpu's
boundaries (``--bf16``); the head runs in float32.

Spatial sharding: with a ``mesh`` whose model axis is > 1 (the
counterpart of rag_tpu's ``cost_constraint``, which constrains the
volume to P(data, None, model)), every rank computes the whole feature
map of its images and the matching net on its H slab [h0, h1) of every
volume (``parallel.mesh.slab_rows`` at each scale). The stem needs no
exchange: the cost volume's row h reads feature row h only, so the stem's
kernel runs on feature rows [h0 - 1, h1 + 1) (clipped at the global
edges) and its output is cropped to [h0, h1). The ops that read across
rows run through ``parallel.halo.SlabVolume`` in place of
``ops.volume.WHOLE``: the 3x3x3 convs exchange one halo row with each
neighbour, the resizes gather the whole H, the head runs on the slab
with one halo row on each side that has a neighbour, and train-mode
BatchNorm of the matching sites reduces its sums over the whole world
(each rank holds a slab), the feature net's over the data axis (every
model rank holds the same whole map). The same kernels run on every
rank; the result is rows [3 h0, 3 h1) of the disparity.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Tuple, Union

import torch

from rag_tpu_torch.ops.cell import (
    CellSpec,
    apply_cell,
    apply_cell_cf,
    cell_out_height,
    init_cell,
)
from rag_tpu_torch.ops.convbr import ConvBRSpec, apply_convbr, bn_fold, init_convbr
from rag_tpu_torch.ops.conv3d import needs_grad
from rag_tpu_torch.ops.convbr_cf import apply_convbr_cf, batch_norm_cf
from rag_tpu_torch.ops.cost_volume import cost_volume_cf
from rag_tpu_torch.ops.cvstem import cvstem_brc, cvstem_conv
from rag_tpu_torch.ops.precision import FP32, Precision, wide
from rag_tpu_torch.ops.shear import shear_stem_brc, shear_stem_z
from rag_tpu_torch.ops.variants import DEFAULT, KernelVariants
from rag_tpu_torch.ops.volume import WHOLE
from rag_tpu_torch.parallel.axis import bn_collective
from rag_tpu_torch.parallel.halo import SlabVolume

MAXDISP = 192
FILTER_MULTIPLIER = 4
BLOCK_MULTIPLIER = 3
INITIAL_FM = FILTER_MULTIPLIER * BLOCK_MULTIPLIER  # 12
HALF_FM = INITIAL_FM // 2                          # 6

SITE_NAMES = (
    "stem_2d0", "stem_2d1", "stem_2d2",
    "cell_2d0", "cell_2d1", "cell_2d2", "cell_2d3",
    "last_3_2d",
    "stem_3d0", "stem_3d1",
    "cell_3d0", "cell_3d1", "cell_3d2", "cell_3d3",
    "cell_3d4", "cell_3d5", "cell_3d6", "cell_3d7",
)

HEAD_NAMES = ("last_3_3d", "last_6_3d", "last_12_3d")

# (c_pp, c_p, c_out, downup) per cell site
_CELL2D_PLAN = (
    (12, 12, 8, -1),
    (12, 24, 4, +1),
    (24, 12, 8, -1),
    (12, 24, 4, +1),
)
_CELL3D_PLAN = (
    (12, 12, 4, 0),
    (12, 12, 4, 0),
    (12, 12, 4, 0),
    (12, 12, 8, -1),
    (12, 24, 16, -1),
    (24, 48, 8, +1),
    (48, 24, 16, -1),
    (24, 48, 16, 0),
)

Spec = Union[ConvBRSpec, CellSpec]


def build_site_specs(genotype) -> Dict[str, Spec]:
    """Specs for one candidate unit per searchable site, from a genotype."""
    specs: Dict[str, Spec] = {
        "stem_2d0": ConvBRSpec(2, 3, HALF_FM, 3, 1),
        "stem_2d1": ConvBRSpec(2, HALF_FM, INITIAL_FM, 3, 3),
        "stem_2d2": ConvBRSpec(2, INITIAL_FM, INITIAL_FM, 3, 1),
        "last_3_2d": ConvBRSpec(2, INITIAL_FM, INITIAL_FM, 1, 1, bn=False, relu=False),
        "stem_3d0": ConvBRSpec(3, INITIAL_FM * 2, INITIAL_FM, 3, 1),
        "stem_3d1": ConvBRSpec(3, INITIAL_FM, INITIAL_FM, 3, 1),
    }
    for i, (cpp, cp, cout, downup) in enumerate(_CELL2D_PLAN):
        specs[f"cell_2d{i}"] = CellSpec(2, cpp, cp, cout, downup, genotype.normal)
    for i, (cpp, cp, cout, downup) in enumerate(_CELL3D_PLAN):
        specs[f"cell_3d{i}"] = CellSpec(3, cpp, cp, cout, downup, genotype.reduce)
    return specs


def build_head_specs() -> Dict[str, ConvBRSpec]:
    """Per-task matching-output heads."""
    return {
        "last_3_3d": ConvBRSpec(3, INITIAL_FM, 1, 3, 1, bn=False, relu=False),
        "last_6_3d": ConvBRSpec(3, INITIAL_FM * 2, INITIAL_FM, 1, 1),
        "last_12_3d": ConvBRSpec(3, INITIAL_FM * 4, INITIAL_FM * 2, 1, 1),
    }


def _init_one(generator: torch.Generator, spec: Spec, device):
    if isinstance(spec, CellSpec):
        return init_cell(generator, spec, device)
    return init_convbr(generator, spec, device)


def init_sites(generator: torch.Generator, specs: Mapping[str, Spec],
               device="cuda") -> Tuple[Dict, Dict]:
    """Fresh (params, stats) for every site in ``specs``, drawn from
    ``generator`` in sorted site order."""
    params, stats = {}, {}
    for name in sorted(specs):
        params[name], stats[name] = _init_one(generator, specs[name], device)
    return params, stats


def _apply2d(specs, params, stats, name, x, train_sites, new_stats, *extra,
             halves=1):
    spec = specs[name]
    train = name in train_sites
    if isinstance(spec, CellSpec):
        out, st = apply_cell(spec, params[name], stats[name], extra[0], x,
                             train, halves)
    else:
        out, st = apply_convbr(spec, params[name], stats[name], x, train,
                               halves)
    new_stats[name] = st
    return out


def extract_feature(specs, params, stats, image: torch.Tensor, train_sites,
                    new_stats, halves: int = 1,
                    precision: Precision = FP32) -> torch.Tensor:
    """2D feature net: image (B,H,W,3) -> features (B,H/3,W/3,12). New
    BatchNorm statistics land in ``new_stats`` (a dict, filled per site).

    halves=2: image is left+right stacked along the batch; train-mode
    BatchNorm takes per-half statistics and two EMA updates. The net runs
    in ``precision``'s compute dtype (BatchNorm statistics in float32)."""
    image = precision.cast_in(image)

    def appl(name, x, *extra):
        return _apply2d(specs, params, stats, name, x, train_sites, new_stats,
                        *extra, halves=halves)

    s = appl("stem_2d0", image)
    stem1 = appl("stem_2d1", s)
    stem2 = appl("stem_2d2", stem1)
    s_pp, s_p = stem1, stem2
    for i in range(4):
        out = appl(f"cell_2d{i}", s_p, s_pp)
        s_pp, s_p = s_p, out
    return appl("last_3_2d", s_p)


def _std_stem(spec) -> bool:
    return (not isinstance(spec, CellSpec) and spec.kernel == 3
            and spec.stride == 1 and spec.bn and spec.relu)


def volume_ops(mesh):
    """The matching net's cross-row ops (``ops.volume``) for a mesh: this
    rank's H slabs where its model axis is > 1, else whole volumes."""
    return SlabVolume(mesh) if mesh is not None and mesh.spatial else WHOLE


def disparity_rows(height: int, mesh) -> Tuple[int, int]:
    """Rows [3 h0, 3 h1) of an H x W disparity that this rank computes,
    for its rows [h0, h1) of the h = ceil(height / 3) feature rows (all
    of them without a model axis)."""
    h0, h1 = volume_ops(mesh).rows((height + 2) // 3)
    return 3 * h0, min(3 * h1, height)


def run_matching_cf(specs, params, stats, x: torch.Tensor, y: torch.Tensor,
                    num_disp: int, train_sites, new_stats,
                    variants: KernelVariants = DEFAULT,
                    vol=WHOLE) -> torch.Tensor:
    """Channel-first matching: NHWC features x, y (B,h,w,C) -> matching
    cost (B, num_disp, h, w), or its rows that ``vol`` holds (x and y
    whole; ``ops.volume``). New BatchNorm statistics land in
    ``new_stats``; ``variants`` picks the optional kernels."""
    h = x.shape[1]
    h0, h1 = vol.rows(h)

    def appl(name, v, *extra, heights=None):
        spec = specs[name]
        train = name in train_sites
        if isinstance(spec, CellSpec):
            out, st = apply_cell_cf(spec, params[name], stats[name], extra[0],
                                    v, train, variants, vol, heights)
        else:
            out, st = apply_convbr_cf(spec, params[name], stats[name], v,
                                      train, variants, vol)
        new_stats[name] = st
        return out

    spec0 = specs["stem_3d0"]
    if _std_stem(spec0):
        # the 3x3x3 conv's rows [h0, h1) read the volume's, and so the
        # features', rows [h0 - 1, h1 + 1)
        lo, hi = max(h0 - 1, 0), min(h1 + 1, h)
        x_cf = x[:, lo:hi].permute(0, 3, 1, 2).contiguous()
        y_cf = y[:, lo:hi].permute(0, 3, 1, 2).contiguous()

        def crop(v):
            return v[..., h0 - lo:h1 - lo, :]

        p0, st0 = params["stem_3d0"], stats["stem_3d0"]
        train0 = "stem_3d0" in train_sites
        if variants.shear_stem and (train0 or needs_grad(
                x_cf, y_cf, p0["w"], p0["scale"], p0["bias"])):
            # rag_tpu/models/stereo.py's shear branch: tap maps + kernel J
            # at identity affine (K behind it), then BatchNorm, train-mode
            # or frozen
            z = crop(shear_stem_z(x_cf, y_cf, p0["w"], num_disp))
            stem0, new_stats["stem_3d0"] = batch_norm_cf(z, p0, st0, train0)
            stem0 = torch.relu(stem0)
        elif variants.shear_stem:
            # serving: frozen BN and ReLU folded into kernel J's epilogue
            a, b = bn_fold(p0, st0)
            stem0 = crop(shear_stem_brc(x_cf, y_cf, p0["w"], a, b, num_disp,
                                        True))
            new_stats["stem_3d0"] = st0
        elif train0:
            # kernel B at identity affine, then train-mode BatchNorm
            z = crop(cvstem_conv(x_cf, y_cf, p0["w"], num_disp))
            stem0, new_stats["stem_3d0"] = batch_norm_cf(z, p0, st0, True)
            stem0 = torch.relu(stem0)
        else:
            # cost volume + stem conv + folded frozen BN + ReLU in one kernel
            a, b = bn_fold(p0, st0)
            stem0 = crop(cvstem_brc(x_cf, y_cf, p0["w"], a, b, num_disp,
                                    True))
            new_stats["stem_3d0"] = st0
    else:
        stem0 = appl("stem_3d0", cost_volume_cf(x[:, h0:h1], y[:, h0:h1],
                                                num_disp))
    stem1 = appl("stem_3d1", stem0)
    s_pp, s_p = stem0, stem1
    h_pp = h_p = h
    for i in range(8):
        name = f"cell_3d{i}"
        out = appl(name, s_p, s_pp, heights=(h_pp, h_p))
        s_pp, s_p = s_p, out
        h_pp, h_p = h_p, cell_out_height(specs[name], h_p)

    d, w = stem0.shape[1], stem0.shape[4]
    v = appl("last_12_3d", s_p)
    v = vol.resize(v, h_p, d // 2, h // 2, w // 2, variants)
    v = appl("last_6_3d", v)
    v = vol.resize(v, h // 2, d, h, w, variants)
    mat = appl("last_3_3d", v)          # (B, D, 1, h, w)
    return mat[:, :, 0]


@contextlib.contextmanager
def full_fp32():
    """Keep cuDNN convs and matmuls in full fp32 (no TF32) for the scope:
    the port's numerics are the reference's fp32."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def stereo_forward(specs: Mapping[str, Spec], params, stats,
                   left: torch.Tensor, right: torch.Tensor,
                   train_sites=frozenset(), maxdisp: int = MAXDISP,
                   variants: KernelVariants = DEFAULT, mesh=None,
                   precision: Precision = FP32):
    """Full pipeline. left/right: (B,H,W,3) NHWC float32 on one device.
    Returns (disp, new_stats): disparity (B,H,W) in pixels, and the stats
    tree after the train-mode BatchNorms of ``train_sites`` (every other
    site's stats carried through). ``variants`` picks the optional kernels
    of the matching net (all off: kernels A-G). With a ``mesh`` whose
    model axis is > 1 the disparity is this rank's rows [3 h0, 3 h1) of
    it (see the module docstring); the caller reduces the feature net's
    batch statistics over the data axis (``parallel.axis.bn_collective``),
    and the matching net's reduce over the world here. ``precision``: the
    feature net and the matching half store their activations in its
    dtypes (rag_tpu/models/stereo.py's casts); the head runs in float32
    and the disparity is float32."""
    variants.check(precision)
    new_stats: Dict = {}
    vol = volume_ops(mesh)
    with full_fp32():
        both = torch.cat([left, right], dim=0)
        f = extract_feature(specs, params, stats, both, train_sites,
                            new_stats, halves=2, precision=precision)
        bsz = left.shape[0]
        # the matching half's boundary: its volume-sized activations in the
        # compute dtype
        x, y = precision.cast_in(f[:bsz]), precision.cast_in(f[bsz:])
        with (bn_collective(mesh.group) if vol is not WHOLE
              else contextlib.nullcontext()):
            mat = run_matching_cf(specs, params, stats, x, y, maxdisp // 3,
                                  train_sites, new_stats, variants, vol)
        disp = vol.soft_argmin(wide(mat), maxdisp, 3)
    for name in stats:
        new_stats.setdefault(name, stats[name])
    return disp, new_stats
