"""Every train step of the port takes its backward in full float32.

ATen reads torch.backends.cudnn.allow_tf32 (and the cuBLAS switch) when a
conv's backward runs, so a step whose gradients were taken after the
forward's float32 scope had closed would run its backward convs in TF32
on a Hopper card wherever the caller left the switches on (their
default). Here both switches are set True before each step builder's
step, a probe on the feature net's first conv records both while its
backward runs, and both must read False there and True again after the
step.
"""

import numpy as np
import pytest
import torch

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from rag_tpu_torch.models.growable import GrowableDepthNet, GrowableStereoNet
from rag_tpu_torch.models.supernet import (
    NUM_EDGES,
    init_depth_supernet,
    init_supernet,
)
from rag_tpu_torch.ops import convbr
from rag_tpu_torch.ops.variants import DEFAULT
from rag_tpu_torch.search import growth
from rag_tpu_torch.search.genotype import default_genotype
from rag_tpu_torch.search.mdenas import (
    make_depth_supernet_train_step,
    make_supernet_train_step,
)
from rag_tpu_torch.train.trainer import (
    make_depth_train_step,
    make_optimizer,
    make_selfsup_train_step,
    make_train_step,
)

B, H, W, MAXDISP = 2, 24, 48, 24


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


class _Probe(torch.autograd.Function):
    seen = []

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        _Probe.seen.append(_flags())
        return g


def _stereo():
    net = GrowableStereoNet.initial(default_genotype(), 0, "cpu")
    specs, params, stats = net.path(net.archis[0])
    rng = np.random.default_rng(0)
    left, right = (torch.from_numpy(rng.standard_normal((B, H, W, 3))
                                    .astype(np.float32)) for _ in range(2))
    return net, specs, params, stats, (left, right, torch.full((B, H, W), 5.))


def _depth():
    net = GrowableDepthNet.initial(default_genotype(), 0, "cpu")
    specs, params, stats = net.path(net.archis[0])
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.uniform(0, 1, (B, H, W, 3))
                             .astype(np.float32))
    return net, specs, params, stats, (image, torch.full((B, H, W), 4.))


def _ops():
    return [np.zeros(NUM_EDGES, np.int32)] * 2


def run_train(opt):
    net, specs, params, stats, batch = _stereo()
    step = make_train_step(specs, net.trainable_sites(0), opt, maxdisp=MAXDISP)
    return step(params, stats, opt.init(params), 1e-3, *batch)


def run_selfsup(opt):
    net, specs, params, stats, batch = _stereo()
    step = make_selfsup_train_step(specs, net.trainable_sites(0), opt,
                                   maxdisp=MAXDISP)
    return step(params, stats, opt.init(params), 1e-3, *batch)


def run_depth(opt):
    net, specs, params, stats, batch = _depth()
    step = make_depth_train_step(specs, net.trainable_sites(0), opt)
    return step(params, stats, opt.init(params), 1e-3, *batch)


def run_supernet(opt):
    params, stats = init_supernet(torch.Generator().manual_seed(0), "cpu")
    step = make_supernet_train_step(opt, MAXDISP)
    return step(params, stats, opt.init(params), 1e-3, *_stereo()[4],
                *_ops())


def run_depth_supernet(opt):
    params, stats = init_depth_supernet(torch.Generator().manual_seed(0),
                                        "cpu")
    step = make_depth_supernet_train_step(opt)
    return step(params, stats, opt.init(params), 1e-3, *_depth()[4],
                *_ops())


def _op_search(variant, setup, opt):
    """One step of the op search's train step: every BatchNorm frozen, the
    stems and heads trainable."""
    _, specs, params, stats, batch = setup()
    trainable = frozenset(s for s in specs if "stem" in s or "last" in s)
    step, _ = growth.VARIANTS[variant][0](specs, trainable, opt, MAXDISP,
                                          DEFAULT, None)
    return step(params, stats, opt.init(params), 1e-3, *batch)


def run_op_search(opt):
    return _op_search("stereo", _stereo, opt)


def run_depth_op_search(opt):
    return _op_search("depth", _depth, opt)


BUILDERS = {"make_train_step": run_train,
            "make_selfsup_train_step": run_selfsup,
            "make_depth_train_step": run_depth,
            "supernet_train_step": run_supernet,
            "depth_supernet_train_step": run_depth_supernet,
            "op_search_step": run_op_search,
            "depth_op_search_step": run_depth_op_search}


@pytest.mark.parametrize("builder", list(BUILDERS))
def test_backward_runs_in_float32(builder, monkeypatch):
    conv = convbr.conv2d_nhwc
    first = []

    def probed(x, w, spec):
        y = conv(x, w, spec)
        if not first and y.requires_grad:
            first.append(spec)
            y = _Probe.apply(y)
        return y

    monkeypatch.setattr(convbr, "conv2d_nhwc", probed)
    saved = _flags()
    _Probe.seen.clear()
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        BUILDERS[builder](make_optimizer(3e-3))
        after = _flags()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    assert first, "the probe never reached a conv whose output needs grad"
    assert _Probe.seen == [(False, False)], _Probe.seen
    assert after == (True, True)
