"""Reproducible training: the train steps' scope, on the CPU.

Every train step of the port runs its forward and its backward inside
``models.stereo.reproducible()``: full float32 (both TF32 switches off)
and cuDNN held to its deterministic algorithms with its autotuner off.
ATen reads those switches when each op runs, the backward's included, so
the scope has to cover both. Serving does not enter it.

Here, on CPU tensors (the switches are process-wide flags that the CPU
ops do not read, so what is checked is who sets them and when):
  - the scope sets the four switches and restores them, also when its
    block raises;
  - each train-step builder enters the scope in its forward and in its
    backward (a probe ``autograd.Function`` on the first conv records the
    switches in both), and leaves the caller's switches as they were;
  - ``RoutedInference.predict`` and an eval step run with the caller's
    cuDNN switches;
  - two steps of each builder from one state give equal bits in every
    parameter, optimizer-state leaf and BatchNorm statistic, at a few
    layers and narrow widths.
On the card, ``chip_smoke.py``'s repro phase takes each step three
times twice at the train crop and compares the bits.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cpu_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_fp32_backward import BUILDERS, _ops, _stereo
from rag_tpu_torch.continual.inference import RoutedInference
from rag_tpu_torch.models.router import SceneRouter, make_router_train_step
from rag_tpu_torch.models.stereo import reproducible
from rag_tpu_torch.models.supernet import init_supernet
from rag_tpu_torch.ops.precision import Precision
from rag_tpu_torch.ops.variants import KernelVariants
from rag_tpu_torch.search.mdenas import make_supernet_eval_step
from rag_tpu_torch.train.trainer import (
    make_eval_step,
    make_optimizer,
    make_train_step,
)

# (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
#  cuda.matmul.allow_tf32) inside the scope, and as a caller may leave them
IN_SCOPE = (True, False, False, False)
CALLER = (False, True, True, True)
MAXDISP = 24
THREADS = 4


def _switches():
    return (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _set(flags):
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


@pytest.fixture
def caller_switches():
    """The caller's switches set to CALLER for the test, restored after."""
    saved = _switches()
    _set(CALLER)
    yield
    _set(saved)


class _Probe(torch.autograd.Function):
    """The identity, recording the switches in its forward and backward."""
    seen = {"forward": [], "backward": []}

    @staticmethod
    def forward(ctx, y):
        _Probe.seen["forward"].append(_switches())
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        _Probe.seen["backward"].append(_switches())
        return g


@pytest.fixture
def probe(monkeypatch):
    """The first F.conv2d output that needs a gradient, or the first at all
    where none is taken (any 2D conv: the feature nets', the depth net's,
    the router's), passes through _Probe; yields its records."""
    conv = F.conv2d
    first = []

    def probed(*args, **kw):
        y = conv(*args, **kw)
        if not first and (y.requires_grad or not torch.is_grad_enabled()):
            first.append(y.shape)
            y = _Probe.apply(y)
        return y

    monkeypatch.setattr(F, "conv2d", probed)
    for v in _Probe.seen.values():
        v.clear()
    yield _Probe.seen


def _train_variants(opt, variants=KernelVariants(), precision=Precision()):
    net, specs, params, stats, batch = _stereo()
    step = make_train_step(specs, net.trainable_sites(0), opt, maxdisp=MAXDISP,
                           variants=variants, precision=precision)
    return step(params, stats, opt.init(params), 1e-3, *batch)


def _router(opt):
    """The router's Adam step (``opt`` unused: Adam is the router's own)."""
    router = SceneRouter(3, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.uniform(0, 1, (3, 24, 48, 3))
                              .astype(np.float32))
    return make_router_train_step(router.optimizer)(
        router.params, router.opt_state, images, torch.arange(3))


STEPS = {**BUILDERS,
         "make_train_step variants": lambda opt: _train_variants(
             opt, KernelVariants(True, True, True)),
         "make_train_step bf16": lambda opt: _train_variants(
             opt, precision=Precision(torch.bfloat16)),
         "make_train_step variants bf16": lambda opt: _train_variants(
             opt, KernelVariants(True, True, True), Precision(torch.bfloat16)),
         "router_train_step": _router}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


@pytest.mark.parametrize("raises", [False, True])
def test_scope_sets_and_restores_switches(caller_switches, raises):
    seen = []
    with pytest.raises(RuntimeError) if raises else contextlib.nullcontext():
        with reproducible():
            seen.append(_switches())
            with reproducible():            # nested: still the scope's
                seen.append(_switches())
            seen.append(_switches())
            if raises:
                raise RuntimeError("inside the scope")
    assert seen == [IN_SCOPE] * 3
    assert _switches() == CALLER


@pytest.mark.parametrize("builder", list(STEPS))
def test_builder_enters_scope_forward_and_backward(builder, caller_switches,
                                                   probe):
    STEPS[builder](make_optimizer(3e-3))
    assert probe["forward"] == [IN_SCOPE], probe
    assert probe["backward"] == [IN_SCOPE], probe
    assert _switches() == CALLER


def _predict():
    net = _stereo()[0]
    rng = np.random.default_rng(2)
    left, right = (rng.standard_normal((1, 24, 48, 3)).astype(np.float32)
                   for _ in range(2))
    RoutedInference(net, maxdisp=MAXDISP, device="cpu").predict(
        left, right, task=0)


def _eval_step():
    net, specs, params, stats, batch = _stereo()
    make_eval_step(specs, maxdisp=MAXDISP)(params, stats, *batch)


def _supernet_eval_step():
    params, stats = init_supernet(torch.Generator().manual_seed(0), "cpu")
    make_supernet_eval_step(MAXDISP)(params, stats, *_stereo()[4], *_ops())


@pytest.mark.parametrize("serve", [_predict, _eval_step, _supernet_eval_step],
                         ids=["predict", "eval_step", "supernet_eval_step"])
def test_serving_keeps_callers_cudnn_switches(serve, caller_switches, probe):
    serve()
    # full_fp32 turns TF32 off for the forward; cuDNN's two switches stay
    # the caller's
    assert probe["forward"] == [(False, True, False, False)], probe
    assert _switches() == CALLER


@pytest.mark.parametrize("builder", list(STEPS))
def test_two_steps_from_one_state_are_bit_equal(builder):
    # several intra-op threads: an op that adds in the order its threads
    # reach the values (an accumulating index_put_) shows here
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        a, b = (dict(_leaves(STEPS[builder](make_optimizer(3e-3))))
                for _ in range(2))
    finally:
        torch.set_num_threads(n)
    assert sorted(a) == sorted(b) and a
    for k in a:
        assert torch.equal(a[k], b[k]), k
