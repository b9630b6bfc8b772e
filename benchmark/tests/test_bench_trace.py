"""Reading a device trace: busy time as the union of device intervals,
classes from kernels.json, idle gaps by the innermost host op running at
each gap's middle."""

import pytest

from harness.trace import Trace, classify, load_classes


def _ev(cat, name, ts, dur, tid=1):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def test_busy_union_classes_and_gaps():
    events = [
        _ev("cpu_op", "aten::add", 0, 100),
        _ev("cpu_op", "aten::mul", 10, 5),
        _ev("cpu_op", "aten::cat", 130, 120),
        _ev("kernel", "void conv3d_tf32x3_kernel<4>(float*)", 20, 30),
        _ev("kernel", "elementwise_kernel", 40, 30),       # overlaps
        _ev("gpu_memcpy", "Memcpy HtoD", 90, 10),
        _ev("kernel", "void conv3d_dw_kernel<CostVolumeSrc>()", 200, 50),
        _ev("cpu_op", "aten::bmm", 120, 10, tid=2),
        _ev("cpu_op", "MulBackward0", 140, 20, tid=2),
    ]
    tr = Trace(events, window_s=1.0, items=2)
    assert tr.ops == 4
    assert tr.busy_s == pytest.approx((50 + 10 + 50) / 1e6)
    assert tr.class_s() == pytest.approx({"A": 30e-6, "elementwise": 30e-6,
                                          "copies": 10e-6, "F": 50e-6})
    # gaps: 70-90 (mid 80: aten::add), 100-200 (mid 150: the backward
    # thread's MulBackward0 started after aten::cat)
    assert tr.idle_gaps() == pytest.approx({"aten::add": 20e-6,
                                            "MulBackward0": 100e-6})


def test_gap_without_host_op():
    events = [_ev("kernel", "gemm", 0, 10), _ev("kernel", "gemm", 50, 10),
              _ev("cpu_op", "aten::mm", 0, 5)]
    assert Trace(events, 1.0, 1).idle_gaps() == {"no_host_op": pytest.approx(40e-6)}


@pytest.mark.parametrize("name,cls", [
    ("void conv3d_pack_kernel(float const*)", "A"),
    ("void conv3d_tf32x3_kernel<CostVolumeSrc, 4>()", "B"),
    ("void conv3d_dw_sum_kernel()", "D"),
    ("void cvstem_dxy_kernel<4>()", "E"),
    ("void soft_argmin_kernel<64>()", "C"),
    ("void soft_argmin_fold_kernel<64>()", "G"),
    ("void soft_argmin_gather_kernel()", "G"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize", "gemm"),
    ("void at::native::reduce_kernel<512, 1>()", "reductions"),
    ("void at::native::vectorized_elementwise_kernel<4>()", "elementwise"),
    ("cudnn::fusion::kernel", "cudnn"),
    ("void something_else()", "other"),
])
def test_classes(name, cls):
    assert classify(name, "kernel", load_classes()) == cls
