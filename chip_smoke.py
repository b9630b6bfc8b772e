#!/usr/bin/env python3
"""Smoke run of the rag_tpu_torch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--profile DIR]

Phases, in order; any failure exits non-zero and no phase swallows an
exception:

  1. device   require CUDA (no CPU fallback), print the card;
  2. build    compile the port's CUDA kernels from rag_tpu_torch/csrc with
              nvcc (one process per source, all at once) and load them;
  3. record   restore the committed 4-task checkpoint logs/canonical_learn_r4
              onto the card and answer one 1x480x960 request per task path
              with each kernel's PLAIN version in its wrapper's place,
              recording every call each kernel would get (its shapes and
              its real activations);
  4. kernels  hold each kernel against its plain version on the card, at
              every recorded main-path shape and at small shapes, and time
              kernel, plain version and a library yardstick with CUDA events;
  5. serve    set every launch count to 0, answer 3 requests per task path
              through RoutedInference.predict, read the counts (each kernel
              must have launched), and check every disparity: finite, in
              [0, 191], and within tolerance of the plain path's;
  6. report   one JSON line of kernels, the card's name and power limit, and
              as the last line {"ok": true, "device": {...}}.

Float32 throughout: TF32 is off for cuDNN and matmuls.
"""

from __future__ import annotations

import argparse
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
from rag_tpu_torch.continual.state import load_checkpoint  # noqa: E402
from rag_tpu_torch.metrics.stereo import stereo_metrics  # noqa: E402
from rag_tpu_torch.models import stereo as stereo_mod  # noqa: E402
from rag_tpu_torch.ops import convbr_cf as convbr_cf_mod  # noqa: E402
from rag_tpu_torch.ops import cuda_lib  # noqa: E402
from rag_tpu_torch.ops.conv3d import conv3d_brc_cf, conv3d_brc_cf_plain  # noqa: E402
from rag_tpu_torch.ops.cost_volume import cost_volume_cf  # noqa: E402
from rag_tpu_torch.ops.cvstem import cvstem_brc, cvstem_brc_plain  # noqa: E402
from rag_tpu_torch.ops.disparity import (  # noqa: E402
    fused_soft_argmin,
    soft_argmin_disparity,
)

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "logs" / "canonical_learn_r4"
H, W, MAXDISP = 480, 960, 192
TRUE_DISP = 24                 # the synthetic pair is one fronto-parallel plane
REQUESTS = 3                   # per task path; the first is reported apart
REPS = 10                      # timed launches per kernel at main-path shapes

# H100 SXM data-sheet peaks (dense, no sparsity) at the 700 W limit
PEAK_FP32_FLOPS = 67e12        # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12

# Tolerances, with their reasons:
CONV_RTOL = 1e-5   # of max |plain|: float32 sums of <= 27*48 products in
                   # another order; a wrong tap or channel is O(1) off
DISP_ATOL = 1e-3   # px, kernel C alone: float32 softmin over 192 levels
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


# -- bounds: the least time the card could take for one call ---------------

def _taps(n: int) -> int:
    """(output, tap) pairs of a 3-tap zero-padded axis that read inside."""
    return 3 * n - 2 if n > 1 else 1


def _bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def conv_bound(x_shape, cout):
    """Multiply-adds that read an in-range voxel (padding zeros excluded);
    bytes: input, weights, affine read once, output written once."""
    b, d, cin, h, w = x_shape
    flops = 2.0 * b * _taps(d) * _taps(h) * _taps(w) * cin * cout
    nbytes = 4.0 * (b * d * h * w * (cin + cout) + 27 * cin * cout + 2 * cout)
    return _bound(flops, nbytes)


def cvstem_bound(x_shape, nd, cout):
    """Multiply-adds that read a voxel of the cost volume that is not a
    structural zero (outside the planes, left of the diagonal, or padding);
    bytes: the two feature maps, weights, affine in, the output out."""
    b, c, h, w = x_shape
    d = np.arange(nd)[:, None, None, None]
    dd = np.arange(3)[None, :, None, None]
    j = np.arange(w)[None, None, :, None]
    kw = np.arange(3)[None, None, None, :]
    dv, jv = d + dd - 1, j + kw - 1
    inside = int(((dv >= 0) & (dv < nd) & (jv >= dv) & (jv < w)).sum())
    flops = 2.0 * b * inside * _taps(h) * 2 * c * cout
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


# -- the three kernels: wrapper, plain version, yardstick, bound ------------

def _conv_library(x, w, scale, bias, relu):
    """cuDNN F.conv3d on NCDHW with the affine folded into weights and
    bias, then ReLU (the layout change is made once, outside the timing)."""
    x_n = x.permute(0, 2, 1, 3, 4).contiguous()
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


KERNELS = {
    "conv3d_brc_cf": dict(
        wrapper=conv3d_brc_cf, plain=conv3d_brc_cf_plain,
        source="rag_tpu_torch/csrc/conv3d.cu",
        replaces="rag_tpu/ops/pallas_conv3d.py:257",
        sig=lambda x, w, scale, bias, relu: (tuple(x.shape), w.shape[4], relu),
        bound=lambda x, w, scale, bias, relu: conv_bound(x.shape, w.shape[4]),
        library=_conv_library, tol="conv"),
    "cvstem_brc": dict(
        wrapper=cvstem_brc, plain=cvstem_brc_plain,
        source="rag_tpu_torch/csrc/cvstem.cu",
        replaces="rag_tpu/ops/pallas_cvstem.py:257",
        sig=lambda x, y, w3, scale, bias, nd, relu=True:
            (tuple(x.shape), w3.shape[4], nd, relu),
        bound=lambda x, y, w3, scale, bias, nd, relu=True:
            cvstem_bound(x.shape, nd, w3.shape[4]),
        library=_cvstem_library, tol="conv"),
    "fused_soft_argmin": dict(
        wrapper=fused_soft_argmin, plain=soft_argmin_disparity,
        source="rag_tpu_torch/csrc/disp_head.cu",
        replaces="rag_tpu/ops/pallas_kernels.py:163",
        sig=lambda x, maxdisp, scale=3: (tuple(x.shape), maxdisp, scale),
        bound=lambda x, maxdisp, scale=3: disp_bound(x.shape, maxdisp, scale),
        library=None, tol="disp"),
}

# where the main path looks each kernel's wrapper up (module, attribute):
# the record phase puts the plain versions there for one request per task
CALL_SITES = {
    "conv3d_brc_cf": (convbr_cf_mod, "conv3d_brc_cf"),
    "cvstem_brc": (stereo_mod, "cvstem_brc"),
    "fused_soft_argmin": (stereo_mod, "fused_soft_argmin"),
}


def small_cases(dev, rng):
    """A few small shapes per kernel: Cout 1 with W not a multiple of 8,
    merged Cout 48, a D == W cost volume, batch 2 for every kernel."""
    def t(*shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s)
                                .astype(np.float32)).to(dev)

    def aff(c):
        return t(c, s=0.3) + 1.0, t(c, s=0.1)

    cases = []
    for b, d, cin, h, w, cout, relu in [(1, 4, 12, 16, 24, 12, True),
                                        (1, 3, 12, 8, 13, 1, False),
                                        (2, 3, 16, 9, 70, 48, True)]:
        cases.append(("conv3d_brc_cf", (t(b, d, cin, h, w),
                                        t(3, 3, 3, cin, cout, s=0.2),
                                        *aff(cout), relu)))
    for b, c, h, w, nd, cout in [(1, 12, 8, 20, 6, 12), (1, 2, 8, 8, 8, 3),
                                 (2, 3, 6, 11, 5, 4)]:
        cases.append(("cvstem_brc", (t(b, c, h, w), t(b, c, h, w),
                                     t(3, 3, 3, 2 * c, cout, s=0.2),
                                     *aff(cout), nd, True)))
    for b, d, h, w, md in [(1, 8, 16, 10, 24), (2, 4, 5, 43, 12)]:
        cases.append(("fused_soft_argmin", (t(b, d, h, w, s=3.0), md, 3)))
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


def phase_record(ri, requests):
    """The first request of each task path through RoutedInference.predict
    with each kernel's plain version in its wrapper's place. Returns the
    plain disparities, every kernel call per task (name, signature), and
    the first real arguments seen for each signature."""
    calls = {t: [] for t in requests}
    args_of = {}
    wrappers = {n: getattr(m, a) for n, (m, a) in CALL_SITES.items()}
    launches0 = {n: k["wrapper"].launches for n, k in KERNELS.items()}

    def recorder(name, task):
        def run(*args, **kw):
            sig = KERNELS[name]["sig"](*args, **kw)
            calls[task].append((name, sig))
            if (name, sig) not in args_of:
                args_of[(name, sig)] = (
                    tuple(a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args), dict(kw))
            return KERNELS[name]["plain"](*args, **kw)
        return run

    plain = {}
    try:
        for t, reqs in requests.items():
            for n, (m, a) in CALL_SITES.items():
                setattr(m, a, recorder(n, t))
            plain[t] = ri.predict(*reqs[0], task=t)
    finally:
        for n, (m, a) in CALL_SITES.items():
            setattr(m, a, wrappers[n])
    for t in requests:
        n_calls = {k: sum(1 for n, _ in calls[t] if n == k) for k in KERNELS}
        log(f"[record] task {t}: plain disparity in [{plain[t].min():.2f}, "
            f"{plain[t].max():.2f}], kernel calls {n_calls}")
        # a call site the main path no longer reads would leave the kernel
        # unchecked and the "plain" reference running kernels
        if min(n_calls.values()) < 1:
            raise SystemExit(f"chip_smoke: task {t} made no call to "
                             f"{[k for k, c in n_calls.items() if c < 1]}")
    launched = {n: k["wrapper"].launches - launches0[n]
                for n, k in KERNELS.items()}
    if any(launched.values()):
        raise SystemExit(f"chip_smoke: the plain path launched {launched}")
    log(f"[record] {len(args_of)} distinct kernel signatures on the main path")
    return plain, calls, args_of


def check_kernel(name, args, kw, reps):
    """Kernel vs plain on one set of arguments; times of kernel, plain and
    library. Returns a result dict (no assertion here)."""
    k = KERNELS[name]
    with torch.inference_mode():
        out = k["wrapper"](*args, **kw)
        ref = k["plain"](*args, **kw)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        tol = CONV_RTOL * scale if k["tol"] == "conv" else DISP_ATOL
        ms = cuda_ms(lambda: k["wrapper"](*args, **kw), reps)
        plain_ms = cuda_ms(lambda: k["plain"](*args, **kw), max(1, reps // 2))
        lib_ms = (cuda_ms(k["library"](*args, **kw), reps)
                  if k["library"] is not None else None)
    bound_ms, bound_by = k["bound"](*args, **kw)
    return dict(err=err, tol=tol, ok=bool(err <= tol), ms=ms,
                plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bound_ms,
                bound_ops_ms=bound_ms if bound_by == "operations" else 0.0,
                bound_by=bound_by)


def phase_kernels(args_of, dev):
    results, failures = {}, []
    rng = np.random.default_rng(7)
    todo = [("eval", name, sig, args, kw)
            for (name, sig), (args, kw) in args_of.items()]
    todo += [("small", name, KERNELS[name]["sig"](*args), args, {})
             for name, args in small_cases(dev, rng)]
    for where, name, sig, args, kw in todo:
        r = check_kernel(name, args, kw, REPS if where == "eval" else 5)
        if where == "eval":
            results[(name, sig)] = r
        line = {"kernel": name, "at": where, "sig": str(sig),
                "max_abs_err": r["err"], "tol": r["tol"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "library_ms": r["lib_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
        log(f"[kernels] {json.dumps(line)}")
        if not r["ok"]:
            failures.append(f"{name} {where} {sig}: max_abs_err {r['err']:.3g}"
                            f" > {r['tol']:.3g}")
        KERNELS[name].setdefault("max_err", 0.0)
        KERNELS[name]["max_err"] = max(KERNELS[name]["max_err"], r["err"])
    if failures:
        raise SystemExit("chip_smoke: kernels disagree with their plain "
                         "versions:\n  " + "\n  ".join(failures))
    return results


def phase_serve(ri, requests, plain):
    for k in KERNELS.values():
        k["wrapper"].launches = 0
    outs, times = {}, {}
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
    log(f"[serve] launches in the main-path run: {launches}; peak device "
        f"memory {peak_gb:.2f} GB")

    failures = [f"{n} never launched" for n, c in launches.items() if c <= 0]
    per_task = {}
    for t in requests:
        for i, d in enumerate(outs[t]):
            if d.shape != (1, H, W) or not np.isfinite(d).all():
                failures.append(f"task {t} request {i}: shape {d.shape} or "
                                "non-finite values")
            elif d.min() < 0 or d.max() > MAXDISP - 1:
                failures.append(f"task {t} request {i}: disparity outside "
                                f"[0, {MAXDISP - 1}]")
        diff = float(np.abs(outs[t][0] - plain[t]).max())
        if not diff <= SERVE_ATOL:
            failures.append(f"task {t}: kernel path vs plain path "
                            f"{diff:.3g} px > {SERVE_ATOL}")
        gt = torch.full((1, H, W), float(TRUE_DISP))
        gt[..., :TRUE_DISP] = 0.0
        m = stereo_metrics(torch.from_numpy(outs[t][0]), gt,
                           (gt > 0) & (gt < MAXDISP))
        steady = times[t][1:] or times[t]
        per_task[t] = dict(first_ms=times[t][0],
                           ms_per_request=float(np.mean(steady)),
                           vs_plain_max_px=diff,
                           epe_vs_plane=float(m["EPE"]), d1=float(m["D1"]))
        log(f"[serve] task {t}: {json.dumps(per_task[t])}")
    if failures:
        raise SystemExit("chip_smoke: serve failed:\n  " + "\n  ".join(failures))
    return launches, per_task


def phase_profile(ri, requests, out_dir: Path) -> None:
    """torch.profiler over one steady request of the last task path: the
    kernel table goes to out_dir, the device busy share to the log."""
    from torch.profiler import ProfilerActivity, profile

    t = max(requests)
    left, right = requests[t][0]
    ri.predict(left, right, task=t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ri.predict(left, right, task=t)
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
    (out_dir / f"profile_task{t}.txt").write_text(
        events.table(sort_by=key, row_limit=40))
    prof.export_chrome_trace(str(out_dir / f"trace_task{t}.json"))
    log(f"[profile] task {t}: wall {wall_ms:.2f} ms, device busy "
        f"{dev_us / 1e3:.2f} ms ({100 * dev_us / 1e3 / wall_ms:.1f}%)")
    for e in sorted(events, key=lambda e: -getattr(e, key))[:16]:
        log(f"[profile]   {getattr(e, key) / 1e3:9.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


def per_request(results, calls, name, field):
    """Sum of a per-call number over one request, averaged over tasks."""
    sums = []
    for task_calls in calls.values():
        vals = [results[(n, s)][field] for n, s in task_calls if n == name]
        if any(v is None for v in vals):
            return None
        sums.append(sum(vals))
    return float(np.mean(sums))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", type=Path, default=None,
                    help="also profile one request; write tables here")
    opts = ap.parse_args()

    smi = phase_device()
    dev = torch.device("cuda")
    phase_build()

    t0 = time.perf_counter()
    net, _ = load_checkpoint(str(CKPT), 3, device=dev)
    ri = RoutedInference(net, maxdisp=MAXDISP, device=dev)
    log(f"[serve] restored {CKPT.relative_to(ROOT)} task 3 "
        f"({len(net.archis)} task paths) in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    requests = {t: [stereo_pair(rng, H, W, TRUE_DISP)
                    for _ in range(REQUESTS)]
                for t in range(len(net.archis))}

    plain, calls, args_of = phase_record(ri, requests)
    results = phase_kernels(args_of, dev)
    del args_of
    torch.cuda.empty_cache()
    launches, per_task = phase_serve(ri, requests, plain)
    if opts.profile is not None:
        phase_profile(ri, requests, opts.profile)

    report = []
    for name, k in KERNELS.items():
        bound = per_request(results, calls, name, "bound_ms")
        bound_ops = per_request(results, calls, name, "bound_ops_ms")
        report.append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "launches": launches[name],
            "max_abs_err": k["max_err"],
            "ms": per_request(results, calls, name, "ms"),
            "plain_ms": per_request(results, calls, name, "plain_ms"),
            "bound_ms": bound,
            "bound_by": "operations" if bound_ops >= bound / 2 else "bytes",
            "library_ms": per_request(results, calls, name, "lib_ms"),
            "status": "ok"})
    log("[report] per-kernel times are summed over one request's calls and "
        "averaged over the task paths; ms/request: " + ", ".join(
            f"task {t} {v['ms_per_request']:.2f}" for t, v in per_task.items()))
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
