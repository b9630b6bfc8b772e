#!/usr/bin/env python3
"""Time kernels J and K (rag_tpu_torch/csrc/shear.cu) at several blockings
on one GPU, beside the card's own store stream.

    python3 scripts/torch_shear_sweep.py [--reps N] [--out FILE]

Builds one library per variant (VARIANTS: shear.cu's plain constants
kFwdPlanes, kFwdMinBlocks, kFwdTileCols, kFwdTilePlanes, kAdjSlabFloats
and kAdjMaxThreads, each set in a copy of the source written to
build/shear-sweep/; the first variant is the source as it stands), one
nvcc process each, all started together. Each library's C entries are
timed with CUDA events at the main path's shapes on random inputs,
outputs made once: J at the eval geometry (1, 9, 12, 160, 320), D 64,
with the ReLU (one call a request), and at the train shape (4, 9, 12, 64,
128), D 64 (one a step); K at the train shape (4, 64, 12, 64, 128). Each
result is held against the plain version (J within CONV_RTOL of max(1,
|plain|), K within BWD_RTOL of the plain version on |dz|, as
chip_smoke.py holds them); the run fails at its end if any disagrees. One
JSON line per variant, with the card's name and power limit, then one of
what PyTorch takes to write each of J's outputs alone: a fill_ of one
value, a broadcast add that writes varied values (P[j] + d, one plane of
P read), and a copy_ of random floats (as many bytes read as written).
Needs nvcc and a CUDA build of torch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from rag_tpu_torch.ops import cuda_lib  # noqa: E402
from rag_tpu_torch.ops import shear as shear_mod  # noqa: E402

# shear.cu's constants, each set beside the source's values: J's planes a
# task; J without its register cap (one block resident an SM); J's pieces
# narrower than the eval row (3 column tiles) and shorter than D (4 plane
# chunks); K's dz in two runs; K's rows split over column and diagonal
# blocks at the train shape
VARIANTS = [{}, {"kFwdPlanes": 4}, {"kFwdPlanes": 16}, {"kFwdPlanes": 32},
            {"kFwdMinBlocks": 1}, {"kFwdTileCols": 128},
            {"kFwdTilePlanes": 16}, {"kAdjSlabFloats": 4096},
            {"kAdjMaxThreads": 128}]
CONV_RTOL, BWD_RTOL = 1e-5, 1e-4
J_SHAPES = {"j_request": ((1, 9, 12, 160, 320), 64, True),
            "j_step": ((4, 9, 12, 64, 128), 64, False)}
K_SHAPE = (4, 64, 12, 64, 128)


def patched_source(consts: dict) -> str:
    """shear.cu with the given constants set."""
    src = (cuda_lib.CSRC / "shear.cu").read_text()
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise SystemExit(f"torch_shear_sweep: {name} not found once")
    return src


def build(variants):
    """Compile one library per variant; return them loaded."""
    out_dir = cuda_lib.BUILD_ROOT / "shear-sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, consts in enumerate(variants):
        cu, lib = out_dir / f"shear-{i}.cu", out_dir / f"libshear-{i}.so"
        cu.write_text(patched_source(consts))
        cmd = [cuda_lib._nvcc(), *cuda_lib.ARCH_FLAGS, *cuda_lib.CFLAGS,
               "-shared", "-I", str(cuda_lib.CSRC), "-Xptxas", "-v",
               str(cu), "-o", str(lib)]
        procs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    libs = []
    for i, (lib, proc) in enumerate(procs):
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {lib.name}:\n{text}")
        print(f"== {lib.name} {variants[i]}: " + "; ".join(
            ln.split(":", 1)[-1].strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln), flush=True)
        handle = ctypes.CDLL(str(lib))
        for name in ("rag_shear_fwd", "rag_shear_adj"):
            fn = getattr(handle, name)
            fn.argtypes = cuda_lib.SIGNATURES[name]
            fn.restype = ctypes.c_int
        libs.append(handle)
    return libs


def cuda_ms(fn, reps: int) -> float:
    for _ in range(2):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", type=Path, default=None,
                    help="also append the JSON lines to this file")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_shear_sweep: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build(VARIANTS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = cuda_lib.stream_ptr(torch.empty(0, device=dev))

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    jin = {}
    for key, (shape, nd, relu) in J_SHAPES.items():
        b, _, co, h, w = shape
        px, py = rand(*shape), rand(*shape)
        scale, bias = rand(co) * 0.3 + 1.0, rand(co) * 0.1
        ref = shear_mod.shear_forward_plain(px, py, scale, bias, nd, relu)
        out = torch.empty_like(ref)
        jin[key] = (px, py, scale, bias, nd, relu, out, ref,
                    CONV_RTOL * max(1.0, float(ref.abs().max())))
    dz = rand(*K_SHAPE)
    kref = shear_mod.shear_adjoint_plain(dz, K_SHAPE[1])
    ktol = BWD_RTOL * max(float(m.abs().max()) for m in
                          shear_mod.shear_adjoint_plain(dz.abs(), K_SHAPE[1]))
    dpx, dpy = torch.empty_like(kref[0]), torch.empty_like(kref[1])
    failures, lines = [], []
    for consts, lib in zip(VARIANTS, libs):
        line = {"constants": consts}
        for key, (px, py, scale, bias, nd, relu, out, ref, tol) in jin.items():
            b, _, co, h, w = px.shape

            def run_j():
                cuda_lib.check(lib.rag_shear_fwd(
                    px.data_ptr(), py.data_ptr(), scale.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), b, nd, co, h, w,
                    int(relu), stream), "rag_shear_fwd")

            run_j()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if not err <= tol:
                failures.append(f"{consts} {key}: {err:.3g} > {tol:.3g}")
            line[f"{key}_ms"] = cuda_ms(run_j, opts.reps)
            line[f"{key}_err"] = err
        b, nd, co, h, w = K_SHAPE

        def run_k():
            cuda_lib.check(lib.rag_shear_adj(
                dz.data_ptr(), dpx.data_ptr(), dpy.data_ptr(), b, nd, co, h,
                w, stream), "rag_shear_adj")

        run_k()
        torch.cuda.synchronize()
        err = max(float((dpx - kref[0]).abs().max()),
                  float((dpy - kref[1]).abs().max()))
        if not err <= ktol:
            failures.append(f"{consts} k_step: {err:.3g} > {ktol:.3g}")
        line["k_step_ms"] = cuda_ms(run_k, opts.reps)
        line["k_step_err"] = err
        line["device"] = smi
        lines.append(line)
        print(json.dumps(line), flush=True)
    # the card's store stream without J, into each of J's outputs: one
    # value; varied values (P[j] + d from one plane of P); random floats
    # read and written
    stores = {}
    for key, v in jin.items():
        out = v[6]
        nd = out.shape[1]
        p_row = torch.randn(out[:, :1].shape, device=dev, generator=gen)
        d_col = torch.arange(nd, device=dev, dtype=torch.float32).reshape(
            1, nd, 1, 1, 1)
        src = torch.randn(out.shape, device=dev, generator=gen)
        stores[f"{key}_fill_ms"] = cuda_ms(lambda: out.fill_(1.0), opts.reps)
        stores[f"{key}_add_ms"] = cuda_ms(
            lambda: torch.add(p_row, d_col, out=out), opts.reps)
        stores[f"{key}_copy_ms"] = cuda_ms(lambda: out.copy_(src), opts.reps)
        del src
    stores["k_step_fill_ms"] = cuda_ms(
        lambda: (dpx.fill_(1.0), dpy.fill_(1.0)), opts.reps)
    stores["device"] = smi
    print(json.dumps(stores), flush=True)
    if opts.out is not None:
        with opts.out.open("a") as f:
            for line in lines + [stores]:
                f.write(json.dumps(line) + "\n")
    for key in ("j_request_ms", "j_step_ms", "k_step_ms"):
        best = min(lines, key=lambda ln: ln[key])
        print(f"fastest {key}: {best[key]:.4f} at {best['constants']}; {smi}")
    if failures:
        raise SystemExit("torch_shear_sweep: disagreements:\n  "
                         + "\n  ".join(failures))
    return 0


if __name__ == "__main__":
    sys.exit(main())
