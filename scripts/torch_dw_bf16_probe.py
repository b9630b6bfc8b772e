#!/usr/bin/env python3
"""Where the time of the bf16 instances of kernels D and F goes, on one GPU.

    python3 scripts/torch_dw_bf16_probe.py [--reps N]

Kernel D's engine (rag_tpu_torch/csrc/conv3d_dw.cuh) lands a bf16 plane
in a landing slab and widens it into its float32 slots before the walk.
This script builds the engine's two entries (conv3d_dw.cu: kernel D,
cvstem_bwd.cu: kernel F) once as they are and once per variant with one
part of that staging taken out, each a patched copy under
build/dw-bf16-probe/ (one nvcc process each, all started together), and
times, with CUDA events through the C entries and the buffers allocated
once, at every kernel D call of a task-0 step and at kernel F's:

  * the float32 instance on the upcast inputs, and the bf16 instance as it
    is (held against the float32 one with torch.equal);
  * nopass: without the widening pass in the loop (the walk reads slots
    left from the prologue);
  * noinline: the pass a function call, one copy of its code;
  * nosync: without the __syncthreads after that pass;
  * copies: neither the pass nor that __syncthreads: what the copies and
    the walk cost alone.

A variant's results are wrong by design: only the "as is" bf16 instance is
checked. The first pass alone (the partials) is timed, as kernel D's
``partial_ms`` in chip_smoke.py. One JSON line per shape goes to the
standard output, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rag_tpu_torch.ops import conv3d as conv3d_mod  # noqa: E402
from rag_tpu_torch.ops import cuda_lib  # noqa: E402
from rag_tpu_torch.ops import cvstem as cvstem_mod  # noqa: E402

# (x shape, cout): every kernel D call of a task-0 step (chip_smoke.py's
# record), then kernel F's (b, c, h, w, num_disp, cout)
D_SHAPES = [((4, 64, 4, 64, 128), 4), ((4, 64, 12, 64, 128), 12),
            ((4, 64, 12, 64, 128), 1), ((4, 32, 8, 32, 64), 8),
            ((4, 16, 16, 16, 32), 16)]
F_SHAPE = (4, 12, 64, 128, 64, 12)

ENGINE = "conv3d_dw.cuh"
LOOP_PASS = """      widen_x(d0 + k + 1, l_x);
      widen_dz();
"""
LOOP_SYNC = ("      __syncthreads();  // the slots filled, the landing slab "
             "free\n")
NOINLINE = ("__device__ __forceinline__ void widen_rows(",
            "__device__ __noinline__ void widen_rows(")
PASS_X = ("      widen_x(d0 + k + 1, l_x);\n", "")
PASS_DZ = ("      widen_dz();\n      __syncthreads();",
           "      __syncthreads();")
BATCH1 = ("constexpr int kBatch = 4;", "constexpr int kBatch = 1;")
VARIANTS = {"as_is": (), "nopass": ((LOOP_PASS, ""),),
            "noinline": (NOINLINE,), "nopass_x": (PASS_X,),
            "nopass_dz": (PASS_DZ,), "batch1": (BATCH1,),
            "nosync": ((LOOP_SYNC, ""),),
            "copies": ((LOOP_PASS, ""), (LOOP_SYNC, ""))}
ENTRIES = ("rag_conv3d_dw_cf", "rag_conv3d_dw_cf_bf16", "rag_cvstem_dw",
           "rag_cvstem_dw_bf16")


def build():
    """One library per variant (the engine patched, both entries)."""
    root = cuda_lib.BUILD_ROOT / "dw-bf16-probe"
    procs = []
    for name, patches in VARIANTS.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for src in [*cuda_lib.CSRC.glob("*.cuh"),
                    cuda_lib.CSRC / "conv3d_dw.cu",
                    cuda_lib.CSRC / "cvstem_bwd.cu"]:
            text = src.read_text()
            if src.name == ENGINE:
                for old, new in patches:
                    if text.count(old) != 1:
                        raise SystemExit(f"torch_dw_bf16_probe: a patch of "
                                         f"{name} does not match once")
                    text = text.replace(old, new)
            (d / src.name).write_text(text)
        lib = d / "libprobe.so"
        cmd = [cuda_lib._nvcc(), *cuda_lib.ARCH_FLAGS, *cuda_lib.CFLAGS,
               "-shared", str(d / "conv3d_dw.cu"), str(d / "cvstem_bwd.cu"),
               "-o", str(lib)]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, lib, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{text}")
        handle = ctypes.CDLL(str(lib))
        for entry in ENTRIES:
            fn = getattr(handle, entry)
            fn.argtypes = cuda_lib.SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = handle
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
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_dw_bf16_probe: no CUDA device")
    libs = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(
            torch.bfloat16)

    cases = []
    for shape, cout in D_SHAPES:
        b, d, cin, h, w = shape
        cases.append(("D", (shape, cout),
                      (rand(*shape), rand(b, d, cout, h, w)),
                      conv3d_mod.dw_plan(*shape, cout)))
    b, c, h, w, nd, cout = F_SHAPE
    cases.append(("F", F_SHAPE, (rand(b, c, h, w), rand(b, c, h, w),
                                 rand(b, nd, cout, h, w)),
                  cvstem_mod.cvstem_dw_plan(b, nd, c, h, w, cout)))
    for kind, sig, acts, plan in cases:
        part = torch.empty(plan.workspace, device=dev)

        def run(lib, entry, ts, out, passes=1):
            if kind == "D":
                x, dz = ts
                b, d, cin, h, w = x.shape
                args = (x.data_ptr(), dz.data_ptr(), part.data_ptr(),
                        out.data_ptr(), b, d, cin, dz.shape[2], h, w)
            else:
                x, y, dz = ts
                b, c, h, w = x.shape
                args = (x.data_ptr(), y.data_ptr(), dz.data_ptr(),
                        part.data_ptr(), out.data_ptr(), b, dz.shape[1], c,
                        dz.shape[2], h, w)
            rc = getattr(lib, entry)(*args, plan.ci, plan.co_t, plan.kh_t,
                                     plan.groups, plan.th, plan.tw, plan.db,
                                     passes, stream)
            cuda_lib.check(rc, entry)

        base = "rag_conv3d_dw_cf" if kind == "D" else "rag_cvstem_dw"
        wide = tuple(t.float() for t in acts)
        cin = 2 * acts[0].shape[1] if kind == "F" else acts[0].shape[2]
        shape_out = (3, 3, 3, cin, acts[-1].shape[2])
        out32 = torch.empty(shape_out, device=dev)
        out16 = torch.empty(shape_out, device=dev)
        run(libs["as_is"], base, wide, out32, 3)
        run(libs["as_is"], base + "_bf16", acts, out16, 3)
        torch.cuda.synchronize()
        line = {"kernel": kind, "sig": str(sig),
                "tile": f"{plan.th}x{plan.tw}", "db": plan.db,
                "co_t": plan.co_t, "kh_t": plan.kh_t, "blocks": plan.blocks,
                "equal": torch.equal(out16, out32),
                "f32_ms": cuda_ms(lambda: run(libs["as_is"], base, wide,
                                              out32), opts.reps)}
        for name, lib in libs.items():
            line[f"{name}_ms"] = cuda_ms(
                lambda lib=lib: run(lib, base + "_bf16", acts, out16),
                opts.reps)
        print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
