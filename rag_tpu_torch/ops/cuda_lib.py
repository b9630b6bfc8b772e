"""Build and load the port's hand-written CUDA kernels.

The sources in ``rag_tpu_torch/csrc/*.cu`` are compiled by ``nvcc`` for
``sm_90a`` (H100) into one shared library with a plain C interface, loaded
with ``ctypes``. The build happens at first use, into ``build/`` at the root
of the checkout, keyed by a hash of the sources and flags, so a fresh
checkout needs nothing but ``nvcc``: every ``.cu`` is compiled by its own
``nvcc`` process, all started together, then linked once.

Nothing here runs when the module is imported: the CPU tests import every
module of the port, and there is no ``nvcc`` on a CPU host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build"
CUDA_HOME = Path("/usr/local/cuda")  # where nvcc is looked for off the PATH
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
LIB_NAME = "librag_tpu_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types (every pointer and the stream as
# c_void_p: a bare Python int would be passed as a 32-bit int)
SIGNATURES = {
    "rag_conv3d_brc_cf": [_P] * 6 + [_I] * 13 + [_P],
    "rag_conv3d_pack": [_P] * 2 + [_I] * 5 + [_P],
    "rag_cvstem_brc": [_P] * 7 + [_I] * 13 + [_P],
    "rag_soft_argmin": [_P] * 5 + [_I] * 8 + [_P],
    "rag_conv3d_dw_cf": [_P] * 4 + [_I] * 14 + [_P],
    "rag_cvstem_dw": [_P] * 5 + [_I] * 14 + [_P],
    "rag_cvstem_dxy": [_P] * 5 + [_I] * 11 + [_P],
    "rag_soft_argmin_bwd": [_P] * 8 + [_I] * 9 + [_P],
    "rag_resize_taps_cf": [_P] * 4 + [_I] * 15 + [_P],
    "rag_shear_fwd": [_P] * 5 + [_I] * 6 + [_P],
    "rag_shear_adj": [_P] * 3 + [_I] * 5 + [_P],
    "rag_shear_plan": [_I] * 7 + [_P],
}
# the bf16 instances of kernels A/H, B, D, F, E, I, J and K: the same
# arguments
BF16_ENTRIES = ("rag_conv3d_brc_cf", "rag_cvstem_brc", "rag_conv3d_dw_cf",
                "rag_cvstem_dw", "rag_cvstem_dxy", "rag_resize_taps_cf",
                "rag_shear_fwd", "rag_shear_adj")
SIGNATURES.update({f"{n}_bf16": SIGNATURES[n] for n in BF16_ENTRIES})

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = CUDA_HOME / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit on the machine with the card")


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path. ptxas's register/spill report for every kernel is
    kept beside it in ``ptxas.log``."""
    out_dir = BUILD_ROOT / f"kernels-{source_hash()}"
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="kernels-", dir=BUILD_ROOT))
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-Xptxas", "-v", "-c",
                   str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        (tmp / "ptxas.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        try:
            os.replace(tmp, out_dir)
        except OSError:
            # another process finished the same build first
            if not lib_path.exists():
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def entry(name: str, dtype):
    """The C entry point of a kernel for operands of ``dtype``: ``name``
    for float32, its ``_bf16`` instance for bfloat16."""
    import torch

    if dtype == torch.bfloat16 and name in BF16_ENTRIES:
        return getattr(lib(), f"{name}_bf16")
    if dtype != torch.float32:
        raise ValueError(f"{name}: no instance for {dtype}")
    return getattr(lib(), name)


def count(wrapper, dtype) -> None:
    """One launch of a kernel wrapper's instance for ``dtype``: on
    ``wrapper.launches`` for float32, ``wrapper.launches_bf16`` for the
    bf16 instance."""
    import torch

    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError_t {rc}")


def stream_ptr(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on the tensor's device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
