"""ctypes bindings for the port's native data plane (librag_runtime.so).

Counterpart of rag_tpu/runtime/native.py. The library is built from the
port's own copy of the C++ source, ``rag_runtime.cpp`` beside this file,
at first use (never at import) into the checkout's git-ignored ``build/``,
keyed by a hash of the source and the flags, with ``g++ -O3 -fPIC -shared
-std=c++17 ... -lz -lpthread``. A build or load that fails raises with the
compiler's output: nothing here falls back to the Python readers, so a
caller that asked for the native path never silently gets another run.
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
from typing import Dict, Optional, Sequence

import numpy as np

from rag_tpu_torch.ops.cuda_lib import BUILD_ROOT

SRC = Path(__file__).resolve().parent / "rag_runtime.cpp"
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
LIBS = ["-lz", "-lpthread"]
LIB_NAME = "librag_runtime.so"

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}


def build(src: Optional[Path] = None) -> Path:
    """Compile ``src`` (default ``SRC``) unless its hash already has a
    library under ``build/``; return the library's path. Raises
    RuntimeError with g++'s output when the compile fails."""
    src = Path(src or SRC)
    h = hashlib.sha256(" ".join(CXXFLAGS + LIBS).encode())
    h.update(src.read_bytes())
    out_dir = BUILD_ROOT / f"native-{h.hexdigest()[:16]}"
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native data plane is built "
                           "with g++ at first use")
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="native-", dir=BUILD_ROOT))
    try:
        res = subprocess.run(
            [gxx, *CXXFLAGS, str(src), "-o", str(tmp / LIB_NAME), *LIBS],
            capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {src.name}:\n{res.stderr}")
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


def load(src: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library of ``src`` (default ``SRC``), built on first
    call."""
    src = Path(src or SRC)
    with _lock:
        if src not in _libs:
            lib = ctypes.CDLL(str(build(src)))
            c = ctypes.c_char_p
            i = ctypes.c_int
            ip = ctypes.POINTER(ctypes.c_int)
            fp = ctypes.POINTER(ctypes.c_float)
            lib.rag_png_info.argtypes = [c, ip, ip, ip, ip]
            lib.rag_png_read_f32.argtypes = [c, fp]
            lib.rag_pfm_info.argtypes = [c, ip, ip, ip]
            lib.rag_pfm_read.argtypes = [c, fp]
            lib.rag_loader_create.argtypes = [
                ctypes.POINTER(c), ctypes.POINTER(c), ctypes.POINTER(c),
                i, i, i, i, i, i, i, ctypes.c_uint]
            lib.rag_loader_create.restype = ctypes.c_void_p
            lib.rag_loader_next.argtypes = [ctypes.c_void_p, i, fp, fp, fp]
            lib.rag_loader_destroy.argtypes = [ctypes.c_void_p]
            _libs[src] = lib
        return _libs[src]


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_png_native(path: str) -> np.ndarray:
    """PNG -> float32 HWC ([0,1] for 8-bit; /256 for 16-bit gray)."""
    lib = load()
    w, h, ch, bd = (ctypes.c_int() for _ in range(4))
    if lib.rag_png_info(path.encode(), ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(ch), ctypes.byref(bd)) != 0:
        raise IOError(f"png decode failed: {path}")
    out = np.empty((h.value, w.value, ch.value), np.float32)
    if lib.rag_png_read_f32(path.encode(), _f32(out)) != 0:
        raise IOError(f"png read failed: {path}")
    return out[..., 0] if ch.value == 1 else out


def read_pfm_native(path: str) -> np.ndarray:
    """PFM -> float32, top-down (HW, or HWC for colour)."""
    lib = load()
    w, h, ch = (ctypes.c_int() for _ in range(3))
    if lib.rag_pfm_info(path.encode(), ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(ch)) != 0:
        raise IOError(f"pfm decode failed: {path}")
    out = np.empty((h.value, w.value, ch.value), np.float32)
    if lib.rag_pfm_read(path.encode(), _f32(out)) != 0:
        raise IOError(f"pfm read failed: {path}")
    return out[..., 0] if ch.value == 1 else out


class NativeStereoLoader:
    """Threaded native prefetcher yielding NHWC float32 numpy batches.

    training=True: random (crop_w, crop_h) crops; else top/right zero-pad
    to (pad_w, pad_h). Images come back ImageNet-normalized. Worker i
    crops from mt19937(seed + 7919 i); with ``n_threads=1`` the samples
    follow the list order, cycling, with one stream of crops."""

    def __init__(self, entries: Sequence[Sequence[str]], training: bool,
                 crop=(384, 192), pad=(960, 480), n_threads: int = 4,
                 seed: int = 0):
        self._handle = None
        self._lib = load()
        self.training = training
        self.w = crop[0] if training else pad[0]
        self.h = crop[1] if training else pad[1]
        n = len(entries)
        mk = lambda idx: (ctypes.c_char_p * n)(
            *[e[idx].encode() for e in entries])
        self._keepalive = (mk(0), mk(1), mk(2))
        self._handle = self._lib.rag_loader_create(
            self._keepalive[0], self._keepalive[1], self._keepalive[2],
            n, crop[0], crop[1], int(training), pad[0], pad[1],
            n_threads, seed)
        if not self._handle:
            raise RuntimeError("rag_loader_create failed")

    def next_batch(self, batch: int) -> Dict[str, np.ndarray]:
        left = np.empty((batch, self.h, self.w, 3), np.float32)
        right = np.empty((batch, self.h, self.w, 3), np.float32)
        disp = np.empty((batch, self.h, self.w), np.float32)
        rc = self._lib.rag_loader_next(self._handle, batch, _f32(left),
                                       _f32(right), _f32(disp))
        if rc != batch:
            raise RuntimeError(f"loader returned {rc}")
        return {"left": left, "right": right, "disparity": disp}

    def close(self):
        if self._handle:
            self._lib.rag_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
