"""Profiling and debugging hooks.

Counterpart of rag_tpu/utils/profiling.py:
  * ``trace(log_dir)``: a torch.profiler session over the block, its
    chrome trace written to ``log_dir``. The session is always closed on
    the way out: a session left open in a process stops later profiles
    from recording pageable host-to-device copies.
  * ``StepTimer``: host-clock time of a step fenced by a synchronize of
    its result's device, with an exponential moving average of the rate.
  * ``debug_nans(enable)``: a switch, off by default, that makes the
    port's train steps raise FloatingPointError on a non-finite loss,
    output or gradient (``check_finite``), as jax_debug_nans stops a
    jitted step. Nothing reads it from the environment.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA where available); yields the
    profiler, whose ``key_averages()`` hold the session's events, and
    writes ``trace.json`` into log_dir after the session has closed."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _fence(result) -> None:
    """Wait for the devices of every tensor in result (nested dicts,
    lists and tuples) to finish."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _fence(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _fence(v)


class StepTimer:
    """Host-clock per-step timing with a device fence, plus EMA rates."""

    def __init__(self, items_per_step: int = 1, ema: float = 0.9):
        self.items = items_per_step
        self.ema = ema
        self.rate: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.time()

    def stop(self, result=None) -> Dict[str, float]:
        if result is not None:
            _fence(result)
        dt = time.time() - self._t0
        rate = self.items / dt if dt > 0 else 0.0
        self.rate = rate if self.rate is None else (
            self.ema * self.rate + (1 - self.ema) * rate)
        return {"step_s": dt, "items_per_s": rate, "items_per_s_ema": self.rate}


class _NanCheck:
    def __init__(self):
        self.enabled = False


NAN_CHECK = _NanCheck()


def debug_nans(enable: bool = True) -> None:
    """Turn the train steps' finiteness check on or off."""
    NAN_CHECK.enabled = bool(enable)


def check_finite(**tensors) -> None:
    """With debug_nans on: FloatingPointError naming the first non-finite
    tensor among ``tensors`` (a host sync per tensor). Off: nothing."""
    if not NAN_CHECK.enabled:
        return
    for name, t in tensors.items():
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {name}")
