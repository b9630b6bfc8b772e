"""The device trace of a traced segment: torch.profiler over a fixed
amount of work, its chrome trace read back into device intervals, their
classes (``benchmark/kernels.json``), the busy time, and the idle gaps
named by what the host was doing.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

KERNELS_FILE = Path(__file__).resolve().parent.parent / "kernels.json"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_classes() -> List[dict]:
    return json.loads(KERNELS_FILE.read_text())["rules"]


def classify(name: str, cat: str, rules: List[dict]) -> str:
    """The class of a device operation: the first rule all of whose
    substrings its lower-cased name holds; copies and sets by category."""
    if cat != "kernel":
        return "copies"
    low = name.lower()
    for rule in rules:
        if all(s in low for s in rule["all"]):
            return rule["class"]
    return "other"


class Trace:
    """Device operations of a traced segment and the host ops beside them."""

    def __init__(self, events: List[dict], window_s: float, items: int):
        self.window_s = window_s
        self.items = items
        rules = load_classes()
        self.device: List[Tuple[float, float, str, str]] = []   # us
        host = []
        for e in events:
            cat = e.get("cat")
            if cat in DEVICE_CATS and "dur" in e:
                self.device.append((float(e["ts"]), float(e["dur"]), e["name"],
                                    classify(e["name"], cat, rules)))
            elif cat == "cpu_op" and "dur" in e:
                host.append((float(e["ts"]), float(e["dur"]), e["name"],
                             e.get("tid")))
        self.device.sort()
        self.host = host
        self._busy = self._union()

    def _union(self) -> List[Tuple[float, float]]:
        spans: List[Tuple[float, float]] = []
        for ts, dur, _, _ in self.device:
            end = ts + dur
            if spans and ts <= spans[-1][1]:
                if end > spans[-1][1]:
                    spans[-1] = (spans[-1][0], end)
            else:
                spans.append((ts, end))
        return spans

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy) / 1e6

    @property
    def ops(self) -> int:
        return len(self.device)

    def class_s(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for _, dur, _, cls in self.device:
            out[cls] = out.get(cls, 0.0) + dur / 1e6
        return out

    def idle_gaps(self) -> Dict[str, float]:
        """Seconds of device idle time between the first and the last
        device operation, by the host op that was running at each gap's
        middle: the innermost op of any thread (the latest started), or
        "no_host_op" where none was."""
        gaps = [((a + b) / 2, b - a)
                for (_, a), (b, _) in zip(self._busy, self._busy[1:])]
        if not gaps:
            return {}
        best: List[Tuple[float, str]] = [(-1.0, "no_host_op")] * len(gaps)
        threads: Dict[object, list] = {}
        for ts, dur, name, tid in self.host:
            threads.setdefault(tid, []).append((ts, ts + dur, name))
        # one thread's ops nest, so a stack of its open ones, swept in
        # time order, holds its innermost op at the top
        for ops in threads.values():
            ops.sort()
            stack: List[Tuple[float, float, str]] = []
            i = 0
            for g, (mid, _) in enumerate(gaps):
                while i < len(ops) and ops[i][0] <= mid:
                    while stack and stack[-1][1] < ops[i][0]:
                        stack.pop()
                    stack.append(ops[i])
                    i += 1
                while stack and stack[-1][1] < mid:
                    stack.pop()
                if stack and stack[-1][0] > best[g][0]:
                    best[g] = (stack[-1][0], stack[-1][2])
        out: Dict[str, float] = {}
        for (_, length), (_, name) in zip(gaps, best):
            out[name] = out.get(name, 0.0) + length / 1e6
        return out


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def traced(run: Callable[[], int], directory: str) -> Trace:
    """Run ``run`` (which returns the items it did) under torch.profiler
    and read its trace; the chrome file goes to a temporary directory and
    is deleted once read."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        t0 = time.perf_counter()
        items = run()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    finally:
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json", dir=directory)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return Trace(events, window_s, items)


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
