#!/usr/bin/env python3
"""One benchmark cell's traced segment read through the program's spans.

    python3 scripts/torch_span_split.py --workload ds4-serve-cam1 --seed 7 \
        [--seconds 5] [--out build/spans]

On one NVIDIA GPU, runs the cell's loop (``benchmark/harness``) with a
short window and its traced segment under
``rag_tpu_torch.utils.profiling.trace`` (the chrome trace goes to
``--out/<workload>/``). Prints one JSON line:

* the segment's roots against its requests or steps, and each
  ``kernel.<letter>`` span count against that kernel's launch-counter
  delta over the segment;
* every span name's count, duration and self time a root (``spans``);
  for ``train.optimizer`` also its time on the device;
* the host-clock ms an item against the roots' mean duration, and the
  cell's ``program_span`` metrics (``benchmark/metrics``);
* the device's idle gaps by the host op running at each gap's middle (as
  ``harness.trace.Trace.idle_gaps``), and the gaps under no host op split
  by the innermost program span (a ``user_annotation`` event) there;
* in a serving cell, the same segment run again with the harness's two
  synchronizes around the router call left out (``without_route_syncs``):
  with them, the router's device work is waited for inside ``serve.route``
  and not in its fetch, ``serve.route.fetch``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]


def wrappers():
    """Each hand-written kernel's wrapper by its span name."""
    from rag_tpu_torch.ops import conv3d, cvstem, disparity, resize, shear

    ws = (conv3d.conv3d_affine_cf, conv3d.conv3d_dblock_cf,
          conv3d.conv3d_dw_cf, cvstem.cvstem_affine, cvstem.cvstem_dxy,
          cvstem.cvstem_dw, disparity.soft_argmin_fwd,
          disparity.soft_argmin_bwd, resize.resize_taps_cf,
          shear.shear_forward, shear.shear_adjoint)
    return {w.span: w for w in ws}


def launches():
    return {name: w.launches + getattr(w, "launches_bf16", 0)
            for name, w in wrappers().items()}


def innermost(events, mids):
    """For each time in ``mids`` (us), the name of the innermost event
    (the latest started of any thread) running there, or None."""
    best = [(-1.0, None)] * len(mids)
    threads = {}
    for e in events:
        threads.setdefault(e.get("tid"), []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    order = sorted(range(len(mids)), key=lambda g: mids[g])
    for ops in threads.values():
        ops.sort()
        stack, i = [], 0
        for g in order:
            mid = mids[g]
            while i < len(ops) and ops[i][0] <= mid:
                while stack and stack[-1][1] < ops[i][0]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            if stack and stack[-1][0] > best[g][0]:
                best[g] = (stack[-1][0], stack[-1][2])
    return [name for _, name in best]


def split(events, tr):
    """Idle seconds by the host op at each gap's middle, and the gaps under
    no host op by the innermost program span there."""
    gaps = [((a + b) / 2, b - a)
            for (_, a), (b, _) in zip(tr._busy, tr._busy[1:])]
    mids = [m for m, _ in gaps]
    ops = innermost([e for e in events
                     if e.get("cat") == "cpu_op" and "dur" in e], mids)
    spans = innermost([e for e in events
                       if e.get("cat") == "user_annotation" and "dur" in e],
                      mids)
    by_op, no_op = {}, {}
    for (_, length), op, sp in zip(gaps, ops, spans):
        op = op or "no_host_op"
        by_op[op] = by_op.get(op, 0.0) + length / 1e6
        if op == "no_host_op":
            sp = sp or "no_span"
            no_op[sp] = no_op.get(sp, 0.0) + length / 1e6
    return by_op, no_op


def span_table(store, roots):
    """Per span name: [count, ms, self ms, device ms or None], a root."""
    own = store.self_ns()
    out = {}
    for r in store.records():
        if r.root not in roots:
            continue
        row = out.setdefault(r.name, [0, 0.0, 0.0, None])
        row[0] += 1
        row[1] += r.ns / 1e6
        row[2] += own[r.id] / 1e6
        if r.events is not None:
            row[3] = (row[3] or 0.0) + r.device_ms
    n = max(len(roots), 1)
    return {k: [v[0] / n, v[1] / n, v[2] / n,
                None if v[3] is None else v[3] / n]
            for k, v in sorted(out.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default="build/spans")
    ap.add_argument("--device", default="cuda",
                    help="cpu: a rehearsal, at the traffic's sizes as given")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()

    import torch

    from harness import serve, spec, train
    from harness.trace import Trace, sync, top
    from rag_tpu_torch.utils import profiling

    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        print("torch_span_split: needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.load(args.workload)
    loop = {"serve": serve, "train": train}[cell.kind]
    metrics = [m["name"] for m in cell.per_layer
               if m["source"] == "program_span"]
    out_dir = Path(args.out) / args.workload
    report = {"workload": args.workload, "seed": args.seed,
              "device": (torch.cuda.get_device_name(0) if device == "cuda"
                         else device)}

    def segment(run):
        """The segment under profiling.trace: its Trace, the chrome
        events, the launch deltas and the host seconds."""
        sync(device)
        before = launches()
        with profiling.trace(str(out_dir)):
            ts = time.perf_counter()
            items = run()
            sync(device)
            window_s = time.perf_counter() - ts
        delta = {k: v - before[k] for k, v in launches().items()}
        events = json.loads((out_dir / "trace.json").read_text())
        events = events["traceEvents"] if isinstance(events, dict) else events
        return Trace(events, window_s, items), events, delta

    def reading(tr):
        recs = profiling.SPANS.records()
        roots = {r.root: r for r in recs if r.is_root}
        ctx = SimpleNamespace(items=tr.items, route_s=[], trace=tr)
        return {
            "roots": len(roots),
            "host_ms_per_item": 1e3 * tr.window_s / tr.items,
            "root_ms_mean": sum(r.ns for r in roots.values()) / 1e6
            / max(len(roots), 1),
            "device_idle": 100.0 * (1.0 - tr.busy_s / tr.window_s),
            "metrics": {m: spec.reader(m)(ctx) for m in metrics},
            "spans": span_table(profiling.SPANS, roots),
        }

    def traced(run, directory):
        tr, events, delta = segment(run)
        recs = profiling.SPANS.records()
        counts = {k: sum(1 for r in recs if r.name == k) for k in delta}
        by_op, no_op = split(events, tr)
        report.update(
            items=tr.items, launches=delta, kernel_spans=counts,
            kernels_match=counts == delta, dropped=profiling.SPANS.dropped,
            device_ops_per_item=tr.ops / tr.items, **reading(tr),
            idle_gaps=top(by_op), no_host_op_by_span=top(no_op, 20))
        if cell.kind == "serve":
            # serve.py's route wrapper calls its module's ``sync``
            fenced = serve.sync
            serve.sync = lambda device: None
            try:
                again, _, _ = segment(run)
            finally:
                serve.sync = fenced
            report["without_route_syncs"] = reading(again)
        return tr

    loop.traced = traced
    scratch = os.environ.get("TMPDIR") or str(ROOT / "build")
    res = loop.run(cell, args.seed, args.seconds, True, device, t0=t0,
                   scratch=scratch)
    report["window_items"] = res["attempted"]
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
