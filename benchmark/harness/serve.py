"""A serving cell: one client in a closed loop sends its newest frame set
to ``RoutedInference.predict`` as soon as the last answer is back.

Set-up loads the committed checkpoint and router onto the card, makes the
pool of frame sets from the seed (host numpy arrays, as from cameras) and
sends every set of the pool once, which builds the kernels and warms
every shape the window will send. The window then cycles through the
pool for ``seconds``. Latency runs from the send to the disparity on the
host. A seeded sample of the window's requests, and its last, is kept
and held against the plain reference once the window has closed and the
program's state is freed.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from harness import inputs, stats, work
from harness.spec import ROOT, Cell
from harness.trace import sync, traced


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
        scratch: str):
    from rag_tpu_torch.continual.inference import RoutedInference
    from rag_tpu_torch.continual.state import load_checkpoint, load_router

    cfg, traffic = cell.config, cell.traffic
    ckpt_dir = str(ROOT / cfg["checkpoint"])
    net, _ = load_checkpoint(ckpt_dir, task=cfg["checkpoint_task"],
                             device=device)
    router = load_router(ckpt_dir, device=device)
    ri = RoutedInference(net, router, maxdisp=cfg["maxdisp"], device=device)
    pool = inputs.serve_pool(seed, traffic, device)

    # a span around the instance's public route call: the routed ids of
    # each request, and (traced runs) the fenced time of the call
    routed = {"ids": None, "spans": []}
    program_route = ri.route

    def route(left):
        if trace:
            sync(device)
            ts = time.perf_counter()
        ids = program_route(left)
        if trace:
            sync(device)
            routed["spans"].append(time.perf_counter() - ts)
        routed["ids"] = np.asarray(ids)
        return ids

    ri.route = route
    for s in pool:
        ri.predict(s["left"], s["right"])
    sync(device)
    routed["spans"].clear()

    keep = traffic["check_requests"]
    rng = np.random.default_rng(seed)
    kept = {}                   # slot -> (request, pool index, ids, disparity)
    lat, tasks, ends = [], [], []
    n = 0
    start = time.perf_counter()
    setup_s = start - t0
    deadline = start + seconds
    last = None
    while True:
        sent = time.perf_counter()
        if sent >= deadline:
            break
        i = n % len(pool)
        disp = ri.predict(pool[i]["left"], pool[i]["right"])
        done = time.perf_counter()
        lat.append(done - sent)
        ends.append(done)
        ids = routed["ids"]
        tasks.append(ids)
        rec = (n, i, ids, disp)
        slot = n if n < keep else int(rng.integers(0, n + 1))
        if slot < keep:
            kept[slot] = rec
        last = rec
        n += 1
    end = time.perf_counter()
    window_s = end - start
    pairs = traffic["pairs_per_request"]
    e2e = {"frames_per_s": stats.rate(n * pairs, window_s),
           "request_ms_p95": stats.p95(lat) * 1e3,
           "setup_s": setup_s}

    per_layer = None
    if trace:
        hw = tuple(traffic["pad_to"])

        def frame_work(t):
            return work.cached(ckpt_dir, cfg["checkpoint_task"], int(t),
                               cfg["net"], 1, hw)

        flops = sum(frame_work(t)["flops"] for ids in tasks for t in ids)
        route_s = list(routed["spans"])
        k_trace = traffic["trace_requests"]
        seg_tasks = []

        def segment():
            for j in range(k_trace):
                s = pool[(n + j) % len(pool)]
                ri.predict(s["left"], s["right"])
                seg_tasks.append(routed["ids"])
            return k_trace

        tr = traced(segment, scratch)
        seg_work = {}
        for ids in seg_tasks:
            for t in ids:
                for k, v in frame_work(t)["kernels"].items():
                    acc = seg_work.setdefault(k, {"bound_s": 0.0})
                    acc["bound_s"] += v["bound_s"]
        per_layer = SimpleNamespace(
            trace=tr, items=k_trace, work=seg_work,
            flops=flops, window_s=window_s, route_s=route_s)

    memory_peak = (torch.cuda.max_memory_allocated()
                   if torch.device(device).type == "cuda" else 0)
    samples = [kept[k] for k in sorted(kept)]
    if last is not None and all(last[0] != s[0] for s in samples):
        samples.append(last)
    del ri, net, router, program_route, route
    routed.clear()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    nums = check(cfg, pool, samples, device)
    return {"attempted": n, "failed": 0, "end_to_end": e2e,
            "per_layer_ctx": per_layer, "memory_peak": memory_peak,
            "numbers": nums, "window_s": window_s,
            "sixths": stats.sixths(ends, start, window_s),
            "check_s": time.perf_counter() - t_check,
            "pool": pool, "samples": samples}


def reference_outputs(cfg, pool, samples, device, tf32: bool = False):
    """The plain reference's answer to each sampled request, in the
    samples' form: (request, pool index, routed ids, disparity)."""
    from reference.net import Checkpoint, Net, Path, router_ids

    ckpt = Checkpoint(str(ROOT / cfg["checkpoint"]), cfg["checkpoint_task"])
    weights = ckpt.router(device)
    paths, out = {}, []
    with torch.no_grad(), stats.matmul_precision(tf32):
        for n, i, _, _ in samples:
            left = torch.from_numpy(pool[i]["left"]).to(device)
            right = torch.from_numpy(pool[i]["right"]).to(device)
            ids = router_ids(weights, left).cpu().numpy()
            disp = []
            for f, t in enumerate(ids):
                t = int(t)
                if t not in paths:
                    paths[t] = Path(ckpt, t, cfg["net"], device)
                p = paths[t]
                disp.append(Net(p, p.params, p.stats).forward(
                    left[f:f + 1], right[f:f + 1])[0].cpu().numpy())
            out.append((n, i, ids, np.stack(disp)))
    return out


def numbers(samples, refs) -> dict:
    """Routed ids that differ, and the disparity's widest and mean absolute
    gap (px), of the samples against the reference's answers."""
    mismatched, widest, total, count = 0, 0.0, 0.0, 0
    for (_, _, ids, disp), (_, _, ref_ids, ref) in zip(samples, refs):
        mismatched += int((np.asarray(ids) != ref_ids).sum())
        gap = np.abs(disp.astype(np.float64) - ref)
        widest = max(widest, float(gap.max()))
        total += float(gap.sum())
        count += gap.size
    return {"ids_mismatch": float(mismatched), "disp_max_px": widest,
            "disp_mean_px": total / max(count, 1)}


def check(cfg, pool, samples, device) -> dict:
    return numbers(samples, reference_outputs(cfg, pool, samples, device))
