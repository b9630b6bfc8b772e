"""A training cell: SGD steps of one task's train stage through the
program's step (``make_train_step``, or ``make_selfsup_train_step`` for
a photometric configuration).

Set-up loads the task's checkpoint onto the card, builds the step, its
parameters and optimizer state once, and makes a pool of distinct batches
on the device from the seed. It drives that step through its first
``check_steps`` steps on the pool's first batches (their losses, the
optimizer state after the first, and the parameters, running statistics
and momentum after the last are copied for the check), then
``warmup_steps`` more; the same objects then run the window, cycling
through the pool, with no fence between steps (as the program's own
training loop runs them); one synchronize closes it. The check replays
the first steps in the plain reference once the window has closed and
the program's state is freed.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from harness import compare, stats, work
from harness.inputs import train_pool
from harness.spec import ROOT, Cell
from harness.trace import sync, traced


def flat(tree, prefix=""):
    """A nested dict of tensors as {"a/b/c": detached copy}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().clone()
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
        scratch: str):
    from rag_tpu_torch.continual.state import load_checkpoint
    from rag_tpu_torch.train.trainer import (
        make_optimizer,
        make_selfsup_train_step,
        make_train_step,
    )

    cfg, traffic, hyper = cell.config, cell.traffic, cell.config["hyper"]
    task = traffic["task"]
    ckpt_dir = str(ROOT / cfg["checkpoint"])
    net, _ = load_checkpoint(ckpt_dir, task=task, device=device)
    specs, params, bn_stats = net.path(net.archis[task])
    trainable = net.trainable_sites(task)
    optimizer = make_optimizer(hyper["weight_decay"], hyper["grad_clip"])
    opt_state = optimizer.init(params)
    make_step = (make_selfsup_train_step if cfg["loss"] == "photometric"
                 else make_train_step)
    step = make_step(specs, trainable, optimizer, maxdisp=cfg["maxdisp"])
    pool = train_pool(seed, traffic, device)
    lr = hyper["lr"]

    def trained(tree):
        return {k: v for k, v in flat(tree).items()
                if k.split("/")[0] in trainable}

    p0, s0 = trained(params), trained(bn_stats)
    losses, mom1 = [], None
    n_check = traffic["check_steps"]
    for i in range(n_check):
        b = pool[i]
        params, bn_stats, opt_state, scalars = step(
            params, bn_stats, opt_state, lr, b["left"], b["right"],
            b["disparity"])
        losses.append(scalars["loss"])
        if i == 0:
            mom1 = trained(opt_state)
    prog = {"loss": [float(x) for x in losses], "momentum1": mom1,
            "params": trained(params), "stats": trained(bn_stats),
            "momentum": trained(opt_state)}
    i = n_check
    for _ in range(traffic["warmup_steps"]):
        b = pool[i % len(pool)]
        params, bn_stats, opt_state, _ = step(
            params, bn_stats, opt_state, lr, b["left"], b["right"],
            b["disparity"])
        i += 1
    sync(device)

    n = 0
    start = time.perf_counter()
    setup_s = start - t0
    deadline = start + seconds
    issued = []
    while time.perf_counter() < deadline:
        b = pool[i % len(pool)]
        params, bn_stats, opt_state, _ = step(
            params, bn_stats, opt_state, lr, b["left"], b["right"],
            b["disparity"])
        issued.append(time.perf_counter())
        i += 1
        n += 1
    sync(device)
    window_s = time.perf_counter() - start
    batch = traffic["batch"]
    e2e = {"train_pairs_per_s": stats.rate(n * batch, window_s),
           "setup_s": setup_s}

    per_layer = None
    if trace:
        w = work.cached(ckpt_dir, task, task, cfg["net"], batch,
                        tuple(traffic["crop_hw"]), trainable, cfg["loss"])
        k_trace = traffic["trace_steps"]
        state = [params, bn_stats, opt_state]

        def segment():
            j = i
            for _ in range(k_trace):
                b = pool[j % len(pool)]
                state[:3] = step(*state, lr, b["left"], b["right"],
                                 b["disparity"])[:3]
                j += 1
            return k_trace

        tr = traced(segment, scratch)
        per_layer = SimpleNamespace(
            trace=tr, items=k_trace,
            work={k: {"bound_s": v["bound_s"] * k_trace}
                  for k, v in w["kernels"].items()},
            flops=w["flops"] * n, window_s=window_s, route_s=[])
        del state

    memory_peak = (torch.cuda.max_memory_allocated()
                   if torch.device(device).type == "cuda" else 0)
    batches = pool[:n_check]
    del net, specs, params, bn_stats, opt_state, step, pool
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref, s0_ref = reference_steps(cfg, task, batches, device)
    return {"attempted": n, "failed": 0, "end_to_end": e2e,
            "per_layer_ctx": per_layer, "memory_peak": memory_peak,
            "numbers": compare.train_numbers(prog, ref, p0, s0, s0_ref,
                                             hyper["weight_decay"]),
            "window_s": window_s, "check_s": time.perf_counter() - t_check,
            "sixths": stats.sixths(issued, start, window_s),
            "batches": batches, "p0": p0, "prog": prog, "ref": ref,
            "s0_ref": s0_ref}


def reference_steps(cfg, task, batches, device, tf32: bool = False):
    """The reference's steps from the checkpoint on the same batches, and
    its checkpoint statistics."""
    from reference.net import Checkpoint, Path
    from reference.train import train_steps

    ckpt = Checkpoint(str(ROOT / cfg["checkpoint"]), task)
    path = Path(ckpt, task, cfg["net"], device)
    trainable = ckpt.trainable_sites(task)
    with stats.matmul_precision(tf32):
        ref = train_steps(path, trainable, batches, cfg["hyper"], cfg["loss"])
    s0 = {k: v for k, v in path.stats.items() if k.split("/")[0] in trainable}
    return ref, s0


def as_program(ref: dict, p0: dict, wd: float) -> dict:
    """A reference run in the form the program's run is compared in: its
    optimizer trace after the first step is the clipped gradient plus the
    weight decay."""
    return {"loss": ref["loss"],
            "momentum1": {k: g + wd * p0[k] for k, g in ref["grad"].items()},
            "params": ref["params"], "stats": ref["stats"],
            "momentum": ref["momentum"]}
