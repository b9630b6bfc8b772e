"""Starting worlds of rank processes for the data- and spatially-parallel
tests on the CPU: ``launch(worker, world, tmp, *args)`` runs ``python
WORKER RANK WORLD ADDRESS OUT.npz ARGS...`` once per rank
(``launch_worlds`` several worlds side by side), with one torch thread each
(OMP_NUM_THREADS=1) and a hard timeout of TIMEOUT_S, past which the ranks
are killed and the test fails."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from rag_tpu_torch.parallel.multihost import local_address

TIMEOUT_S = 120


def launch(worker, world, tmp, *args):
    """Run ``worker`` on ``world`` ranks; their npz outputs, rank order."""
    return launch_worlds(worker, {world: tmp}, *args)[world]


def launch_worlds(worker, worlds, *args):
    """Run ``worker`` on several worlds at once, {world size: tmp dir}:
    every world's ranks start together; {world size: npz outputs in rank
    order}. One deadline covers them all."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    runs = {}
    for world, tmp in worlds.items():
        addr = local_address()
        outs = [tmp / f"rank{r}.npz" for r in range(world)]
        runs[world] = (outs, [
            subprocess.Popen([sys.executable, str(worker), str(r),
                              str(world), addr, str(outs[r]), *args],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, env=env)
            for r in range(world)])
    procs = [p for _, ps in runs.values() for p in ps]
    deadline = time.monotonic() + TIMEOUT_S
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail(f"rank processes still running after {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
    return {world: [dict(np.load(o)) for o in outs]
            for world, (outs, _) in runs.items()}
