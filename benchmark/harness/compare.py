"""The numbers that decide ``correct``, and their arithmetic.

Serving: routed task ids (exact) and the disparity's widest and mean
absolute gap to the reference's, in pixels, over the requests sampled.

Training, after the same steps from the same state on the same batches:
  * ``loss_gap``: the widest relative gap of a step's loss;
  * ``grad_gap``: the first step's gradient as the optimizer got it
    (clipped), per leaf: |program norm - reference norm| over the larger
    of the reference's norm of that leaf and of the median leaf; the
    worst leaf;
  * ``delta_gap``, ``stats_gap``, ``momentum_gap``: the same measure of
    the parameters' change, the running statistics' change and the
    momentum after the last step. Leaves whose reference gradient is
    under a thousandth of the median leaf's are left out of the change:
    they move by round-off alone.
Beside them, as readings, each step's loss gap (``loss_gap1`` ...) and
the median leaf's gap of each tree (``grad_gap_median`` ...): a cell's
limits file names the numbers that decide ``correct``.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

EXCLUDE_BELOW = 1e-3


def norms(tree: Dict[str, torch.Tensor], keys: Iterable[str]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(tree[k].double()))
            for k in keys if k in tree}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """Per reference leaf |p - r| / max(r, median r); a leaf the program
    lacks reads 1."""
    if not ref:
        return {}
    vals = sorted(ref.values())
    med = vals[len(vals) // 2]
    out = {}
    for k, r in ref.items():
        den = max(r, med)
        out[k] = 1.0 if k not in prog else (
            abs(prog[k] - r) / den if den > 0 else 0.0)
    return out


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref).values(), default=0.0)


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The median leaf's gap (``leaf_gaps``)."""
    g = sorted(leaf_gaps(prog, ref).values())
    return g[len(g) // 2] if g else 0.0


def train_numbers(prog: dict, ref: dict, p0: dict, s0_prog: dict,
                  s0_ref: dict, wd: float) -> Dict[str, float]:
    """prog: the program's losses, momentum after step 1, params, stats and
    momentum after the last step (flat dicts); ref: reference.train's
    output; p0: the program's parameters before step 1."""
    keys = sorted(ref["params"])
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["loss"], ref["loss"]))
    g_prog = {k: prog["momentum1"][k] - wd * p0[k] for k in keys
              if k in prog["momentum1"]}
    g_ref_n = norms(ref["grad"], keys)
    med = sorted(g_ref_n.values())[len(g_ref_n) // 2]
    moved = [k for k in keys if g_ref_n[k] >= EXCLUDE_BELOW * med]
    d_prog = {k: prog["params"][k] - p0[k] for k in moved if k in prog["params"]}
    d_ref = {k: ref["params"][k] - p0[k] for k in moved}
    skeys = sorted(ref["stats"])
    st_prog = {k: prog["stats"][k] - s0_prog[k] for k in skeys
               if k in prog["stats"]}
    st_ref = {k: ref["stats"][k] - s0_ref[k] for k in skeys}
    pairs = {
        "grad": (norms(g_prog, keys), g_ref_n),
        "delta": (norms(d_prog, moved), norms(d_ref, moved)),
        "stats": (norms(st_prog, skeys), norms(st_ref, skeys)),
        "momentum": (norms(prog["momentum"], keys),
                     norms(ref["momentum"], keys)),
    }
    out = {"loss_gap": loss_gap}
    for i, (a, b) in enumerate(zip(prog["loss"], ref["loss"])):
        out[f"loss_gap{i + 1}"] = abs(a - b) / max(abs(b), 1e-30)
    for name, (p, r) in pairs.items():
        out[f"{name}_gap"] = worst_leaf_gap(p, r)
        out[f"{name}_gap_median"] = median_leaf_gap(p, r)
    return out


def worst_leaves(prog: dict, ref: dict, p0: dict, wd: float) -> Dict[str, str]:
    """Which leaf reads the worst gap of the first gradient and of the
    change, with its size: what a look at a wide reading starts from."""
    keys = sorted(ref["params"])
    g_prog = {k: prog["momentum1"][k] - wd * p0[k] for k in keys}
    d_prog = {k: prog["params"][k] - p0[k] for k in keys}
    d_ref = {k: ref["params"][k] - p0[k] for k in keys}
    out = {}
    for name, (p, r) in (("grad", (g_prog, ref["grad"])),
                         ("delta", (d_prog, d_ref))):
        gaps = leaf_gaps(norms(p, keys), norms(r, keys))
        k = max(gaps, key=gaps.get)
        out[name] = f"{k} ({ref['params'][k].numel()} values)"
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: [value, limit]}) over the numbers that have a
    limit; a number that is not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        checks[name] = [value, limit]
        if not value <= limit:
            ok = False
    return ok, checks
