"""The hand-written kernels' share of their rooflines in the traced
segment: the summed bounds of the work kernels A-K do, over their summed
device time, in %. Only kernels that both ran and have counted work
enter the sums. Serves ``kernels_roofline.serve`` and
``kernels_roofline.train``."""

import json
from pathlib import Path

HAND_WRITTEN = json.loads(
    (Path(__file__).resolve().parent.parent / "kernels.json").read_text()
)["hand_written"]


def read(ctx):
    busy = ctx.trace.class_s()
    ran = [k for k in HAND_WRITTEN
           if busy.get(k, 0.0) > 0 and ctx.work.get(k, {}).get("bound_s", 0.0) > 0]
    if not ran:
        return None
    return (100.0 * sum(ctx.work[k]["bound_s"] for k in ran)
            / sum(busy[k] for k in ran))
