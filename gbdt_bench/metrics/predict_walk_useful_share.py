"""predict_walk_useful_share: of the steps the walk took over the traced
stretch (every (tree, row) pair walks the deepest tree's levels), the share
each pair needed to reach its leaf (its leaf's depth), from the port's
``predict.predict`` counts ``walk_useful_steps`` and ``walk_steps``, summed
over the calls.  Moves predict_rows_s."""

from gbdt_bench.harness.readings import of_kind

SPAN = "predict.predict"


def read(r):
    if not of_kind(r, "predict"):
        return None
    calls = [s["attrs"] for s in r["port_spans"]["stretch"]
             if s["name"] == SPAN and "walk_steps" in s["attrs"]]
    steps = sum(a["walk_steps"] for a in calls)
    return sum(a["walk_useful_steps"] for a in calls) / steps if steps else None
