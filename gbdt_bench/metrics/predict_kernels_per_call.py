"""predict_kernels_per_call: device operations (kernels, copies, sets) a
``predict`` call in the traced stretch.  Moves predict_p95_ms."""

from gbdt_bench.harness.readings import of_kind


def read(r):
    if not of_kind(r, "predict"):
        return None
    return sum(n for _, n in r["stretch"]["device_ops"].values()) / r["calls"]
