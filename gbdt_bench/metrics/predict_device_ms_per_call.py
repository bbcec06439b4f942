"""predict_device_ms_per_call: device busy milliseconds a ``predict`` call
in the traced stretch.  Moves predict_rows_s."""

from gbdt_bench.harness.readings import of_kind


def read(r):
    if not of_kind(r, "predict"):
        return None
    return 1e3 * r["stretch"]["busy_s"] / r["calls"]
