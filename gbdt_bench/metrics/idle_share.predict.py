"""idle_share.predict: 1 - device busy / wall over the traced stretch of
``predict`` calls.  Moves predict_rows_s."""

from gbdt_bench.harness.readings import of_kind


def read(r):
    if not of_kind(r, "predict"):
        return None
    s = r["stretch"]
    return 1.0 - s["busy_s"] / s["window_s"]
