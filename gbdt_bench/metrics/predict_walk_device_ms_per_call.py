"""predict_walk_device_ms_per_call: device milliseconds of the walk (the
level loop and its leaf-depth count) a ``predict`` call in the traced
stretch, from the ``walk_device_ms`` CUDA-event reading of the port's
``predict.predict`` spans.  Moves predict_rows_s."""

from gbdt_bench.harness.readings import of_kind

SPAN, ATTR = "predict.predict", "walk_device_ms"


def read(r):
    if not of_kind(r, "predict"):
        return None
    ms = [s["attrs"][ATTR] for s in r["port_spans"]["stretch"]
          if s["name"] == SPAN and ATTR in s["attrs"]]
    return sum(ms) / r["calls"] if ms else None
