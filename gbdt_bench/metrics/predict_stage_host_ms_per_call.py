"""predict_stage_host_ms_per_call: host milliseconds a ``predict`` call in the
traced stretch spends casting its rows to float32 into the pinned buffer and
queueing their upload, from the port's ``predict.stage`` spans.  Moves
predict_p95_ms."""

from gbdt_bench.harness.readings import of_kind

SPAN = "predict.stage"


def read(r):
    if not of_kind(r, "predict"):
        return None
    durs = [s["dur"] for s in r["port_spans"]["stretch"] if s["name"] == SPAN]
    return 1e3 * sum(durs) / r["calls"] if durs else None
