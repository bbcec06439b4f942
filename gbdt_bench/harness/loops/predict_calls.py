"""Batch-scoring traffic: one caller in a closed loop calls
``Booster.predict(X)`` on host float32 slices of a seeded pool.

Set-up makes the pool from the seed, grows a random ensemble over a seeded
sample of it (``data/forest.py``), writes it as model text and loads it with
``Booster(model_str=...)``, then calls ``predict`` once at the largest size
of every power-of-two rung the calls will use.  Call sizes are a fixed set
(``sizes`` of them, log-uniform in [min_rows, max_rows], from
``sizes_seed``), called a whole cycle at a time, each cycle in an order drawn
from the run's seed and each call at a seeded offset into the pool, so that
every seed does the same work but for the window's last, partial cycle.  The window calls until ``--seconds`` have passed;
each call is timed from the call to the numpy answer in hand.  A traced run
profiles the window's first ``profile_calls`` calls (a whole cycle of
sizes, so that every seed profiles the same work).  The answers of every
``check_every``-th call (from an offset drawn from the seed) and of the
largest call are kept and judged once the window is closed.

Traffic parameters: ``pool_rows``, ``min_rows``, ``max_rows``, ``sizes``,
``sizes_seed``, ``trees``, ``leaves``, ``grow_rows``, ``min_leaf_rows``,
``leaf_scale``, ``max_depth``, ``profile_calls``, ``check_every``.  The
readers get every span the port recorded in the traced stretch, by name.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ...data import tabular
from ...data import forest
from ...reference import judge, model_text
from .. import faults
from ..cli import Outcome, Run
from ..trace import Stretch


def _rung(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0)


def run(run: Run) -> Outcome:
    dev = run.device
    tr = run.traffic
    ds_cfg = run.config["dataset"]
    t = time.perf_counter()
    pool_rows = int(tr["pool_rows"])
    X, _ = tabular.make(ds_cfg["table"], pool_rows, run.seed, dev,
                             **ds_cfg.get("table_args", {}))
    F = X.shape[1]
    grow_rows = int(tr["grow_rows"])
    grown = forest.grow(X[:grow_rows], int(tr["trees"]), int(tr["leaves"]), run.seed,
                        min_rows=int(tr["min_leaf_rows"]), leaf_scale=float(tr["leaf_scale"]),
                        max_depth=int(tr["max_depth"]))
    text = forest.model_text(grown, F)
    pool = X.cpu().numpy()
    del X
    depth = forest.depths(grown)
    run.note(f"set-up: pool and model in {time.perf_counter() - t:.3f} s; leaves a tree "
             f"{float(np.mean(grown['num_leaves'])):.2f} (min {int(np.min(grown['num_leaves']))}); "
             f"leaf depth mean {depth.mean():.3f}, p50 {np.percentile(depth, 50):.0f}, "
             f"p95 {np.percentile(depth, 95):.0f}, max {depth.max()}")
    base = forest.log_uniform_sizes(int(tr["sizes"]), int(tr["min_rows"]), int(tr["max_rows"]),
                                    int(tr["sizes_seed"]))
    rng = np.random.default_rng(int(run.seed) % (1 << 63))
    # every cycle of calls is the whole set of sizes in a new seeded order
    cycles = 1024
    sizes = np.concatenate([base[rng.permutation(len(base))] for _ in range(cycles)])
    offsets = rng.integers(0, pool_rows - sizes + 1)
    every = int(tr["check_every"])
    keep_phase = int(rng.integers(0, every))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.obs import trace as port_trace

    params = {"device_type": "cpu"} if dev.type == "cpu" else {}
    undo = faults.plant(run.fault, "predict")
    try:
        bst = lgb.Booster(params=params, model_str=text)
        for rung in sorted({_rung(int(n)) for n in base}):
            n = int(max(s for s in base if _rung(int(s)) == rung))
            bst.predict(pool[:n])
        setup_s = time.perf_counter() - run.t_start
        run.note(f"set-up: setup_s {setup_s:.3f}")

        K = int(tr["profile_calls"]) if run.trace else 0
        lat, kept, sent = [], {}, []
        rows = failed = 0
        big = (-1, -1)
        stretch = None
        i = 0

        def call(i):
            nonlocal rows, failed, big
            j = i % len(sizes)
            n, off = int(sizes[j]), int(offsets[j])
            a = time.perf_counter()
            try:
                out = bst.predict(pool[off:off + n])
            except Exception as e:  # a call that fails counts, and the loop goes on
                failed += 1
                run.note(f"call {i} failed: {e!r}")
                out = None
            b = time.perf_counter()
            lat.append(b - a)
            rows += n
            sent.append((n, off))
            if out is not None and (i % every == keep_phase or n > big[0]):
                if n > big[0] and big[1] >= 0 and big[1] % every != keep_phase:
                    kept.pop(big[1], None)
                if n > big[0]:
                    big = (n, i)
                kept[i] = out
            return b

        stretch_spans = []
        t0 = time.perf_counter()
        if K:
            port_trace.reset_trace()
            with Stretch(dev) as stretch:
                for _ in range(K):
                    call(i)
                    i += 1
            stretch_spans = port_trace.spans()
        while True:
            b = call(i)
            i += 1
            if b - t0 >= run.seconds:
                break
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        run.note(f"window: {i} calls, {rows} rows in {window_s:.3f} s; "
                 f"{len(kept)} calls kept for the judgement")
    finally:
        undo()
    del bst
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    trees = model_text.parse(text)
    Xd = torch.from_numpy(pool).to(dev)
    ref, control = {}, {}
    for c in kept:
        n, off = sent[c]
        ref[c] = judge.reference_probabilities(trees, Xd[off:off + n])
        if run.control == "bf16":
            control[c] = judge.reference_probabilities(trees, Xd[off:off + n],
                                                       dtype=torch.bfloat16)
    if run.control not in (None, "bf16"):
        raise ValueError(f"control {run.control!r}: prediction has bf16")
    checks = judge.judge_predictions(control if run.control else kept, ref)
    run.note(f"reference: {time.perf_counter() - t:.3f} s over {len(kept)} calls")

    readings = {}
    if run.trace:
        readings = dict(kind="predict", calls=K, stretch=stretch.summary,
                        port_spans={"stretch": stretch_spans})
    lat_ms = np.asarray(lat) * 1e3
    return Outcome(attempted=i, failed=failed,
                   end_to_end={"setup_s": setup_s, "predict_rows_s": rows / window_s,
                               "predict_p95_ms": float(np.percentile(lat_ms, 95))},
                   checks=checks, memory_peak_bytes=peak, readings=readings,
                   stretch=stretch.summary if stretch is not None else None)
