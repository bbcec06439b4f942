"""Training traffic: one ``Booster`` trained by ``Booster.update()`` back to
back.

Set-up makes the table from the seed, builds the ``Dataset`` (the ``bin``
span), builds the ``Booster``, and drives it through ``follow_steps`` steps
(each one's training logloss kept for the judgement) and ``warmup_steps``
more, so that every graph the window replays is captured before it.  The
window then calls ``update()`` until ``--seconds`` have passed, closes at
that iteration's end and synchronises.  A traced run profiles
``profile_steps`` steps (``Stretch``) before a window as long as an
untraced run's, and times every ``update()`` call of that window on the
host.  Once the window is closed the peak memory is read, the port's
outputs are taken (model text, bins, and its ``predict`` of the held-out
rows), the port is freed, and the reference judges them.  The readers get
every span the port recorded in the stretch and in the window, by name.

Traffic parameters: ``follow_steps``, ``warmup_steps``, ``profile_steps``,
``judge_tree`` (the window's tree judged beside the followed ones).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ...data import tabular
from ...reference import judge
from ...roofline import needed_bytes
from .. import faults
from ..cli import Outcome, Run
from ..trace import Stretch


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def port_params(run: Run) -> dict:
    params = dict(run.config["params"])
    if run.device.type == "cpu":
        params["device_type"] = "cpu"
    if run.control == "bf16":
        params["hist_precision"] = "bf16"
    elif run.control is not None:
        raise ValueError(f"control {run.control!r}: training has bf16")
    return params


def run(run: Run) -> Outcome:
    dev = run.device
    ds_cfg = run.config["dataset"]
    tr = run.traffic
    n_train, n_test = int(ds_cfg["train_rows"]), int(ds_cfg["test_rows"])
    t = time.perf_counter()
    X, y = tabular.make(ds_cfg["table"], n_train + n_test, run.seed, dev,
                             **ds_cfg.get("table_args", {}))
    Xh, yh = X.cpu().numpy(), y.cpu().numpy()
    del X, y
    X_train, y_train = Xh[:n_train], yh[:n_train]
    run.note(f"set-up: table {n_train}+{n_test} x {Xh.shape[1]} in "
             f"{time.perf_counter() - t:.3f} s")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.obs import trace as port_trace

    params = port_params(run)
    undo = faults.plant(run.fault, "train")
    try:
        t = time.perf_counter()
        ds = lgb.Dataset(X_train, label=y_train, params=params)
        ds.construct()
        _sync(dev)
        bin_s = time.perf_counter() - t
        t = time.perf_counter()
        bst = lgb.Booster(params=params, train_set=ds)
        losses = []
        for _ in range(int(tr["follow_steps"])):
            bst.update()
            losses.append(next(v for _, name, v, _ in bst.eval_train()
                               if name == "binary_logloss"))
        for _ in range(int(tr["warmup_steps"])):
            bst.update()
        _sync(dev)
        steps_before = int(tr["follow_steps"]) + int(tr["warmup_steps"])
        setup_s = time.perf_counter() - run.t_start
        run.note(f"set-up: bin {bin_s:.3f} s, booster and {steps_before} steps "
                 f"{time.perf_counter() - t:.3f} s, setup_s {setup_s:.3f}")
        port_trace.reset_trace()

        K = int(tr["profile_steps"]) if run.trace else 0
        host_s = []
        stretch = None
        stretch_spans = []
        if K:
            # the traced stretch, then a window as long as an untraced run's
            with Stretch(dev) as stretch:
                for _ in range(K):
                    bst.update()
            stretch_spans = port_trace.spans()
            port_trace.reset_trace()
        iters = 0
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            bst.update()
            b = time.perf_counter()
            host_s.append(b - a)
            iters += 1
            if b - t0 >= run.seconds:
                break
        _sync(dev)
        t1 = time.perf_counter()
        window_s = t1 - t0
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        window_spans = port_trace.spans()
        captures = sum(int(s["attrs"].get("captures", 0)) for s in window_spans
                       if s["name"] == "boost_round")
        run.note(f"window: {iters} iterations in {window_s:.3f} s, graph captures "
                 f"in the window {captures}")
        iterations = steps_before + K + iters
        text = bst.model_to_string()
        port_bins = ds.bins_device
        port_bounds = [np.asarray(m.upper_bounds, np.float64) for m in ds.binner.mappers]
        X_test = Xh[n_train:]
        held_out = np.asarray(bst.predict(X_test))
    finally:
        undo()
    del bst, ds
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    profiled = list(range(steps_before, steps_before + K))
    checks, node_rows = judge.judge_training(
        X=X_train, y=y_train, text=text, losses=losses,
        iterations=iterations, port_bins=port_bins, port_bounds=port_bounds,
        params=params, device=dev, judge_tree=int(tr["judge_tree"]), count_trees=profiled)
    checks.update(judge.judge_held_out(text, X_test, held_out, dev))
    run.note(f"reference: {time.perf_counter() - t:.3f} s")

    readings = {}
    if run.trace:
        from ...reference import model_text
        trees = model_text.parse(text)
        N, F = X_train.shape
        B = int(params["max_bin"]) + 1
        parts = [needed_bytes.iteration_bytes(
            N, F, B, needed_bytes.splits_of(trees[i], node_rows[i])) for i in profiled]
        readings = dict(
            kind="train", steps=K, stretch=stretch.summary, bin_s=bin_s,
            host_s=host_s, wall_per_step_s=window_s / iters,
            port_spans={"stretch": stretch_spans, "window": window_spans},
            bytes={k: sum(p[k] for p in parts) / K for k in parts[0]},
            device_kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"))
    return Outcome(attempted=iterations, failed=0,
                   end_to_end={"setup_s": setup_s, "train_iter_s": iters / window_s},
                   checks=checks, memory_peak_bytes=peak, readings=readings,
                   stretch=stretch.summary if stretch is not None else None)
