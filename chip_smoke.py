"""Quickest proof that lightgbm_tpu_torch runs on an NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and no network.
Imports no JAX.  Phases, one line each; any failure exits non-zero:

  1. build    compile csrc/hist.cu (nvcc -Xptxas -v: registers, shared
              memory, spills);
  2. kernels  each histogram kernel against its plain PyTorch version at the
              training path's shapes (1M x 28 x 255, float tile 8, int8 tile
              20) and on a ragged case; timings from CUDA events;
  3. train    lgb.train on a seeded Higgs-shaped binary set (1M train rows
              + 100k held out, 28 features, max_bin=255, 31 leaves, 20
              rounds): iterations/s, held-out AUC, kernel launch counts,
              save/reload bitwise, a small run held against the CPU, and
              a torch.profiler window of 5 rounds (device busy share);
  4. int8     the same set with use_quantized_grad=true, 5 rounds;
  5. device   nvidia-smi's name and power limit.

Then a JSON line with every kernel's numbers, and last the device line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20251016
N_TRAIN, N_TEST, N_FEAT, MAX_BIN = 1_000_000, 100_000, 28, 255
ROUNDS_FLOAT, ROUNDS_INT8, NUM_LEAVES = 20, 5, 31
# Held-out AUC floors.  Training is deterministic run to run (fixed-point
# float histograms, exact int8), and the card read 0.85044 after 20 float
# rounds and 0.80947 after 5 int8 rounds (PERF.md); each floor sits 0.01
# under its reading, so a fault that only degrades the trees still fails.
AUC_FLOOR = 0.84
AUC_FLOOR_INT8 = 0.80
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM, non-tensor-core f32 (integer adds counted alike)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ---------------------------------------------------------------------------
# data: a seeded set with the shape of UCI HIGGS (21 low-level kinematic
# columns, then 7 high-level masses; ~53% signal)
# ---------------------------------------------------------------------------
def higgs_like(n: int, seed: int):
    rng = np.random.RandomState(seed)
    y = (rng.rand(n) < 0.53).astype(np.float64)
    s = y[:, None]
    X = np.empty((n, N_FEAT), np.float64)
    # lepton pT/eta/phi, missing energy magnitude/phi
    X[:, 0] = rng.lognormal(-0.1 + 0.1 * y, 0.5)
    X[:, 1] = rng.randn(n) * 1.1
    X[:, 2] = rng.uniform(-np.pi, np.pi, n)
    X[:, 3] = rng.lognormal(-0.2 + 0.15 * y, 0.6)
    X[:, 4] = rng.uniform(-np.pi, np.pi, n)
    # 4 jets x (pT, eta, phi, b-tag)
    for j in range(4):
        c = 5 + 4 * j
        X[:, c] = rng.lognormal(-0.1 * j + 0.05 * y, 0.5)
        X[:, c + 1] = rng.randn(n) * (1.0 + 0.1 * j)
        X[:, c + 2] = rng.uniform(-np.pi, np.pi, n)
        p_b = 0.25 + 0.2 * y * (j < 2)
        X[:, c + 3] = np.where(rng.rand(n) < p_b, 2.17, 0.0) + np.where(
            rng.rand(n) < 0.1, 1.09, 0.0)
    # 7 high-level masses: signal peaks, background broad
    peaks = np.array([1.0, 1.02, 0.98, 0.95, 0.85, 1.05, 1.1])
    for k in range(7):
        sig = rng.normal(peaks[k], 0.12 + 0.03 * k, n)
        bkg = rng.lognormal(np.log(peaks[k]) + 0.1, 0.45, n)
        X[:, 21 + k] = np.where(s[:, 0] > 0, np.where(rng.rand(n) < 0.6, sig, bkg), bkg)
    # some missing values, as the real set has none but users' data do
    X[rng.rand(n, N_FEAT) < 0.01] = np.nan
    return X, y


def auc(y: np.ndarray, p: np.ndarray) -> float:
    order = np.argsort(p, kind="stable")
    ranks = np.empty(len(p), np.float64)
    ranks[order] = np.arange(1, len(p) + 1)
    # ties share their mean rank
    _, inv, cnt = np.unique(p, return_inverse=True, return_counts=True)
    sums = np.bincount(inv, weights=ranks)
    ranks = (sums / cnt)[inv]
    pos = y > 0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_inputs(n, f, b, tile, leaf_base, seed, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bins = torch.randint(0, b, (n, f), generator=g, device=dev, dtype=torch.int16)
    grad = torch.randn(n, generator=g, device=dev)
    hess = torch.rand(n, generator=g, device=dev) * 0.25
    mask = torch.rand(n, generator=g, device=dev) < 0.9
    # slots beyond [leaf_base, leaf_base + tile) and -1 are inactive rows
    slot = torch.randint(-1, tile + leaf_base + 2, (n,), generator=g,
                         device=dev, dtype=torch.int32)
    gq = torch.randint(-2, 3, (n,), generator=g, device=dev, dtype=torch.int8)
    hq = torch.randint(0, 5, (n,), generator=g, device=dev, dtype=torch.int8)
    return bins, grad, hess, mask, slot, gq, hq


def library_call(bins, vals, mask, slot, leaf_base, tile, num_bins, dtype):
    """One index_add_ over flat (slot, feature, bin) cells of all three
    channels: the PyTorch yardstick (indices built outside the timing)."""
    from lightgbm_tpu_torch.ops.hist_cuda import _rows_and_index

    rows, idx = _rows_and_index(bins, mask, slot, leaf_base, tile, num_bins)
    f = bins.shape[1]
    v = torch.stack([vals[0][rows].to(dtype), vals[1][rows].to(dtype),
                     torch.ones_like(vals[0][rows], dtype=dtype)], dim=1)
    v = v[:, None, :].expand(-1, f, -1).reshape(-1, 3).contiguous()
    idx = idx.reshape(-1).contiguous()
    acc = torch.zeros((tile * f * num_bins, 3), dtype=dtype, device=bins.device)

    def run():
        acc.zero_()
        acc.index_add_(0, idx, v)

    return run, rows


SECTOR = 32  # bytes: the unit in which the card reads scattered rows


def sector_bytes(rows: torch.Tensor, row_bytes: int) -> int:
    """Bytes of the 32-B sectors that rows ``rows`` of an array with
    ``row_bytes`` bytes a row touch (each sector counted once)."""
    r = rows.to(torch.int64)
    first = r * row_bytes // SECTOR
    last = ((r + 1) * row_bytes - 1) // SECTOR
    span = int((last - first).max()) + 1 if r.numel() else 0
    secs = torch.cat([torch.minimum(first + k, last) for k in range(span)]) \
        if span else r
    return int(torch.unique(secs).numel()) * SECTOR


def bound(n, f, tile, num_bins, rows, value_bytes, out_bytes):
    """Least time for one call on this run's data.  The function must read
    mask (1 B) and slot (4 B) of every row to learn which rows contribute;
    then only the contributing rows' bins (F x 2 B) and grad and hess
    (``value_bytes`` each), in the 32-B sectors those scattered rows touch;
    and write the (tile, 3, F, B) output once.  Operations: three adds per
    contributing row and feature."""
    nbytes = (n * 5 + sector_bytes(rows, f * 2) + 2 * sector_bytes(rows, value_bytes)
              + tile * 3 * f * num_bins * out_bytes)
    ops = int(rows.numel()) * f * 3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel_case(hc, n, f, b, tile, tile_q, leaf_base, dev, seed, timed):
    """Float kernel (tile) and int8 kernel (tile_q) against their plain
    versions on one set of inputs; with ``timed``, their times too."""
    bins, grad, hess, mask, slot, gq, hq = kernel_inputs(
        n, f, b, max(tile, tile_q), leaf_base, seed, dev)
    out = {}
    # float: within f32 summation order of the plain version, and repeatable
    k1 = hc.histogram_multi(bins, grad, hess, mask, slot, leaf_base, tile, b)
    k2 = hc.histogram_multi(bins, grad, hess, mask, slot, leaf_base, tile, b)
    p = hc.histogram_multi_plain(bins, grad, hess, mask, slot, leaf_base, tile, b)
    torch.cuda.synchronize()
    tol = 1e-5 * (float(hess.abs().max()) + 1.0)
    err = float((k1 - p).abs().max())
    if not torch.equal(k1, k2):
        raise AssertionError("float kernel: two launches differ")
    if not (err <= tol):
        raise AssertionError(f"float kernel vs plain: max|d| {err} > {tol}")
    if float(k1[:, 2].sum()) <= 0:
        raise AssertionError("float kernel: empty histogram")
    out["float"] = dict(max_abs_err=err, bitwise_plain=bool(torch.equal(k1, p)))
    # int8: exact
    q1 = hc.histogram_multi_quantized(bins, gq, hq, mask, slot, leaf_base,
                                      tile_q, b)
    qp = hc.histogram_multi_quantized_plain(bins, gq, hq, mask, slot, leaf_base,
                                            tile_q, b)
    torch.cuda.synchronize()
    if not torch.equal(q1, qp):
        raise AssertionError("int8 kernel differs from its plain version: "
                             f"max|d| {int((q1 - qp).abs().max())}")
    out["int8"] = dict(max_abs_err=0.0, bitwise_plain=True)
    if not timed:
        return out
    for name, tl, kern, plain, vals, dt, vb, ob in (
            ("float", tile, hc.histogram_multi, hc.histogram_multi_plain,
             (grad, hess), torch.float32, 4, 4),
            ("int8", tile_q, hc.histogram_multi_quantized,
             hc.histogram_multi_quantized_plain, (gq, hq), torch.int32, 1, 4)):
        args = (bins, vals[0], vals[1], mask, slot, leaf_base, tl, b)
        ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), iters=5, warmup=1)
        lib, rows = library_call(bins, vals, mask, slot, leaf_base, tl, b, dt)
        library_ms = cuda_ms(lib)
        b_ms, b_by = bound(n, f, tl, b, rows, vb, ob)
        out[name].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=b_ms, bound_by=b_by, tile=tl,
                         rows=int(rows.numel()))
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: training through the package's entry points
# ---------------------------------------------------------------------------
def train_timed(lgt, params, train_set, rounds):
    """lgb.train with a callback that stamps synchronized round ends."""
    stamps = []

    def stamp(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    bst = lgt.train(params, train_set, rounds, callbacks=[stamp])
    it_s = (len(stamps) - 1) / (stamps[-1] - stamps[0]) if len(stamps) > 1 else float("nan")
    return bst, it_s


def small_vs_cpu(lgt, params, Xtr, ytr, Xte, n=20000, rounds=3) -> float:
    """Train on ``n`` rows on the card and on the CPU (the plain versions
    throughout) and return the largest gap in predictions; fails above
    1e-4 (f32 arithmetic order of the torch ops on each side)."""
    cpu = {**params, "device_type": "cpu"}
    pc = lgt.train(cpu, lgt.Dataset(Xtr[:n], label=ytr[:n], params=cpu),
                   rounds).predict(Xte[:5000])
    pg = lgt.train(params, lgt.Dataset(Xtr[:n], label=ytr[:n], params=dict(params)),
                   rounds).predict(Xte[:5000])
    err = float(np.abs(pc - pg).max())
    if not err <= 1e-4:
        raise AssertionError(f"card and CPU disagree on a small input: {err} "
                             f"({params})")
    return err


def profile_rounds(lgt, params, train_set, rounds):
    """torch.profiler over ``rounds`` boosting rounds after a warm one
    (Booster.update): wall time, device time summed over the device's own
    events (kernels, copies, sets: one stream, so their sum is the busy
    time) and the five largest of them."""
    from torch.profiler import ProfilerActivity, profile

    bst = lgt.Booster(params=dict(params), train_set=train_set)
    bst.update()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            bst.update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        for k in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, k):
                return float(getattr(e, k))
        return 0.0

    # host operators also carry the device time of what they launched:
    # count only the device-side events, each once
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:5]
    return wall_ms, busy_ms, [(e.key[:60], dev_us(e) / 1e3, e.count) for e in top]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import hist_cuda as hc

    if "jax" in sys.modules or "lightgbm_tpu" in sys.modules:
        raise AssertionError("the port pulled in JAX or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    kind = torch.cuda.get_device_name(0)

    # ---- 1. build ----
    t0 = time.perf_counter()
    so = hc.build(force=True)
    hc._lib()
    for line in hc.build_log.splitlines():
        if any(k in line for k in ("registers", "spill", "smem", "Compiling entry")):
            log("ptxas: " + line.strip())
    log(f"phase 1 build: ok {so.name} in {time.perf_counter() - t0:.2f} s")

    # ---- 2. kernels vs plain versions ----
    t0 = time.perf_counter()
    # the leaf tiles the training path uses at this shape (8 float, 20 int8)
    tile_f = hc.recommended_leaf_tile(MAX_BIN, N_FEAT, NUM_LEAVES)
    tile_q = hc.recommended_leaf_tile(MAX_BIN, N_FEAT, NUM_LEAVES, quantized=True)
    main_case = check_kernel_case(hc, N_TRAIN, N_FEAT, MAX_BIN, tile_f, tile_q,
                                  0, dev, SEED, True)
    ragged = check_kernel_case(hc, 200_003, 130, MAX_BIN, tile_f, tile_q, 3,
                               dev, SEED + 1, False)
    for name in ("float", "int8"):
        r = main_case[name]
        log(f"phase 2 kernel {name}: N={N_TRAIN} F={N_FEAT} B={MAX_BIN} "
            f"tile={r['tile']} rows={r['rows']} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"max_abs_err={r['max_abs_err']:.3g} bitwise_plain={r['bitwise_plain']} "
            f"ragged(N=200003,F=130) max_abs_err={ragged[name]['max_abs_err']:.3g}")
    log(f"phase 2 kernels: ok in {time.perf_counter() - t0:.2f} s")

    # ---- 3. train, float ----
    t0 = time.perf_counter()
    X, y = higgs_like(N_TRAIN + N_TEST, SEED)
    Xtr, ytr, Xte, yte = X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], y[N_TRAIN:]
    base = {"objective": "binary", "max_bin": MAX_BIN, "num_leaves": NUM_LEAVES,
            "learning_rate": 0.1, "device_type": "cuda", "verbosity": -1,
            "seed": 7}
    train_set = lgt.Dataset(Xtr, label=ytr, params=dict(base))
    train_set.construct()
    log(f"phase 3 data: {N_TRAIN}+{N_TEST} rows x {N_FEAT} binned in "
        f"{time.perf_counter() - t0:.2f} s")
    hc.reset_counts()
    bst, it_s = train_timed(lgt, base, train_set, ROUNDS_FLOAT)
    torch.cuda.synchronize()
    launches_float = dict(hc.launches)
    plain_float = dict(hc.plain_calls)
    if launches_float["histogram_multi"] < ROUNDS_FLOAT:
        raise AssertionError(f"float kernel launched {launches_float} times in "
                             f"{ROUNDS_FLOAT} rounds")
    if any(plain_float.values()) or launches_float["histogram_multi_quantized"]:
        raise AssertionError(f"plain version or int8 kernel ran: {plain_float} "
                             f"{launches_float}")
    p = bst.predict(Xte)
    if p.shape != (N_TEST,) or not np.all(np.isfinite(p)):
        raise AssertionError("predictions are not finite (N,) values")
    a = auc(yte, p)
    if not a >= AUC_FLOOR:
        raise AssertionError(f"held-out AUC {a:.5f} < floor {AUC_FLOOR}")
    text = bst.model_to_string()
    p2 = lgt.Booster(model_str=text).predict(Xte)
    if not np.array_equal(p, p2):
        raise AssertionError("reloaded model predicts differently")
    small_err = small_vs_cpu(lgt, {**base, "num_leaves": 15}, Xtr, ytr, Xte)
    log(f"phase 3 train float: ok {ROUNDS_FLOAT} rounds it/s={it_s:.4f} "
        f"auc={a:.5f} (floor {AUC_FLOOR}) launches={launches_float['histogram_multi']} "
        f"({launches_float['histogram_multi'] / ROUNDS_FLOAT:.2f}/round) "
        f"plain_calls=0 reload=bitwise small-vs-cpu max|d|={small_err:.3g} "
        f"in {time.perf_counter() - t0:.2f} s")
    wall_ms, busy_ms, top = profile_rounds(lgt, base, train_set, 5)
    if busy_ms > 0:
        log(f"phase 3 profile (5 rounds after a warm one): wall_ms={wall_ms:.2f} "
            f"device_busy_ms={busy_ms:.2f} idle_share={1 - busy_ms / wall_ms:.4f} top: "
            + "; ".join(f"{k} {ms:.3f} ms x{c}" for k, ms, c in top))
    else:
        log(f"phase 3 profile: wall_ms={wall_ms:.2f}, device time not measured "
            "(the profiler saw no device activity)")

    # ---- 4. train, int8 ----
    t0 = time.perf_counter()
    qparams = {**base, "use_quantized_grad": True}
    hc.reset_counts()
    bst_q, it_s_q = train_timed(lgt, qparams, train_set, ROUNDS_INT8)
    torch.cuda.synchronize()
    launches_int8 = dict(hc.launches)
    if (launches_int8["histogram_multi_quantized"] < ROUNDS_INT8
            or any(hc.plain_calls.values())):
        raise AssertionError(f"int8 run: launches {launches_int8}, plain "
                             f"{hc.plain_calls}")
    pq = bst_q.predict(Xte)
    aq = auc(yte, pq)
    if not (np.all(np.isfinite(pq)) and aq >= AUC_FLOOR_INT8):
        raise AssertionError(f"int8 run: held-out AUC {aq} < floor {AUC_FLOOR_INT8}")
    # deterministic rounding, so the CPU run quantizes the same gradients
    small_err_q = small_vs_cpu(
        lgt, {**qparams, "num_leaves": 15, "stochastic_rounding": False},
        Xtr, ytr, Xte)
    log(f"phase 4 train int8: ok {ROUNDS_INT8} rounds it/s={it_s_q:.4f} "
        f"auc={aq:.5f} (floor {AUC_FLOOR_INT8}) "
        f"launches={launches_int8['histogram_multi_quantized']} "
        f"({launches_int8['histogram_multi_quantized'] / ROUNDS_INT8:.2f}/round) "
        f"small-vs-cpu max|d|={small_err_q:.3g} in {time.perf_counter() - t0:.2f} s")

    # ---- 5. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise AssertionError(f"nvidia-smi failed: {smi.stderr}")
    log(f"phase 5 device: ok total {time.perf_counter() - t_all:.2f} s")
    log(smi.stdout.strip().splitlines()[0])

    src, tpu = "lightgbm_tpu_torch/csrc/hist.cu", "lightgbm_tpu/ops/hist_pallas.py:120"
    kernels = []
    for name, key, launches in (
            ("histogram_multi", "float", launches_float["histogram_multi"]),
            ("histogram_multi_quantized", "int8",
             launches_int8["histogram_multi_quantized"])):
        r = main_case[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches, "max_abs_err": max(r["max_abs_err"],
                                                     ragged[key]["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
