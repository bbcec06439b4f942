"""Quickest proof that lightgbm_tpu_torch runs on an NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and no network.
Imports no JAX.  Phases, one line each; any failure exits non-zero:

  1. build    compile csrc/hist.cu, partition.cu and round.cu, one nvcc
              each, all started together (nvcc -Xptxas -v: registers,
              shared memory, spills), and count each kernel's atomic
              instruction forms in cuobjdump -sass where the toolkit has it;
  2. kernels  each histogram kernel against its plain PyTorch version at the
              training path's shapes (1M x 28 x 255, float tile 8, int8 tile
              20) and on a ragged case; timings from CUDA events;
  3. train    lgb.train on a seeded Higgs-shaped binary set (1M train rows
              + 100k held out, 28 features, max_bin=255, 31 leaves, 20
              rounds): iterations/s, held-out AUC, kernel launch counts,
              save/reload bitwise, a small run held against the CPU, and
              a torch.profiler window of 5 rounds (device busy share);
              each training run (phases 3, 4, 6, 8) prints the sha256 of
              its model text, so a change can show the trees did not move;
  4. int8     the same set with use_quantized_grad=true, 5 rounds;
  5. epsilon  a seeded Epsilon-shaped set (400k train + 50k held-out rows x
              2000 dense features, 255 bins) binned once for phases 6-9;
  6. windowed lgb.train with windowed_growth=true, 255 leaves, 5 rounds:
              the round megakernel every round, held-out AUC, save/reload,
              round-driver stats and a torch.profiler window;
  7. kernels  every kernel of the windowed path against its plain version,
              bit for bit, on the real bins with phase 6's gradients: the
              root histogram pass (tile 1, explicit exponents), the
              partition, the float window pass and the round megakernel
              (two sets of split options) at the float leaf tile 10, the
              partition and the int8 window pass at the int8 tile 20, and
              a ragged case; the root pass and the int8 window pass beside
              their bounds, and the round kernel's per-phase device times
              (partition, window pass, subtraction, split search) from a
              torch.profiler window, each beside its own bound; the
              partition's time per Python call (events), its device time
              (profiler) and the floor of one launch from Python;
  8. int8     the same with use_quantized_grad=true, 3 rounds: the
              three-pass round (partition kernel + int8 histogram kernel);
  9. parity   megakernel=auto against megakernel=0 on 100k of the rows, 2
              trees: the same nodes, leaf counts and leaf values, and each
              run's launches counted;
 10. device   nvidia-smi's name and power limit.

Then a JSON line with every kernel's numbers, and last the device line
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --variants [CHECKOUT]

times the histogram, partition and round kernels' design variants against
each other in turns (``variants``), each held bitwise to the plain
versions; with CHECKOUT, another checkout's lightgbm_tpu_torch (e.g. the
parent commit's, unpacked with git archive), its own wrappers and kernels,
is one more variant.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

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
# the Epsilon-shaped cell (PASCAL Large Scale Learning Challenge "epsilon":
# 400k train rows x 2000 dense features; the real set is not on the machine)
EPS_N_TRAIN, EPS_N_TEST, EPS_FEAT, EPS_LEAVES = 400_000, 50_000, 2000, 255
EPS_ROUNDS_FLOAT, EPS_ROUNDS_INT8, EPS_PARITY_ROWS = 5, 3, 100_000
EPS_BIN_SAMPLE = 50_000  # bin_construct_sample_cnt (PERF.md section 4)
# the card read 0.64003 (5 float rounds) and 0.62815 (3 int8 rounds) on
# this generator (PERF.md); each floor sits 0.01 under its reading
AUC_FLOOR_EPS = 0.63
AUC_FLOOR_EPS_INT8 = 0.61
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


def library_partition(order, seg_start, seg_len, go_left):
    """The PyTorch yardstick (timed, never called by the port): one stable
    sort of the in-segment positions by (segment start, goes right) gives
    the same permutation.  Returns the call to time (keys built outside)."""
    from lightgbm_tpu_torch.ops.partition import segment_ids

    n = order.shape[0]
    sid = segment_ids(seg_start, seg_len, n).long()
    in_seg = sid >= 0
    start = seg_start.long()[sid.clamp_min(0)]
    key = torch.where(in_seg, start * 2 + (~go_left).long(), -1)
    pos = torch.nonzero(in_seg).squeeze(1)
    key_in = key[pos]

    def run():
        perm = torch.sort(key_in, stable=True).indices
        out = order.clone()
        out[pos] = order[pos[perm]]
        return out

    return run


# Segment geometries a round can hand the partition (kChunk = 4096): name ->
# (N, seg_start, seg_len), segments in admission order.
PARTITION_EDGES = {
    # unsorted starts, positions outside every segment
    "admission_order": (20_000, [12_000, 0, 3000, 7000], [5000, 2500, 4000, 1]),
    # empty entries at 0 beside a real segment that starts at 0 (the grower's
    # slots with no split)
    "empty_at_0": (9000, [0, 0, 0, 6000, 0], [0, 4000, 0, 1000, 0]),
    # a round whose windows do not fit W passes every length as 0
    "all_empty": (5000, [0, 100, 3000, 0], [0, 0, 0, 0]),
    "one_covers_all": (70_001, [0], [70_001]),
    "one_position": (3000, [1500], [1]),
    # lengths kChunk - 1, kChunk, kChunk + 1, 2 kChunk; ends on chunk edges
    "chunk_edges": (32_768, [0, 4095, 8192, 16_384], [4095, 4096, 4097, 8192]),
    "below_one_chunk": (3000, [100, 0, 2000], [200, 50, 999]),
    "one_segment": (5000, [1000], [3321]),
    "twenty_segments": (50_000, list(range(0, 50_000, 2500)), [2400 - 97 * i for i in range(20)]),
}


def partition_edge(name, seed=0):
    """One PARTITION_EDGES geometry as numpy arrays: (order (N,) i32, a
    permutation; seg_start, seg_len (S,) i32; go (N,) bool, 40% left, with
    the second segment (where there is one) all left)."""
    n, start, length = PARTITION_EDGES[name]
    rng = np.random.RandomState(seed)
    order = rng.permutation(n).astype(np.int32)
    go = rng.rand(n) < 0.4
    if len(start) > 1:
        go[start[1]:start[1] + length[1]] = True
    return (order, np.asarray(start, np.int32), np.asarray(length, np.int32), go)


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
    return bound_of(nbytes, int(rows.numel()) * f * 3)


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


ATOMIC_OP = re.compile(r"\b((?:ATOMS|ATOMG|ATOM|RED)(?:\.[A-Z0-9_]+)*)(?![A-Z0-9_])")


def sass_atomics(so, nvcc_path):
    """Atomic instruction forms per kernel of a built library, counted in
    cuobjdump -sass: {kernel: {form: count}}; None where the toolkit has no
    cuobjdump.  Kernel names are demangled with cu++filt where it exists."""
    bindir = os.path.dirname(nvcc_path)
    tool = os.path.join(bindir, "cuobjdump")
    if not os.path.isfile(tool):
        return None
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {}
            continue
        m = ATOMIC_OP.search(line)
        if m and fn is not None:
            counts[fn][m.group(1)] = counts[fn].get(m.group(1), 0) + 1
    filt = os.path.join(bindir, "cu++filt")
    if counts and os.path.isfile(filt):
        names = list(counts)
        dm = subprocess.run([filt, *names], capture_output=True, text=True,
                            timeout=60).stdout.splitlines()
        if len(dm) == len(names):
            short = [d.replace("(anonymous namespace)::", "").split("(")[0]
                     .replace("void ", "").replace("lgbt::", "") for d in dm]
            counts = {k: counts[n] for k, n in zip(short, names)}
    return counts


def sass_summary(so, nvcc_path) -> str:
    """One line of ``sass_atomics``: each kernel's atomic forms and counts."""
    forms = sass_atomics(so, nvcc_path)
    if forms is None:
        return "not counted (no cuobjdump in the toolkit)"
    return "; ".join(f"{k}: " + ", ".join(f"{op} x{c}" for op, c in sorted(v.items()))
                     for k, v in sorted(forms.items()) if v)


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


def dev_us(e) -> float:
    """Device microseconds of a profiler event average."""
    for k in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, k):
            return float(getattr(e, k))
    return 0.0


def device_events(prof):
    """The profiler's device-side events (kernels, copies, sets), each once:
    host operators also carry the device time of what they launched."""
    return [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]


def model_sha(bst) -> str:
    """sha256 of a booster's model text: equal digests, equal trees."""
    return hashlib.sha256(bst.model_to_string().encode()).hexdigest()


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

    events = device_events(prof)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:5]
    return wall_ms, busy_ms, [(e.key[:60], dev_us(e) / 1e3, e.count) for e in top]



# ---------------------------------------------------------------------------
# phases 5-9: the windowed grower at Epsilon width
# ---------------------------------------------------------------------------
def epsilon_like(n: int, seed: int):
    """A seeded set of the shape of PASCAL "epsilon": 2000 dense
    standardized features, a balanced binary label from a noisy linear
    model plus pairwise interactions, 1% of the values missing."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, EPS_FEAT), dtype=np.float32)
    w = (rng.standard_normal(EPS_FEAT) * np.exp(-np.arange(EPS_FEAT) / 300.0)
         ).astype(np.float32)
    z = X @ w / np.sqrt(float((w * w).sum()))
    for a, b in ((0, 1), (2, 3), (10, 20), (30, 40)):
        z += 0.5 * X[:, a] * X[:, b]
    z += rng.standard_normal(n).astype(np.float32)
    y = (z > np.median(z)).astype(np.float64)
    X[rng.random((n, EPS_FEAT), dtype=np.float32) < 0.01] = np.nan
    return X, y


def split_case(bins, num_bins, T, seed, ragged=False):
    """One round's split geometry on the real bins: T segments tiling the
    rows (a tree a few rounds in), each split on a real feature at a seeded
    threshold; the windows are the small children.  ``ragged`` adds an
    empty segment, an all-left one and positions outside every segment."""
    from lightgbm_tpu_torch.ops.partition import segment_ids

    dev = bins.device
    n, f = bins.shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    cuts = torch.sort(torch.randperm(n - 1, generator=g)[:T - 1] + 1).values
    seg_start = torch.cat([torch.zeros(1, dtype=torch.int64), cuts])
    seg_len = torch.diff(torch.cat([seg_start, torch.tensor([n])]))
    if ragged:
        seg_len[1] = 0  # empty
        seg_len[-1] -= 17  # positions outside every segment
    seg_start, seg_len = seg_start.int().to(dev), seg_len.int().to(dev)
    order = torch.randperm(n, generator=g).int().to(dev)
    feats = torch.randint(0, f, (T,), generator=g).to(dev)
    thr = torch.randint(num_bins // 6, num_bins * 5 // 6, (T,), generator=g).to(dev)
    sid = segment_ids(seg_start, seg_len, n).long()
    col = bins[order.long(), feats[sid.clamp_min(0)]].int()
    go = col <= thr[sid.clamp_min(0)]
    if ragged:
        go[seg_start[2]:seg_start[2] + seg_len[2]] = True  # all left
    in_seg = sid >= 0
    n_left = torch.zeros(T + 1, dtype=torch.int64, device=dev).index_add_(
        0, sid + 1, (go & in_seg).long())[1:].int()
    small_left = (2 * n_left <= seg_len).int()
    return dict(order=order, go=go, seg_start=seg_start, seg_len=seg_len,
                n_left=n_left, small_left=small_left, sid=sid, in_seg=in_seg,
                win_start=torch.where(small_left > 0, seg_start, seg_start + n_left),
                win_cnt=torch.where(small_left > 0, n_left, seg_len - n_left))


def round_case(bins, grad, hess, nbpf, mbpf, num_bins, sp, shift):
    """The round kernel's arguments for split ``sp``: the segments' own
    histograms as parents (the histogram kernel on the permuted rows, with
    the tree's exponents) and the 2T children's sums in cand_tab (their
    outputs, row 3, come from ``with_outputs``)."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc

    dev = bins.device
    n, f = bins.shape
    T = sp["seg_start"].shape[0]
    sid, in_seg, go = sp["sid"], sp["in_seg"], sp["go"]
    rows = sp["order"].long()
    parent = hc.histogram_multi(bins.index_select(0, rows), grad[rows], hess[rows],
                                in_seg, torch.where(in_seg, sid, -1).int(), 0, T,
                                num_bins, shift=shift)
    ps = parent[:, :, 0].sum(2)  # (T, 3) totals from feature 0
    lsum = torch.zeros((T + 1, 3), dtype=torch.float64, device=dev).index_add_(
        0, torch.where(go & in_seg, sid + 1, 0),
        torch.stack([grad[rows], hess[rows], torch.ones_like(grad)], 1).double()
    )[1:].float()
    cand = torch.stack([torch.cat([lsum[:, i], ps[:, i] - lsum[:, i]])
                        for i in range(3)]
                       + [torch.zeros(2 * T, device=dev)]).contiguous()
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    fmask = torch.ones(f, dtype=torch.bool, device=dev)
    return (bins, sp["order"], go, grad, hess, mask, sp["seg_start"], sp["seg_len"],
            sp["n_left"], sp["win_start"], sp["win_cnt"], sp["small_left"], parent,
            cand, nbpf, mbpf, fmask)


def with_outputs(args, params):
    """The round's arguments with the children's leaf outputs under
    ``params`` in cand_tab row 3 (what path smoothing reads)."""
    from lightgbm_tpu_torch.ops.split import leaf_output

    cand = args[13].clone()
    cand[3] = leaf_output(cand[0], cand[1], params)
    return args[:13] + (cand,) + args[14:]


def same(a, b, what):
    """Bit-for-bit equality of a kernel's output and its plain version's."""
    if not torch.equal(a, b):
        d = float((a.double() - b.double()).abs().max()) if a.shape == b.shape else None
        raise AssertionError(f"{what}: kernel differs from its plain version, "
                             f"max|d| {d}")


def compare_round(kout, pout, what):
    """Round kernel against its plain version, bit for bit: the new order,
    the left/right histograms (same fixed point, same exponents) and the
    per-feature bests (the same float64 prefix sums rounded to f32, the same
    gain formulas op for op)."""
    for name, a, b in (("new order", kout[0], pout[0]), ("left", kout[1], pout[1]),
                       ("right", kout[2], pout[2])):
        same(a, b, f"round kernel ({what}): {name}")
    for name in kout[3]._fields:
        same(getattr(kout[3], name), getattr(pout[3], name),
             f"round kernel ({what}): per-feature {name}")


def bound_of(nbytes, ops):
    """The larger of bytes over the memory rate and operations over the f32
    rate, in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def partition_bytes(n, in_seg):
    """Bytes the partition must move: the row id (4 B) and go flag (1 B) of
    every in-segment position read and its row id written (4 B); every
    other position's row id read and written (8 B)."""
    return 9 * in_seg + 8 * (n - in_seg)


def device_window(fn, calls, marker):
    """The device events of a torch.profiler window over ``calls`` calls of
    ``fn`` (after one outside it), and the calls the profiler saw, counted
    by the events whose name holds one of ``marker`` (one a call).  The
    profiler can miss the first kernels of a window, all of them when the
    calls are short: a window in which it saw none is taken again, three
    windows at most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        seen = sum(e.count for e in events if any(m in e.key for m in marker))
        if seen:
            return events, seen
    raise AssertionError(f"the profiler saw no {marker} launch in three windows")


# the partition's last launch of a call: this kernel's, or a two-launch one's
PARTITION_MARKER = ("partition_kernel", "partition_move")


def partition_device_ms(fn, calls=100):
    """Device ms a call of the partition kernel: every device event of a
    profiler window (what the wrapper launches and the kernel's launches),
    summed and divided by the calls the profiler saw.  Returns (ms, calls
    seen)."""
    events, seen = device_window(fn, calls, PARTITION_MARKER)
    return sum(dev_us(e) for e in events) / seen / 1e3, seen


def launch_floor_ms(dev) -> float:
    """The floor of one launch from Python: a one-element torch elementwise
    op timed as the kernels are (cuda_ms)."""
    x = torch.zeros(1, device=dev)
    return cuda_ms(lambda: x.add_(1.0))


def round_bounds(args, W):
    """Least time of one round call on this run's data, for the whole call
    and for each of its phases.  Bytes: the partition's (``partition_bytes``);
    the window rows' order entries (4 B), their bins (F x 2 B) and
    grad, hess, mask in the 32-B sectors those rows touch, and the fresh
    sums written once (T x F x B x 20 B); the subtraction reads the fresh
    sums and the parents and writes left/right; the split search reads
    left/right and writes the per-feature bests (2T x F x 25 B).  The whole
    call counts the parents read and left/right written once.  Operations:
    three adds per window row and feature, and ~40 per (candidate, feature,
    bin) of the split search (two directions of leaf gains).  Returns
    ({phase: (ms, by)}, window rows)."""
    from lightgbm_tpu_torch.ops.round_cuda import window_rows
    from lightgbm_tpu_torch.ops.partition import segment_ids, stable_partition_ranges

    bins, order, go, _, _, _, seg_start, seg_len, _, win_start, win_cnt = args[:11]
    parent = args[12]
    n, f = bins.shape
    T, b = parent.shape[0], parent.shape[3]
    new_order, _ = stable_partition_ranges(order, segment_ids(seg_start, seg_len, n),
                                           seg_start, seg_len, go)
    rows, _, valid = window_rows(new_order, win_start, win_cnt, W)
    rows = rows[valid]
    part = partition_bytes(n, int(seg_len.sum()))
    window = (4 * rows.numel() + sector_bytes(rows, f * 2) + 2 * sector_bytes(rows, 4)
              + sector_bytes(rows, 1))
    hist = parent.numel() * 4  # one (T, 3, F, B) f32 array
    bests = 2 * T * f * 25
    window_ops = rows.numel() * f * 3
    split_ops = 2 * T * f * b * 40
    return dict(
        total=bound_of(part + window + 3 * hist + bests, window_ops + split_ops),
        partition=bound_of(part, 0),
        window=bound_of(window + T * f * b * 20, window_ops),
        subtract=bound_of(T * f * b * 20 + 3 * hist, 0),
        split=bound_of(2 * hist + bests, split_ops)), int(rows.numel())


ROUND_PHASES = (("partition", ("partition_",)), ("window", ("hist_kernel", "Memset")),
                ("subtract", ("subtract_kernel",)), ("split", ("gain_kernel",)))


def round_phases(rc, args, kw, calls=20):
    """Device ms a call of each phase of the round kernel, from a
    torch.profiler window over ``calls`` calls: the partition (B2's device
    code as one fused launch), the window pass (two memsets and the
    gather-mode histogram kernel), the subtraction and the split search;
    "other" holds what the wrapper launches around the kernel.  Sums are
    divided by the calls the profiler saw (its split-search launches, one a
    call), returned as "calls"."""
    events, seen = device_window(lambda: rc.round_megakernel(*args, **kw), calls,
                                 ("gain_kernel",))
    out = {name: 0.0 for name, _ in ROUND_PHASES}
    out["other"] = 0.0
    for e in events:
        name = next((n for n, keys in ROUND_PHASES if any(k in e.key for k in keys)), "other")
        out[name] += dev_us(e) / seen / 1e3
    out["calls"] = seen
    return out


def check_epsilon_kernels(ts, grad, hess, params, tile, tile_q):
    """Every kernel of the windowed path against its plain version, bit for
    bit, on the real Epsilon bins with the gradients of a model a few trees
    in: the root histogram pass (tile 1, the tree's exponents given
    explicitly); at the float leaf tile ``tile``, the partition, the
    three-pass float window pass and the round kernel under the training's
    split parameters and under all of L1, L2, max_delta_step, path
    smoothing and min_gain_to_split; at the int8 leaf tile ``tile_q``, the
    partition and the int8 window pass on the gathered window; and a
    ragged case (odd N, 257 features, an empty segment, an all-left one,
    positions outside every segment).  Times on the float-tile case; the
    root pass and the int8 window pass (the histogram kernel alone, on the
    gathered window) with their plain versions, index_add_ yardsticks and
    bounds; the round kernel's phases from a profiler window."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import partition_cuda as pc
    from lightgbm_tpu_torch.ops import round_cuda as rc
    from lightgbm_tpu_torch.ops.treegrow_fast import quantize_gradients
    from lightgbm_tpu_torch.ops.treegrow_windowed import _window_size

    bins, b = ts.bins_device, ts.max_num_bins
    nbpf, mbpf = ts.num_bins_pf_device, ts.missing_bin_pf_device
    n, f = bins.shape
    dev = bins.device
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    shift = hc.fixed_shift_pair(grad, hess)
    full = params._replace(lambda_l1=0.5, lambda_l2=2.0, max_delta_step=0.7,
                           path_smooth=3.0, min_gain_to_split=0.01)
    out = dict(T=tile, Tq=tile_q, shift=shift)

    # the root pass: tile 1, explicit exponents
    ra = (bins, grad, hess, mask, torch.zeros(n, dtype=torch.int32, device=dev),
          0, 1, b)
    same(hc.histogram_multi(*ra, shift=shift), hc.histogram_multi_plain(*ra, shift=shift),
         "root histogram pass (tile 1, explicit exponents)")
    out["root_ms"] = cuda_ms(lambda: hc.histogram_multi(*ra, shift=shift), iters=5,
                             warmup=1)
    out["root_plain_ms"] = cuda_ms(lambda: hc.histogram_multi_plain(*ra, shift=shift),
                                   iters=2, warmup=1)
    lib, rows = library_call(bins, (grad, hess), mask, ra[4], 0, 1, b, torch.float32)
    out["root_library_ms"] = cuda_ms(lib, iters=2, warmup=1)
    out["root_bound_ms"], out["root_bound_by"] = bound(n, f, 1, b, rows, 4, 4)
    del lib, rows
    torch.cuda.empty_cache()

    def partition(sp, what):
        a = (sp["order"], sp["seg_start"], sp["seg_len"], sp["go"])
        k, p = pc.partition_segments(*a), pc.partition_segments_plain(*a)
        same(k[0], p[0], f"partition ({what})")
        same(k[1], p[1], f"partition left counts ({what})")
        if not torch.equal(k[1], sp["n_left"]):
            raise AssertionError(f"partition ({what}): left counts disagree with the split")
        return a, k[0]

    # float leaf tile: partition, three-pass window pass, round kernel
    sp = split_case(bins, b, tile, SEED + 5)
    pa, new_order = partition(sp, f"T={tile}")
    W = _window_size(int(sp["win_cnt"].sum()), n)
    wa = (new_order, bins, (grad, hess), mask, sp["win_start"], sp["win_cnt"], W,
          tile, b)
    same(rc.window_histograms(hc.histogram_multi, *wa, shift=shift),
         rc.window_histograms(hc.histogram_multi_plain, *wa, shift=shift),
         f"float window pass (T={tile})")
    base = round_case(bins, grad, hess, nbpf, mbpf, b, sp, shift)
    for what, prm in (("training parameters", params), ("all options", full)):
        args = with_outputs(base, prm)
        kw = dict(params=prm, W=W, shift=shift)
        compare_round(rc.round_megakernel(*args, **kw),
                      rc.round_megakernel_plain(*args, **kw), what)
    args, kw = with_outputs(base, params), dict(params=params, W=W, shift=shift)
    out.update(W=W, in_seg=int(sp["seg_len"].sum()))
    out["part_ms"] = cuda_ms(lambda: pc.partition_segments(*pa))
    out["part_plain_ms"] = cuda_ms(lambda: pc.partition_segments_plain(*pa),
                                   iters=5, warmup=1)
    lib = library_partition(*pa)
    if not torch.equal(lib(), new_order):
        raise AssertionError("the stable-sort yardstick disagrees")
    out["part_library_ms"] = cuda_ms(lib)
    out["part_device_ms"], out["part_seen"] = partition_device_ms(
        lambda: pc.partition_segments(*pa))
    out["part_floor_ms"] = launch_floor_ms(dev)
    out["part_bound_ms"] = bound_of(partition_bytes(n, out["in_seg"]), 0)[0]
    out["round_ms"] = cuda_ms(lambda: rc.round_megakernel(*args, **kw), iters=10,
                              warmup=2)
    out["round_plain_ms"] = cuda_ms(lambda: rc.round_megakernel_plain(*args, **kw),
                                    iters=2, warmup=1)
    bounds, out["window_rows"] = round_bounds(args, W)
    out["round_bound_ms"], out["round_bound_by"] = bounds["total"]
    out["round_phases"] = round_phases(rc, args, kw)
    out["round_phase_bounds"] = bounds
    del base, args, wa
    torch.cuda.empty_cache()

    # int8 leaf tile: partition and the int8 window pass
    gq, hq = quantize_gradients(grad, hess, mask, 4, False, None)[:2]
    sq = split_case(bins, b, tile_q, SEED + 7)
    _, new_q = partition(sq, f"T={tile_q}")
    Wq = _window_size(int(sq["win_cnt"].sum()), n)
    qa = (new_q, bins, (gq, hq), mask, sq["win_start"], sq["win_cnt"], Wq, tile_q, b)
    same(rc.window_histograms(hc.histogram_multi_quantized, *qa),
         rc.window_histograms(hc.histogram_multi_quantized_plain, *qa),
         f"int8 window pass (T={tile_q})")
    out.update(Wq=Wq, int8_window_ms=cuda_ms(
        lambda: rc.window_histograms(hc.histogram_multi_quantized, *qa), iters=5,
        warmup=1))
    # the kernel alone, on the window gathered as the three-pass round does
    wrows, wslot, valid = rc.window_rows(new_q, sq["win_start"], sq["win_cnt"], Wq)
    ga = (bins.index_select(0, wrows), gq[wrows], hq[wrows], mask[wrows] & valid, wslot,
          0, tile_q, b)
    out["int8_hist_ms"] = cuda_ms(lambda: hc.histogram_multi_quantized(*ga), iters=5,
                                  warmup=1)
    out["int8_hist_plain_ms"] = cuda_ms(lambda: hc.histogram_multi_quantized_plain(*ga),
                                        iters=2, warmup=1)
    lib, rows = library_call(ga[0], ga[1:3], ga[3], ga[4], 0, tile_q, b, torch.int32)
    out["int8_hist_library_ms"] = cuda_ms(lib, iters=2, warmup=1)
    out["int8_hist_bound_ms"], out["int8_hist_bound_by"] = bound(Wq, f, tile_q, b, rows, 1, 4)
    del qa, ga, lib, rows
    torch.cuda.empty_cache()

    # the edge geometries of the partition, each against the plain version
    for name in PARTITION_EDGES:
        order, seg_start, seg_len, go = (torch.from_numpy(v).to(dev) for v in partition_edge(name))
        n_left = pc.partition_segments_plain(order, seg_start, seg_len, go)[1]
        partition(dict(order=order, seg_start=seg_start, seg_len=seg_len, go=go, n_left=n_left),
                  name)
    out["edges"] = len(PARTITION_EDGES)

    # ragged: partition and round kernel (all options)
    nr, nf = 100_003, 257
    rb = bins[:nr, :nf].contiguous()
    sr = split_case(rb, b, 6, SEED + 6, ragged=True)
    partition(sr, "ragged")
    Wr = _window_size(int(sr["win_cnt"].sum()), nr)
    args = with_outputs(round_case(rb, grad[:nr], hess[:nr], nbpf[:nf].contiguous(),
                                   mbpf[:nf].contiguous(), b, sr, shift), full)
    kw = dict(params=full, W=Wr, shift=shift)
    compare_round(rc.round_megakernel(*args, **kw), rc.round_megakernel_plain(*args, **kw),
                  "ragged")
    del args, rb
    torch.cuda.empty_cache()
    return out


def tree_stats(bst):
    s = bst._gbdt.windowed_stats
    rounds = sum(t["rounds"] for t in s)
    return dict(trees=len(s), rounds=rounds, retries=sum(t["retries"] for t in s),
                host_syncs=sum(t["host_syncs"] for t in s),
                resolves=sum(t["async_resolves"] for t in s),
                windows=sorted({w for t in s for w in t["windows"]}),
                megakernel=[t["megakernel"] for t in s],
                excluded=[t["megakernel_excluded"] for t in s])


def trees_agree(a, b) -> float:
    """Megakernel and three-pass trees: every node's feature, threshold and
    default direction and every leaf count equal; leaf values within 1e-5
    relative.  Returns the largest relative leaf-value gap."""
    worst = 0.0
    for i, (ta, tb) in enumerate(zip(a._gbdt.models, b._gbdt.models)):
        if ta.num_leaves != tb.num_leaves:
            raise AssertionError(f"tree {i}: {ta.num_leaves} vs {tb.num_leaves} leaves")
        for name in ("split_feature", "threshold_bin", "leaf_count"):
            if not np.array_equal(getattr(ta, name), getattr(tb, name)):
                raise AssertionError(f"tree {i}: {name} differs")
        if not np.array_equal(ta.default_left(), tb.default_left()):
            raise AssertionError(f"tree {i}: default_left differs")
        gap = np.abs(ta.leaf_value - tb.leaf_value) / (np.abs(tb.leaf_value) + 1e-12)
        worst = max(worst, float(gap.max()))
    if len(a._gbdt.models) != len(b._gbdt.models) or not worst <= 1e-5:
        raise AssertionError(f"leaf values differ by {worst} relative")
    return worst


# ---------------------------------------------------------------------------
# python3 chip_smoke.py --variants [CHECKOUT]: the design choices of the
# histogram, partition and round kernels timed against each other in turns,
# each a patched copy of csrc/ built beside the package's own (and, given
# another checkout of the repo, that checkout's wrappers and kernels as one
# more variant)
# ---------------------------------------------------------------------------
# The split search with its lanes over 32 bins at a time and a carry between
# steps: replaces round.cu's lane-run prefix, up to the per-bin evaluation.
GAIN_PER32 = """\
  double carry_g = 0.0, carry_h = 0.0, carry_c = 0.0;
  float best = -INFINITY, blg = 0.f, blh = 0.f, blc = 0.f;
  int bthr = INT_MAX;
  bool bleft = false;
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int b = b0 + lane;
    double xg = 0.0, xh = 0.0, xc = 0.0;
    if (b < B && b != mb) {
      xg = (double)hg[b];
      xh = (double)hh[b];
      xc = (double)hc[b];
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double yg = __shfl_up_sync(0xffffffffu, xg, o);
      const double yh = __shfl_up_sync(0xffffffffu, xh, o);
      const double yc = __shfl_up_sync(0xffffffffu, xc, o);
      if (lane >= o) {
        xg += yg;
        xh += yh;
        xc += yc;
      }
    }
    const double cg = carry_g + xg, chs = carry_h + xh, cc = carry_c + xc;
    carry_g = __shfl_sync(0xffffffffu, cg, 31);
    carry_h = __shfl_sync(0xffffffffu, chs, 31);
    carry_c = __shfl_sync(0xffffffffu, cc, 31);
    if (b >= B) continue;
"""

# name -> patches (file, old text or (start, end) of a span, new text)
VARIANTS = {
    "kept": [],
    "lookahead1": [("hist_common.cuh", "kLookahead = 4;", "kLookahead = 1;")],
    "lookahead8": [("hist_common.cuh", "kLookahead = 4;", "kLookahead = 8;")],
    "slots_max": [("hist_common.cuh", "for (int sb = 1; sb <= sb_max; ++sb)",
                   "for (int sb = sb_max; sb <= sb_max; ++sb)")],
    "waves2": [("hist_common.cuh", "wave = (int64_t)sms * occ;",
                "wave = (int64_t)sms * occ * 2;")],
    "gain_per32": [("round.cu", ("  const int K = (B + 31) / 32;",
                                 "    const float sg = (float)cg"), GAIN_PER32)],
}
# B2 as two cooperative launches, a count launch and a move launch (the
# move's chunks read their prefixes from the count launch's status words), in
# place of one launch with a grid-wide barrier between the two passes.
TWO_LAUNCH_KERNELS = """__global__ void __launch_bounds__(kBlock)
partition_count_kernel(PartitionArgs a) {
  __shared__ ChunkTable t;
  const unsigned epoch = begin_launch(a, t, true);
  partition_chunks<kCountMode>(a, t, epoch);
  finish_launch(a.scratch);
}

__global__ void __launch_bounds__(kBlock)
partition_move_kernel(PartitionArgs a) {
  __shared__ ChunkTable t;
  const unsigned epoch = begin_launch(a, t, false);
  partition_chunks<kMoveMode>(a, t, epoch);
  finish_launch(a.scratch);
}

// One wave of resident blocks of ``kernel``"""
TWO_LAUNCHES = """    return cudaErrorInvalidValue;
  if (!n_left_given) {
    const void* count = reinterpret_cast<const void*>(partition_count_kernel);
    const void* move = reinterpret_cast<const void*>(partition_move_kernel);
    void* args[] = {&a};
    int grid = 0;
    cudaError_t e = partition_grid(count, chunks_of(a.n) + a.S, &grid);
    if (e == cudaSuccess)
      e = cudaLaunchCooperativeKernel(count, dim3(grid), dim3(kBlock), args, 0, st);
    if (e == cudaSuccess) e = partition_grid(move, chunks_of(a.n) + 2 * (int64_t)a.S + 1, &grid);
    if (e == cudaSuccess)
      e = cudaLaunchCooperativeKernel(move, dim3(grid), dim3(kBlock), args, 0, st);
    return e;
  }
  const void* fn = n_left_given"""
VARIANTS["two_launches"] = [
    ("partition_common.cuh", "// One wave of resident blocks of ``kernel``", TWO_LAUNCH_KERNELS),
    ("partition_common.cuh", "    return cudaErrorInvalidValue;\n  const void* fn = n_left_given",
     TWO_LAUNCHES)]
# Chunks of 1024 and 2048 positions, 1 and 2 a thread (more chunks, fewer
# loads in flight a thread).
VARIANTS.update({f"items{k}": [("partition_common.cuh", "constexpr int kItems = 4;",
                                f"constexpr int kItems = {k};")] for k in (1, 2)})
# The order copied whole by the copy engine before the kernel, which then
# skips the gap chunks (the parent's way of keeping the other positions).
VARIANTS["memcpy"] = [
    ("partition_common.cuh",
     "  const int total = kMode == kCountMode ? n_seg : t.gap_first[a.S + 1];",
     "  const int total = n_seg;"),
    ("partition_common.cuh", "  void* args[] = {&a};\n",
     "  void* args[] = {&a};\n"
     "  e = cudaMemcpyAsync(a.out, a.order, (size_t)a.n * 4, cudaMemcpyDeviceToDevice, st);\n"
     "  if (e != cudaSuccess) return e;\n")]
# Timing only (wrong sums by design): skipping every cell of the flush
# leaves the rest of the call, so the kept time less this one's is the
# flush's share (its global atomics and the shared words' reset).
PROBES = {"no_flush": [("hist_common.cuh", "if (cnt == 0) continue;",
                        "if (cnt != 0xffffffffu) continue;")]}


def variant_sources(name, patches, csrc):
    """A copy of ``csrc`` under build/variants/<name> with ``patches``
    applied (each old text or span start must occur exactly once)."""
    from lightgbm_tpu_torch.ops import cuda_build

    d = cuda_build.BUILD_DIR / "variants" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    for fname, old, new in patches:
        path = d / fname
        text = path.read_text()
        first = old[0] if isinstance(old, tuple) else old
        if text.count(first) != 1:
            raise AssertionError(f"variant {name}: {first!r} is not in {fname} once")
        i = text.index(first)
        j = text.index(old[1], i) if isinstance(old, tuple) else i + len(old)
        path.write_text(text[:i] + new + text[j:])
    return d


def ptxas_summary(log_text):
    """Registers and spill bytes of each kernel in an nvcc -Xptxas -v log."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log_text)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log_text)]
    return f"registers {regs} spill bytes {sum(spills)}"


def load_checkout(root):
    """Another checkout's lightgbm_tpu_torch, imported beside this one as
    the package ``checkout_lgt``: its (hist_cuda, partition_cuda,
    round_cuda), whose wrappers call its own kernels (built into the
    checkout's build/), so a checkout whose C interfaces differ is timed
    through its own wrappers."""
    import importlib
    import importlib.util

    pkg = Path(root).resolve() / "lightgbm_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "checkout_lgt", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    sys.modules["checkout_lgt"] = mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"checkout_lgt.ops.{m}")
                 for m in ("hist_cuda", "partition_cuda", "round_cuda"))


def variants(parent) -> int:
    """Every variant's histogram, partition and round libraries, built at
    once (a variant that nvcc refuses is reported and left out); then, in
    turns (each variant once forward, once in reverse order), each held bit
    for bit against the plain versions and timed with CUDA events: B1 at
    the phase 2 shapes (1M x 28, float tile 8, int8 tile 20), the Epsilon
    root pass (400k x 2000, tile 1), the int8 window pass on a gathered T =
    20 window, B2 at phase 7's geometry (T = 10 and T = 20 segments tiling
    400k positions) and on one chunk (N = 3000, its fixed cost) with its
    device time from a profiler window, and B3 at
    phase 7's geometry (T = 10, W = 131,072) with its phases from a
    profiler window; beside them the floor of one launch from Python.  Then
    two probes of the kept kernels: the flush's share of each call
    (PROBES), and the root pass on bins that put a warp's atomics on 32
    banks or on one.  Bins are seeded random (no binning), so each
    segment's go flags come from a seeded threshold on a random bin, as
    phase 7's do from the real bins."""
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import partition_cuda as pc
    from lightgbm_tpu_torch.ops import round_cuda as rc
    from lightgbm_tpu_torch.ops.split import SplitParams
    from lightgbm_tpu_torch.ops.treegrow_windowed import _window_size

    dev = torch.device("cuda", 0)
    mods = (hc, pc, rc)
    n_base = len(cuda_build.NVCC_FLAGS)
    trios = {}
    for name, patches in {**VARIANTS, **PROBES}.items():
        d = variant_sources(name, patches, cuda_build.CSRC)
        trios[name] = tuple(cuda_build.KernelLibrary(str(d / m.LIBRARY.src.name), m._bind,
                                                     m.LIBRARY.flags[n_base:]) for m in mods)
    checkout = load_checkout(parent) if parent else None
    if checkout:
        trios["checkout"] = tuple(m.LIBRARY for m in checkout)
    # variants that patch one file share the others' libraries: build each once
    built = {lib.target(): lib for trio in trios.values() for lib in trio}
    t0 = time.perf_counter()
    procs = {so: lib.start(force=True) for so, lib in built.items()}
    refused = set()
    for so, lib in built.items():
        try:
            lib.finish(procs[so])
        except RuntimeError as e:
            log(f"variant library {so.name} not built: {e}")
            refused.add(so)
    trios = {name: trio for name, trio in trios.items()
             if not any(lib.target() in refused for lib in trio)}
    log(f"variants built: {len(built) - len(refused)} libraries in "
        f"{time.perf_counter() - t0:.2f} s; timed: {' '.join(trios)}")
    for name, trio in trios.items():
        for lib in trio:
            so = lib.target()
            log(f"variant {name} {lib.src.name}: {ptxas_summary(built[so].log)}; sass "
                f"atomics {sass_summary(so, cuda_build.nvcc())}")

    def use(name):
        """The (hist, partition, round) modules that run variant ``name``."""
        if name == "checkout":
            return checkout
        hc.LIBRARY, pc.LIBRARY, rc.LIBRARY = trios[name]
        return mods

    bins, grad, hess, mask, slot, gq, hq = kernel_inputs(N_TRAIN, N_FEAT, MAX_BIN, 20, 0, 1,
                                                         dev)
    hf = (bins, grad, hess, mask, slot, 0, 8, MAX_BIN)
    hqa = (bins, gq, hq, mask, slot, 0, 20, MAX_BIN)
    n, f = EPS_N_TRAIN, EPS_FEAT
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    ebins = torch.randint(0, MAX_BIN, (n, f), generator=g, device=dev, dtype=torch.int16)
    eg = torch.randn(n, generator=g, device=dev) * 0.3
    eh = torch.rand(n, generator=g, device=dev) * 0.25
    emask = torch.ones(n, dtype=torch.bool, device=dev)
    shift = hc.fixed_shift_pair(eg, eh)
    ra = (ebins, eg, eh, emask, torch.zeros(n, dtype=torch.int32, device=dev), 0, 1, MAX_BIN)
    nbpf = torch.full((f,), MAX_BIN, dtype=torch.int32, device=dev)
    mbpf = torch.full((f,), -1, dtype=torch.int32, device=dev)
    mbpf[::3] = MAX_BIN - 1
    prm = SplitParams(min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3)
    sp = split_case(ebins, MAX_BIN, 10, SEED + 5)
    W = _window_size(int(sp["win_cnt"].sum()), n)
    args = with_outputs(round_case(ebins, eg, eh, nbpf, mbpf, MAX_BIN, sp, shift), prm)
    kw = dict(params=prm, W=W, shift=shift)
    gqe = torch.randint(-8, 9, (n,), generator=g, device=dev, dtype=torch.int8)
    hqe = torch.randint(0, 17, (n,), generator=g, device=dev, dtype=torch.int8)
    sq = split_case(ebins, MAX_BIN, 20, SEED + 7)
    pa10 = (sp["order"], sp["seg_start"], sp["seg_len"], sp["go"])
    pa20 = (sq["order"], sq["seg_start"], sq["seg_len"], sq["go"])
    pa_tiny = tuple(torch.from_numpy(v).to(dev) for v in partition_edge("below_one_chunk"))
    new_q = pc.partition_segments_plain(*pa20)[0]
    Wq = _window_size(int(sq["win_cnt"].sum()), n)
    wrows, wslot, valid = rc.window_rows(new_q, sq["win_start"], sq["win_cnt"], Wq)
    ga = (ebins.index_select(0, wrows), gqe[wrows], hqe[wrows], emask[wrows] & valid, wslot,
          0, 20, MAX_BIN)
    # the variants with fewer positions a thread need more status words than
    # the kept chunk size allocates: grow the shared scratch once for them
    pc.scratch(dev, torch.cuda.current_stream(dev).cuda_stream, n * pc.CHUNK // 1024, 20)
    want = dict(higgs_f=hc.histogram_multi_plain(*hf),
                higgs_q=hc.histogram_multi_quantized_plain(*hqa),
                root=hc.histogram_multi_plain(*ra, shift=shift),
                int8_win=hc.histogram_multi_quantized_plain(*ga),
                round=rc.round_megakernel_plain(*args, **kw),
                part10=pc.partition_segments_plain(*pa10),
                part20=pc.partition_segments_plain(*pa20),
                part_tiny=pc.partition_segments_plain(*pa_tiny))
    log(f"variants inputs: round T=10 W={W} window rows {int(sp['win_cnt'].sum())}; "
        f"int8 window T=20 W={Wq}; partition N={n} T=10 and T=20, and N=3000 (one chunk)")

    def calls(mh, mp, mr):
        return dict(higgs_f=lambda: mh.histogram_multi(*hf),
                    higgs_q=lambda: mh.histogram_multi_quantized(*hqa),
                    root=lambda: mh.histogram_multi(*ra, shift=shift),
                    int8_win=lambda: mh.histogram_multi_quantized(*ga),
                    round=lambda: mr.round_megakernel(*args, **kw),
                    part10=lambda: mp.partition_segments(*pa10),
                    part20=lambda: mp.partition_segments(*pa20),
                    part_tiny=lambda: mp.partition_segments(*pa_tiny))

    def iters(k):
        return 20 if k.startswith(("higgs", "part")) else 5

    turns = [name for name in trios if name not in PROBES]
    times = {name: [] for name in turns}
    for name in turns + turns[::-1]:
        trio = use(name)
        fns = calls(*trio)
        for k, fn in fns.items():
            if k == "round":
                compare_round(fn(), want[k], f"variant {name}")
            elif k.startswith("part"):
                got = fn()
                same(got[0], want[k][0], f"variant {name} {k} order")
                same(got[1], want[k][1], f"variant {name} {k} left counts")
            else:
                same(fn(), want[k], f"variant {name} {k}")
        t = {k: cuda_ms(fn, iters=iters(k), warmup=2) for k, fn in fns.items()}
        for k in ("part10", "part20", "part_tiny"):
            t[f"{k}_device"], t[f"{k}_seen"] = partition_device_ms(fns[k])
        t["floor"] = launch_floor_ms(dev)
        ph = round_phases(trio[2], args, kw)
        t["round_partition"] = ph["partition"]
        t["round_phases"] = ph
        times[name].append(t)
        log(f"variant {name} turn {len(times[name])}: bitwise_plain=True ms "
            + json.dumps(t))
    for name, ts in times.items():
        log(f"variant {name} mean of {len(ts)} turns: " + json.dumps(
            {k: sum(t[k] for t in ts) / len(ts) for k in ts[0] if k != "round_phases"}))
    flush = {"kept": [], "no_flush": []}
    for name in ("kept", "no_flush", "no_flush", "kept"):
        fns = {k: fn for k, fn in calls(*use(name)).items() if not k.startswith("part")}
        flush[name].append({k: cuda_ms(fn, iters=iters(k), warmup=2) for k, fn in fns.items()})
    mean = {name: {k: sum(t[k] for t in ts) / len(ts) for k in ts[0]}
            for name, ts in flush.items()}
    log("flush probe ms: " + json.dumps(mean) + " flush share: " + json.dumps(
        {k: 1 - mean["no_flush"][k] / mean["kept"][k] for k in mean["kept"]}))
    # Bank probe: the kept root pass on bins laid out so that a warp's lanes
    # (consecutive features of one row, cells bin_stride(B) = 255 apart, so
    # bank = bin - feature mod 32) hit 32 different banks (bin = 2f + r), or
    # one bank (bin = f + r), against the seeded random bins above.
    use("kept")
    fr = (torch.arange(f, device=dev)[None, :], torch.arange(n, device=dev)[:, None])
    probe = {"random": ebins}
    for name, k in (("32_banks", 2), ("one_bank", 1)):
        probe[name] = ((k * fr[0] + fr[1]) % MAX_BIN).to(torch.int16)
    ms = {}
    for name, pb in probe.items():
        pa = (pb,) + ra[1:]
        same(hc.histogram_multi(*pa, shift=shift), hc.histogram_multi_plain(*pa, shift=shift),
             f"bank probe {name}")
        ms[name] = cuda_ms(lambda: hc.histogram_multi(*pa, shift=shift), iters=5, warmup=2)
    log("bank probe, root pass ms: " + json.dumps(ms))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip())
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--variants"]:
        return variants(sys.argv[2] if len(sys.argv) > 2 else None)
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import partition_cuda as pc
    from lightgbm_tpu_torch.ops import round_cuda as rc

    if "jax" in sys.modules or "lightgbm_tpu" in sys.modules:
        raise AssertionError("the port pulled in JAX or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    kind = torch.cuda.get_device_name(0)

    # ---- 1. build ----
    t0 = time.perf_counter()
    libs = (hc.LIBRARY, pc.LIBRARY, rc.LIBRARY)
    sos = cuda_build.build_all(libs, force=True)
    for lib in libs:
        lib.lib()
        for line in lib.log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "Compiling entry")):
                log(f"ptxas {lib.src.name}: " + line.strip())
    for so in sos:
        log(f"phase 1 sass {so.name}: {sass_summary(so, cuda_build.nvcc())}")
    log(f"phase 1 build: ok {' '.join(so.name for so in sos)} in "
        f"{time.perf_counter() - t0:.2f} s")

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
        f"model_sha256={model_sha(bst)} in {time.perf_counter() - t0:.2f} s")
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
        f"small-vs-cpu max|d|={small_err_q:.3g} model_sha256={model_sha(bst_q)} "
        f"in {time.perf_counter() - t0:.2f} s")

    # ---- 5. the Epsilon-shaped set ----
    t0 = time.perf_counter()
    X, y = epsilon_like(EPS_N_TRAIN + EPS_N_TEST, SEED + 2)
    Xtr, ytr, Xte, yte = (X[:EPS_N_TRAIN], y[:EPS_N_TRAIN], X[EPS_N_TRAIN:],
                          y[EPS_N_TRAIN:])
    t_gen = time.perf_counter() - t0
    eps = {"objective": "binary", "max_bin": MAX_BIN, "num_leaves": EPS_LEAVES,
           "learning_rate": 0.1, "device_type": "cuda", "verbosity": -1, "seed": 7,
           "windowed_growth": True, "bin_construct_sample_cnt": EPS_BIN_SAMPLE}
    eps_set = lgt.Dataset(Xtr, label=ytr, params=dict(eps))
    eps_set.construct()
    tile_w = hc.recommended_leaf_tile(eps_set.max_num_bins, EPS_FEAT, EPS_LEAVES)
    tile_wq = hc.recommended_leaf_tile(eps_set.max_num_bins, EPS_FEAT, EPS_LEAVES,
                                       quantized=True)
    log(f"phase 5 epsilon data: {EPS_N_TRAIN}+{EPS_N_TEST} rows x {EPS_FEAT}, "
        f"{eps_set.max_num_bins} bins max, generated in {t_gen:.2f} s, binned in "
        f"{time.perf_counter() - t0 - t_gen:.2f} s; leaf tile {tile_w} float, "
        f"{tile_wq} int8")

    counted = (hc, pc, rc)

    def reset():
        for m in counted:
            m.reset_counts()

    def plain_total():
        return sum(sum(m.plain_calls.values()) for m in counted)

    def counts():
        """Launches of (B1 float, B1 int8, B2, B3) since the last reset."""
        return (hc.launches["histogram_multi"], hc.launches["histogram_multi_quantized"],
                pc.launches["partition_segments"], rc.launches["round_megakernel"])

    # ---- 6. windowed training, float: the round megakernel ----
    t0 = time.perf_counter()
    reset()
    bst_w, it_w = train_timed(lgt, eps, eps_set, EPS_ROUNDS_FLOAT)
    torch.cuda.synchronize()
    st_w = tree_stats(bst_w)
    b1_w, b1q_w, part_launches_float, mk_launches = counts()
    if not (all(st_w["megakernel"]) and mk_launches == st_w["rounds"]
            and part_launches_float == 0 and b1q_w == 0
            and b1_w == st_w["trees"] == EPS_ROUNDS_FLOAT and plain_total() == 0
            and st_w["host_syncs"] == st_w["trees"]):
        raise AssertionError(f"windowed float run: {st_w} launches (B1 float, B1 "
                             f"int8, B2, B3) {counts()} plain "
                             f"{[m.plain_calls for m in counted]}")
    pw = bst_w.predict(Xte)
    if pw.shape != (EPS_N_TEST,) or not np.all(np.isfinite(pw)):
        raise AssertionError("windowed predictions are not finite (N,) values")
    a_w = auc(yte, pw)
    if not a_w >= AUC_FLOOR_EPS:
        raise AssertionError(f"windowed held-out AUC {a_w:.5f} < floor {AUC_FLOOR_EPS}")
    if not np.array_equal(pw, lgt.Booster(model_str=bst_w.model_to_string()).predict(Xte)):
        raise AssertionError("reloaded windowed model predicts differently")
    log(f"phase 6 windowed float: ok {EPS_ROUNDS_FLOAT} rounds it/s={it_w:.4f} "
        f"auc={a_w:.5f} (floor {AUC_FLOOR_EPS}) tree-rounds={st_w['rounds']} "
        f"round-kernel launches={mk_launches} "
        f"({mk_launches / st_w['rounds']:.2f}/tree-round) float histogram "
        f"launches={b1_w} (the root pass, 1/tree) partition launches=0 "
        f"plain_calls=0 retries={st_w['retries']} windows={st_w['windows']} "
        f"blocking host reads/tree={st_w['host_syncs'] / st_w['trees']:.2f} "
        f"(the exponents, before round 1) async resolves={st_w['resolves']} "
        f"reload=bitwise model_sha256={model_sha(bst_w)} "
        f"in {time.perf_counter() - t0:.2f} s")
    wall_ms, busy_ms, top = profile_rounds(lgt, eps, eps_set, 2)
    if busy_ms > 0:
        log(f"phase 6 profile (2 trees after a warm one): wall_ms={wall_ms:.2f} "
            f"device_busy_ms={busy_ms:.2f} idle_share={1 - busy_ms / wall_ms:.4f} top: "
            + "; ".join(f"{k} {ms:.3f} ms x{c}" for k, ms, c in top))
    else:
        log(f"phase 6 profile: wall_ms={wall_ms:.2f}, device time not measured "
            "(the profiler saw no device activity)")

    # ---- 7. the windowed path's kernels vs plain versions ----
    t0 = time.perf_counter()
    gb = bst_w._gbdt  # gradients of the model 5 trees in
    g_eps, h_eps = (v.contiguous() for v in gb.objective.get_gradients(
        gb._score, gb._label, gb._weight))
    ek = r = check_epsilon_kernels(eps_set, g_eps, h_eps, gb._split_params, tile_w,
                                   tile_wq)
    log(f"phase 7 kernel histogram: root pass N={EPS_N_TRAIN} F={EPS_FEAT} tile 1 "
        f"explicit exponents {r['shift']} ms={r['root_ms']:.4f} "
        f"plain_ms={r['root_plain_ms']:.4f} library_ms={r['root_library_ms']:.4f} "
        f"bound_ms={r['root_bound_ms']:.4f} ({r['root_bound_by']}) bitwise_plain=True; "
        f"float window pass T={r['T']} W={r['W']} bitwise_plain=True; int8 window "
        f"pass T={r['Tq']} W={r['Wq']} ms={r['int8_window_ms']:.4f} (gather included), "
        f"kernel alone ms={r['int8_hist_ms']:.4f} plain_ms={r['int8_hist_plain_ms']:.4f} "
        f"library_ms={r['int8_hist_library_ms']:.4f} bound_ms={r['int8_hist_bound_ms']:.4f} "
        f"({r['int8_hist_bound_by']}) bitwise_plain=True")
    log(f"phase 7 kernel partition: N={EPS_N_TRAIN} T={r['T']} in-segment={r['in_seg']} "
        f"ms={r['part_ms']:.4f} (events, a Python call) device_ms={r['part_device_ms']:.4f} "
        f"(torch.profiler, {r['part_seen']} calls seen) floor_ms={r['part_floor_ms']:.4f} "
        f"(one launch from Python) plain_ms={r['part_plain_ms']:.4f} "
        f"library_ms={r['part_library_ms']:.4f} bound_ms={r['part_bound_ms']:.6f} "
        f"(bytes) bitwise_plain=True (T={r['Tq']}, ragged and {r['edges']} edge geometries "
        f"too)")
    log(f"phase 7 kernel round: N={EPS_N_TRAIN} F={EPS_FEAT} B={eps_set.max_num_bins} "
        f"T={r['T']} W={r['W']} window_rows={r['window_rows']} ms={r['round_ms']:.4f} "
        f"plain_ms={r['round_plain_ms']:.4f} bound_ms={r['round_bound_ms']:.4f} "
        f"({r['round_bound_by']}) order, left/right and per-feature bests bitwise "
        f"(training parameters, all split options, ragged) "
        f"in {time.perf_counter() - t0:.2f} s")
    ph, pb = r["round_phases"], r["round_phase_bounds"]
    seen = ph.pop("calls")
    log(f"phase 7 kernel round phases (torch.profiler, {seen} calls seen, ms a call): "
        + "; ".join(f"{k} {ph[k]:.4f} (bound {pb[k][0]:.4f}, {pb[k][1]})"
                    for k, _ in ROUND_PHASES)
        + f"; other {ph['other']:.4f}; sum {sum(ph.values()):.4f}")
    del gb, g_eps, h_eps
    torch.cuda.empty_cache()

    # ---- 8. windowed training, int8: the three-pass round ----
    t0 = time.perf_counter()
    eps_q = {**eps, "use_quantized_grad": True}
    reset()
    bst_q8, it_q8 = train_timed(lgt, eps_q, eps_set, EPS_ROUNDS_INT8)
    torch.cuda.synchronize()
    st_q = tree_stats(bst_q8)
    l_q = counts()
    _, i8_launches, part_launches, _ = l_q
    if not (l_q == (0, st_q["rounds"] + st_q["trees"], st_q["rounds"], 0)
            and plain_total() == 0 and st_q["host_syncs"] == st_q["trees"]
            and st_q["excluded"] == ["quantized"] * EPS_ROUNDS_INT8):
        raise AssertionError(f"windowed int8 run: {st_q} launches (B1 float, B1 int8, "
                             f"B2, B3) {l_q}")
    a_q8 = auc(yte, bst_q8.predict(Xte))
    if not a_q8 >= AUC_FLOOR_EPS_INT8:
        raise AssertionError(f"windowed int8 AUC {a_q8:.5f} < floor {AUC_FLOOR_EPS_INT8}")
    log(f"phase 8 windowed int8: ok {EPS_ROUNDS_INT8} rounds it/s={it_q8:.4f} "
        f"auc={a_q8:.5f} (floor {AUC_FLOOR_EPS_INT8}) tree-rounds={st_q['rounds']} "
        f"partition launches={part_launches} int8 histogram launches={i8_launches} "
        f"(window passes + roots) round-kernel launches=0 megakernel excluded: "
        f"quantized retries={st_q['retries']} model_sha256={model_sha(bst_q8)} "
        f"in {time.perf_counter() - t0:.2f} s")

    # ---- 9. megakernel against the three-pass round ----
    t0 = time.perf_counter()
    small = lgt.Dataset(Xtr[:EPS_PARITY_ROWS], label=ytr[:EPS_PARITY_ROWS],
                        params=dict(eps), reference=eps_set)
    small.construct()
    reset()
    b_mk = lgt.train(eps, small, 2)
    torch.cuda.synchronize()
    st_mk, l_mk = tree_stats(b_mk), counts()
    if not (all(st_mk["megakernel"]) and plain_total() == 0
            and l_mk == (st_mk["trees"], 0, 0, st_mk["rounds"])):
        raise AssertionError(f"parity, megakernel: {st_mk} launches {l_mk}")
    reset()
    b_3p = lgt.train({**eps, "megakernel": "0"}, small, 2)
    torch.cuda.synchronize()
    st_3p, l_3p = tree_stats(b_3p), counts()
    if not (not any(st_3p["megakernel"]) and plain_total() == 0
            and l_3p == (st_3p["rounds"] + st_3p["trees"], 0, st_3p["rounds"], 0)):
        raise AssertionError(f"parity, three-pass: {st_3p} launches (B1 float, B1 "
                             f"int8, B2, B3) {l_3p} plain "
                             f"{[m.plain_calls for m in counted]}")
    gap = trees_agree(b_mk, b_3p)
    log(f"phase 9 megakernel vs three-pass: ok {EPS_PARITY_ROWS} rows, 2 trees, "
        f"nodes equal, leaf counts equal, leaf values max rel gap {gap:.3g}; "
        f"launches (B1 float, B1 int8, B2, B3) megakernel {l_mk}, three-pass {l_3p} "
        f"over {st_mk['rounds']} / {st_3p['rounds']} tree-rounds, plain_calls=0 "
        f"in {time.perf_counter() - t0:.2f} s")

    # ---- 10. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise AssertionError(f"nvidia-smi failed: {smi.stderr}")
    log(f"phase 10 device: ok total {time.perf_counter() - t_all:.2f} s")
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
    r = ek
    for name, pre, launches in (
            ("histogram_multi_epsilon_root", "root", b1_w),
            ("histogram_multi_quantized_epsilon_window", "int8_hist",
             i8_launches - st_q["trees"])):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches, "max_abs_err": 0.0, "ms": r[f"{pre}_ms"],
            "plain_ms": r[f"{pre}_plain_ms"], "bound_ms": r[f"{pre}_bound_ms"],
            "bound_by": r[f"{pre}_bound_by"], "library_ms": r[f"{pre}_library_ms"]})
    kernels.append({
        "name": "partition_segments", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/partition.cu",
        "replaces": "lightgbm_tpu/ops/partition_pallas.py:188",
        "launches": part_launches, "max_abs_err": 0.0, "ms": r["part_ms"],
        "plain_ms": r["part_plain_ms"], "bound_ms": r["part_bound_ms"],
        "bound_by": "bytes", "library_ms": r["part_library_ms"],
        "device_ms": r["part_device_ms"], "floor_ms": r["part_floor_ms"]})
    kernels.append({
        "name": "round_megakernel", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/round.cu",
        "replaces": "lightgbm_tpu/ops/round_pallas.py:107",
        "launches": mk_launches,
        "max_abs_err": 0.0,
        "ms": r["round_ms"], "plain_ms": r["round_plain_ms"],
        "bound_ms": r["round_bound_ms"], "bound_by": r["round_bound_by"],
        "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
