"""Multi-process training launcher (the Dask-orchestration analogue).

Counterpart of lightgbm_tpu/parallel/launcher.py
(reference: python-package/lightgbm/dask.py: align partitions to workers,
find open ports, build the ``machines`` list, inject num_machines /
local_listen_port / tree_learner, run plain ``train`` on every worker,
return the rank-0 model).

Workers are local processes running ``_WORKER_SRC``, which imports only
this package: each builds its Dataset from ONLY its row shard (consecutive
blocks in rank order, no padding: ``pre_partition``, the bin boundaries
from the serial run's sample, basic.py::_sync_binning_sample; with
tree_learner=feature every rank gets all rows; with tree_learner=feature2d
the ranks of one row block of the 2-D mesh get that block), brings up the
process group (parallel/distributed.py) and calls ``lightgbm_tpu_torch.train``.  Every rank
ends with the same model; rank 0's is returned.  Eval sets are sharded the
same way and their metrics are evaluated over every rank's rows
(models/gbdt.py::_eval_at_synced), so early stopping fires on every rank
alike.

Workers are watched (``_watch_workers``): a worker that exits non-zero
fails the launch within a poll with its log tail, a worker whose heartbeat
(the metrics snapshot's ``heartbeat_ts``) stops changing for
``heartbeat_timeout_s`` is killed as hung, a launch past ``timeout_s``
kills them all; each raises ``WorkerFailure`` and no worker outlives it.
The workers' events, metrics snapshots and traces are merged into the
launch directory (``fleet_events.jsonl``, ``fleet_metrics.json``,
``fleet_trace.json``) on every exit path.

Recovery (the JAX package's): ``max_restarts`` relaunches the whole fleet
on fresh ports after a failure, with exponential backoff.  With
``snapshot_freq`` > 0 the fleet keeps coordinated checkpoints (the
worker's callback: rank 0 writes the snapshot and the manifest, every
other rank its acknowledgement, utils/checkpoint.py), and a relaunch
resumes every rank from the newest fleet-valid manifest
(``LGBMTPU_RESUME_MANIFEST``, engine.train's ``resume=<manifest>``): the
final model is the uninterrupted run's bit for bit.  ``num_slices`` > 1
makes each slice its own world training the shared shard plan; a rank's
failure kills and respawns only its slice, from the newest slice-valid
round (``LGBMTPU_RESUME_EXCLUDE_RANKS``), while the other slices run on;
the slow-rank check compares heartbeats inside a slice.

``run_spmd`` runs a script on R ranks of a gloo (or NCCL) process group
under the same watchdog: the tests' way to run the sharded growers.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import _ALIASES, Config
from ..obs import metrics as _obs
from ..obs import trace as _trace
from ..utils import checkpoint as _checkpoint
from ..utils.log import log_warning

_WORKER_SRC = r"""
import os, sys, json
sys.path.insert(0, os.environ["LGBM_TPU_REPO"])
import numpy as np

shard = np.load(os.environ["LGBM_TPU_SHARD"], allow_pickle=True)
net = {k: shard[k].item() for k in ("num_machines", "machines",
                                    "local_listen_port", "time_out")}
# the rendezvous rank is slice-local; the worker id is fleet-global (model
# outputs, acks and shard fingerprints key on it)
wid = os.environ.get("LGBM_TPU_WORKER_ID", os.environ["LIGHTGBM_TPU_RANK"])

from lightgbm_tpu_torch.obs import metrics as _obs_metrics

_snap_path = os.environ.get("LGBMTPU_METRICS_SNAPSHOT_FILE")
if _snap_path:
    _obs_metrics.start_periodic_snapshots(
        _snap_path,
        float(os.environ.get("LGBMTPU_METRICS_SNAPSHOT_PERIOD_S", "1.0")))

import lightgbm_tpu_torch as lgb

params = dict(np.load(os.environ["LGBM_TPU_PARAMS"], allow_pickle=True)[
    "params"].item())
params.update(net)
params.setdefault("tree_learner", "data")
params["pre_partition"] = (int(net["num_machines"]) > 1
                           and params["tree_learner"] != "feature")
if str(params.get("device_type", "")).lower() == "cpu":
    # the ranks share the host's cores
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(net["num_machines"])))
_cache = os.environ.get("LGBM_TPU_CACHE")
if _cache:
    _lo, _hi = (int(t) for t in os.environ["LGBM_TPU_CACHE_SHARD"].split(","))
    ds = lgb.Dataset(_cache, params=dict(params, bin_cache_shard=(_lo, _hi)))
else:
    ds = lgb.Dataset(
        shard["X"], label=shard["y"],
        weight=(shard["w"] if shard["w"].size > 0 else None),
        group=(shard["g"] if shard["g"].size > 0 else None), params=params)
valid_sets, valid_names = [], []
for i in range(int(shard["n_eval"].item())):
    valid_sets.append(lgb.Dataset(
        shard[f"ev{i}_X"], label=shard[f"ev{i}_y"],
        weight=(shard[f"ev{i}_w"] if shard[f"ev{i}_w"].size > 0 else None),
        group=(shard[f"ev{i}_g"] if shard[f"ev{i}_g"].size > 0 else None),
        reference=ds))
    valid_names.append(str(shard[f"ev{i}_name"].item()))
callbacks = []
evals_result = {}
es_rounds = int(os.environ.get("LGBM_TPU_ES_ROUNDS", "0"))
if es_rounds > 0 and valid_sets:
    callbacks.append(lgb.early_stopping(es_rounds, verbose=False))
if valid_sets:
    callbacks.append(lgb.record_evaluation(evals_result))
if os.environ.get("LGBMTPU_FAULT"):
    # worker_death injection site (utils/faults.py): a rank-gated hard exit
    # at the start of a chosen iteration, what the watchdog must catch
    from lightgbm_tpu_torch.utils import faults as _faults

    def _fault_cb(env):
        _faults.maybe_crash("worker_death", env.iteration + 1)
        _faults.maybe_hang("worker_hang", env.iteration + 1)
    _fault_cb.before_iteration = True
    _fault_cb.order = -100
    callbacks.append(_fault_cb)
_ckpt_dir = os.environ.get("LGBMTPU_FLEET_CKPT_DIR")
_ckpt_freq = int(os.environ.get("LGBMTPU_FLEET_SNAPSHOT_FREQ", "0") or 0)
if _ckpt_dir and _ckpt_freq > 0:
    # coordinated fleet checkpoints: every _ckpt_freq global iterations rank
    # 0 writes the snapshot and the manifest, every other rank its ack; a
    # round is resumable only once every rank confirmed it
    from lightgbm_tpu_torch.utils import checkpoint as _ckpt

    _world = int(os.environ.get("LGBMTPU_FLEET_WORLD", str(net["num_machines"])))
    _keep = int(os.environ.get("LGBMTPU_FLEET_SNAPSHOT_KEEP", "0") or 0)
    _slices = json.loads(os.environ.get("LGBMTPU_FLEET_SLICES", "{}")) or None
    with open(os.environ["LGBMTPU_FLEET_SHARDS_JSON"]) as fh:
        _shards = json.load(fh)

    def _fleet_ckpt_cb(env):
        it = env.model.current_iteration()  # global: a resumed run keeps it
        if it % _ckpt_freq:
            return
        text = env.model.model_to_string(raw_deltas=True)
        if wid == "0":
            _ckpt.write_fleet_checkpoint(_ckpt_dir, text, it, _world, _shards,
                                         keep=_keep, slices=_slices)
        else:
            _ckpt.confirm_fleet_checkpoint(_ckpt_dir, it, int(wid), text)
    _fleet_ckpt_cb.order = 100
    callbacks.append(_fleet_ckpt_cb)

bst = lgb.train(params, ds, int(os.environ["LGBM_TPU_ROUNDS"]),
                valid_sets=valid_sets or None, valid_names=valid_names or None,
                callbacks=callbacks,
                # a relaunched fleet resumes from the newest fleet-valid manifest
                resume=os.environ.get("LGBMTPU_RESUME_MANIFEST") or None)
out = os.environ["LGBM_TPU_MODEL_OUT"]
bst.save_model(out + f".rank{wid}")
if wid == "0":
    meta = {"best_iteration": bst.best_iteration,
            "best_score": {d: dict(m) for d, m in bst.best_score.items()},
            "evals_result": {d: {k: list(map(float, v)) for k, v in m.items()}
                             for d, m in evals_result.items()},
            "round_stats": [{k: v for k, v in s.items()
                             if isinstance(v, (int, float, str, bool))}
                            for s in bst._gbdt.round_stats]}
    g = bst._gbdt
    for key, d in (("mesh_stats", g._dp if g._dp is not None else g._fp),
                   ("mesh_2d_stats", g._dp2d), ("mesh_hier_stats", g._dp_hier)):
        if d is not None:
            meta[key] = json.loads(json.dumps(d.mesh.stats))
    with open(out + ".meta.json", "w") as fh:
        json.dump(meta, fh)
if _snap_path:
    _obs_metrics.stop_periodic_snapshots()
from lightgbm_tpu_torch.parallel.distributed import free_network
free_network()
print("LAUNCHER_RANK_OK", wid, flush=True)
"""

_SPMD_SRC = r"""
import os, sys, datetime
sys.path.insert(0, os.environ["LGBM_TPU_REPO"])
import torch, torch.distributed as dist
_rank, _world = int(os.environ["LGBMTPU_SPMD_RANK"]), int(os.environ["LGBMTPU_SPMD_WORLD"])
_backend = os.environ.get("LGBMTPU_SPMD_BACKEND", "gloo")
if _backend == "nccl" or os.environ.get("LGBMTPU_SPMD_CUDA"):
    torch.cuda.set_device(_rank % torch.cuda.device_count())
dist.init_process_group(_backend, init_method=os.environ["LGBMTPU_SPMD_INIT"],
                        rank=_rank, world_size=_world,
                        timeout=datetime.timedelta(seconds=float(
                            os.environ.get("LGBMTPU_SPMD_TIMEOUT_S", "60"))))
RANK, WORLD, WORKDIR = _rank, _world, os.environ["LGBMTPU_SPMD_DIR"]
exec(compile(open(os.environ["LGBMTPU_SPMD_SCRIPT"]).read(),
             os.environ["LGBMTPU_SPMD_SCRIPT"], "exec"))
dist.destroy_process_group()
print("SPMD_RANK_OK", RANK, flush=True)
"""

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class WorkerFailure(RuntimeError):
    """A launcher worker died (non-zero exit), hung (heartbeat stale past
    the timeout), or the launch timed out; ``rank`` is the failing rank
    (None for a timeout).  ``slice_id`` is set when the failure was handled
    slice-granularly: only that slice's workers were killed, the others
    still run, and the caller respawns the slice."""

    def __init__(self, msg: str, rank: Optional[int] = None,
                 timed_out: bool = False, hung: bool = False,
                 slice_id: Optional[int] = None):
        super().__init__(msg)
        self.rank = rank
        self.timed_out = timed_out
        self.hung = hung
        self.slice_id = slice_id


# the slow-rank check's floor on a heartbeat age (s), over the snapshot
# period and the read cadence
_SLOW_RANK_FLOOR_S = 1.0


def _snapshot_period() -> float:
    try:
        return float(os.environ.get("LGBMTPU_METRICS_SNAPSHOT_PERIOD_S", "1.0"))
    except ValueError:
        return 1.0


def _kill_worker_group(proc: subprocess.Popen) -> None:
    """Kill a worker and everything it spawned (each worker runs in its own
    session, so its process group is its subtree)."""
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.kill()
        except OSError:
            pass
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        pass


def _log_tail(log_path: str, nbytes: int = 2000) -> str:
    try:
        with open(log_path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            fh.seek(max(0, fh.tell() - nbytes))
            return fh.read().decode(errors="replace")
    except OSError as e:
        return f"<log unreadable: {e}>"


def _read_heartbeat(snap_path: Optional[str]) -> Optional[float]:
    """The ``heartbeat_ts`` gauge of a rank's metrics snapshot, or None
    before training started or after it retired its heartbeat
    (``heartbeat_done``: the post-training tail may outlast the timeout)."""
    if not snap_path:
        return None
    try:
        with open(snap_path, encoding="utf-8") as fh:
            gauges = json.load(fh).get("gauges", {})
        if gauges.get("heartbeat_done"):
            return None
        hb = gauges.get("heartbeat_ts")
        return float(hb) if hb is not None else None
    except (OSError, ValueError, AttributeError):
        return None


def _watch_workers(workers, timeout_s: float, poll_interval: float = 0.1,
                   heartbeat_timeout_s: Optional[float] = None,
                   heartbeat_paths: Optional[Dict[int, str]] = None,
                   slow_rank_factor: float = 0.0,
                   hb_ages: Optional[Dict[int, float]] = None,
                   slice_of: Optional[Dict[int, int]] = None,
                   slice_granular: bool = False,
                   done: Optional[set] = None) -> None:
    """Wait for every worker ((rank, Popen, log_path)) to exit 0.  A worker
    that exits non-zero, a worker whose heartbeat stops changing for more
    than ``heartbeat_timeout_s`` (armed once it has changed, so the first
    round's set-up is not a hang; the stalest such rank is blamed, the
    others wait on it), and a launch past ``timeout_s`` raise WorkerFailure.
    ``slow_rank_factor`` > 0 emits one ``fleet_slow_rank`` event an episode
    for a rank whose heartbeat age passes factor x the lower median of its
    group (its slice with ``slice_of``, else the fleet) and a floor;
    nothing is killed.  ``hb_ages`` is kept updated with each rank's age.
    Every worker is killed on every failure path, unless
    ``slice_granular`` and the failing rank has a slice: then only that
    slice's workers are killed and the raised failure carries
    ``slice_id``.  ``done`` (ranks that exited 0) may be carried across
    calls (the slice respawn re-enters the watch)."""
    deadline = time.monotonic() + timeout_s
    done = set() if done is None else done
    hb_seen: Dict[int, Tuple[float, float, bool]] = {}
    hb_next = 0.0
    slow_active: set = set()
    watch_hb = bool((heartbeat_timeout_s or slow_rank_factor or hb_ages is not None)
                    and heartbeat_paths)

    def failure(rank, msg, hung=False):
        sid = slice_of.get(rank) if slice_granular and slice_of else None
        if sid is not None:
            for r2, p2, _ in workers:
                if slice_of.get(r2) == sid and p2.poll() is None:
                    _kill_worker_group(p2)
        return WorkerFailure(msg, rank=rank, hung=hung, slice_id=sid)

    try:
        while len(done) < len(workers):
            for rank, proc, log_path in workers:
                if rank in done:
                    continue
                rc = proc.poll()
                if rc is None:
                    continue
                if rc == 0:
                    done.add(rank)
                    _obs.event("worker_exit", worker_rank=rank, exit_code=0)
                    continue
                _obs.counter("launcher_worker_deaths_total").inc()
                _obs.event("worker_death", worker_rank=rank, exit_code=rc,
                           log=log_path)
                raise failure(rank,
                              f"launcher worker rank {rank} died with exit code {rc}. "
                              f"Tail of its log ({log_path}):\n{_log_tail(log_path)}")
            now = time.monotonic()
            if watch_hb and now >= hb_next:
                hb_next = now + (min(1.0, heartbeat_timeout_s / 4.0)
                                 if heartbeat_timeout_s else 1.0)
                stalest = None
                ages: Dict[int, float] = {}
                for rank, proc, log_path in workers:
                    hb = (None if rank in done or proc.poll() is not None
                          else _read_heartbeat(heartbeat_paths.get(rank)))
                    if hb is None:
                        if hb_ages is not None:
                            hb_ages.pop(rank, None)
                        continue
                    prev = hb_seen.get(rank)
                    if prev is None or hb != prev[0]:
                        hb_seen[rank] = (hb, now, prev is not None)
                        if prev is not None:
                            ages[rank] = 0.0
                        continue
                    if not prev[2]:
                        continue
                    ages[rank] = stale = now - prev[1]
                    if (heartbeat_timeout_s and stale > heartbeat_timeout_s
                            and (stalest is None or stale > stalest[0])):
                        stalest = (stale, rank, proc, log_path)
                if hb_ages is not None:
                    hb_ages.update(ages)
                if slow_rank_factor and len(ages) >= 2:
                    _note_slow_ranks(ages, slice_of, slow_rank_factor, slow_active)
                if stalest is not None:
                    stale, rank, proc, log_path = stalest
                    _obs.counter("fleet_hangs_total").inc()
                    _obs.event("worker_hang", worker_rank=rank, stale_s=round(stale, 3),
                               heartbeat_timeout_s=heartbeat_timeout_s, log=log_path)
                    _kill_worker_group(proc)
                    raise failure(rank,
                                  f"launcher worker rank {rank} HUNG: heartbeat "
                                  f"unchanged for {stale:.1f}s (> "
                                  f"{heartbeat_timeout_s:g}s). Tail of its log "
                                  f"({log_path}):\n{_log_tail(log_path)}", hung=True)
            if now > deadline:
                _obs.counter("launcher_timeouts_total").inc()
                _obs.event("launch_timeout", timeout_s=timeout_s)
                tails = "\n".join(f"--- rank {r} ({lp}) ---\n{_log_tail(lp)}"
                                  for r, _, lp in workers)
                raise WorkerFailure(
                    f"launcher timed out after {timeout_s:.0f}s; all worker "
                    f"process groups killed. Worker log tails:\n{tails}",
                    timed_out=True)
            time.sleep(poll_interval)
    except BaseException as e:
        # a slice-scoped failure leaves the other slices running for the
        # respawned slice to rejoin
        if not (isinstance(e, WorkerFailure) and e.slice_id is not None):
            for _, p, _ in workers:
                if p.poll() is None:
                    _kill_worker_group(p)
        raise


def _note_slow_ranks(ages: Dict[int, float], slice_of, factor: float,
                     slow_active: set) -> None:
    """The slow-rank check on one read of the heartbeats: a rank is slow
    when its age passes ``factor`` x the lower median of its group's ages
    (its slice's, with ``slice_of``) and the floor; one event an episode."""
    groups: Dict[Optional[int], list] = {}
    for rank, age in ages.items():
        groups.setdefault(slice_of.get(rank) if slice_of else None, []).append(age)
    floor = max(_SLOW_RANK_FLOOR_S, 2.0 * _snapshot_period() + 1.0)
    for rank, age in ages.items():
        gid = slice_of.get(rank) if slice_of else None
        group = sorted(groups[gid])
        if len(group) < 2:
            continue  # a lone rank has no peer cadence
        med = group[(len(group) - 1) // 2]
        slow = age > max(factor * med, floor)
        if slow and rank not in slow_active:
            slow_active.add(rank)
            _obs.counter("fleet_slow_ranks_total").inc()
            _obs.event("fleet_slow_rank", worker_rank=rank, age_s=round(age, 3),
                       fleet_median_s=round(med, 3), factor=factor, slice=gid)
        elif not slow:
            slow_active.discard(rank)


def _fleet_live_collector(tmp: str, num_machines: int, hb_ages: Dict[int, float],
                          slice_of: Optional[Dict[int, int]] = None):
    """The launcher's live fleet view for its own /metrics: every rank's
    periodic snapshot file with ``rank`` labels, and each rank's heartbeat
    age (``fleet_heartbeat_age_s``, labelled by slice too).  Host file
    reads only; a torn file skips one scrape."""
    def collect() -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {"counters": {}, "gauges": {}}
        for r in range(num_machines):
            try:
                with open(os.path.join(tmp, f"worker{r}.metrics.json"),
                          encoding="utf-8") as fh:
                    snap = json.load(fh)
            except (OSError, ValueError):
                continue
            if not isinstance(snap, dict):
                continue
            for kind, cast in (("counters", int), ("gauges", float)):
                for name, v in (snap.get(kind) or {}).items():
                    try:
                        out[kind][_obs.labeled(name, rank=r)] = cast(v)
                    except (TypeError, ValueError):
                        pass
        for r, age in list(hb_ages.items()):
            labels = {"rank": r}
            if slice_of is not None and r in slice_of:
                labels["slice"] = slice_of[r]
            out["gauges"][_obs.labeled("fleet_heartbeat_age_s", **labels)] = float(age)
        return out

    return collect


def aggregate_fleet_events(tmp: str, num_machines: int, since: float = 0.0) -> str:
    """The workers' event files and the launcher's own lifecycle events of
    this run, merged by time into ``<tmp>/fleet_events.jsonl``."""
    own = os.path.join(tmp, "launcher.events.jsonl")
    try:
        with open(own, "w", encoding="utf-8") as fh:
            for rec in _obs.events():
                if rec.get("ts", 0.0) >= since and str(rec.get("kind", "")).startswith(
                        ("worker_", "fleet_", "launch_")):
                    fh.write(json.dumps(rec, default=str) + "\n")
    except OSError:
        own = None
    paths = [os.path.join(tmp, f"worker{r}.events.jsonl") for r in range(num_machines)]
    if own is not None:
        paths.append(own)
    out = os.path.join(tmp, "fleet_events.jsonl")
    _obs.merge_event_files(paths, out)
    return out


def aggregate_fleet_metrics(tmp: str, num_machines: int) -> str:
    """The workers' metrics snapshots merged into ``<tmp>/fleet_metrics.json``
    (counters summed, gauges max'd; a missing rank file is skipped)."""
    paths = [os.path.join(tmp, f"worker{r}.metrics.json") for r in range(num_machines)]
    out = os.path.join(tmp, "fleet_metrics.json")
    _obs.merge_snapshot_files(paths, out)
    return out


def aggregate_fleet_trace(tmp: str, num_machines: int) -> Optional[str]:
    """The workers' trace exports merged into ``<tmp>/fleet_trace.json``,
    each rank in its own lane; None when no rank left one."""
    paths = [p for p in (os.path.join(tmp, f"worker{r}.trace.json")
                         for r in range(num_machines)) if os.path.exists(p)]
    if not paths:
        return None
    out = os.path.join(tmp, "fleet_trace.json")
    _trace.merge_trace_files(paths, out_path=out)
    return out


def _free_ports(k: int) -> list:
    """reference: dask.py _find_n_open_ports."""
    socks, ports = [], []
    for _ in range(k):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _shard_plan(n: int, num_machines: int,
                group: Optional[np.ndarray]) -> Tuple[List[Tuple[int, int]], List]:
    """Row-shard plan: consecutive (lo, hi) blocks in rank order and each
    rank's query sizes.  With ``group`` the boundaries snap to queries
    (greedy contiguous fill).  No padding: a rank holds exactly its rows."""
    if group is not None:
        group = np.asarray(group, np.int64)
        if group.sum() != n:
            raise ValueError(f"group sizes sum to {group.sum()} but data has {n} rows")
        if len(group) < num_machines:
            raise ValueError(f"not enough queries ({len(group)}) for "
                             f"{num_machines} machines")
        bounds = np.concatenate([[0], np.cumsum(group)])
        slices, groups, q = [], [], 0
        for rank in range(num_machines):
            target = (n * (rank + 1)) // num_machines
            q0, q_cap = q, len(group) - (num_machines - rank - 1)
            q += 1
            while q < q_cap and bounds[q + 1] <= target:
                q += 1
            if rank == num_machines - 1:
                q = len(group)
            slices.append((int(bounds[q0]), int(bounds[q])))
            groups.append(group[q0:q])
        return slices, groups
    per = -(-n // num_machines)
    return ([(min(r * per, n), min((r + 1) * per, n)) for r in range(num_machines)],
            [None] * num_machines)


def _rank_arrays(slices, groups, rank, X, y, weight):
    """One rank's (X, y, w, g) (empty w / g when not given)."""
    lo, hi = slices[rank]
    w = (np.asarray(weight, np.float64)[lo:hi] if weight is not None
         else np.asarray(()))
    g = groups[rank]
    return X[lo:hi], np.asarray(y)[lo:hi], w, (g if g is not None else np.asarray(()))


# the most recent train_distributed launch directory: its fleet_events.jsonl
# and fleet_metrics.json after a failed launch too
_LAST_LAUNCH_DIR: Optional[str] = None


def _row_blocks(params: Dict, ranks: int) -> Tuple[int, int]:
    """(row blocks, ranks a block) of one world's shard plan: each rank its
    own block, but under tree_learner=feature2d with num_feature_shards
    d_f > 1 dividing the world the d_f ranks of one row of the 2-D mesh
    share a block (models/gbdt.py::_set_learner makes the same choice)."""
    cfg = Config.from_dict(params)
    d_f = max(int(cfg.num_feature_shards), 1)
    if cfg.tree_learner == "feature2d" and d_f > 1 and ranks % d_f == 0:
        return ranks // d_f, d_f
    return ranks, 1


def _fingerprint(arrays) -> str:
    """sha256 of a shard's data (not its file, whose zip stamps differ
    between relaunches): what a resumed round must see again."""
    h = hashlib.sha256()
    for arr in arrays:
        if arr is not None:
            h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def train_distributed(params: Dict, X: np.ndarray, y: np.ndarray,
                      num_boost_round: int = 100, *, num_machines: int = 2,
                      weight: Optional[np.ndarray] = None,
                      group: Optional[np.ndarray] = None,
                      eval_set: Optional[Sequence[Tuple]] = None,
                      eval_weight: Optional[Sequence] = None,
                      eval_group: Optional[Sequence] = None,
                      eval_names: Optional[Sequence[str]] = None,
                      early_stopping_rounds: Optional[int] = None,
                      timeout_s: int = 600, env_extra: Optional[Dict[str, str]] = None,
                      max_restarts: int = 0, restart_backoff_s: float = 1.0,
                      heartbeat_timeout_s: Optional[float] = None,
                      num_slices: Optional[int] = None,
                      data_cache: Optional[str] = None):
    """Shard rows over ``num_machines`` local worker processes, train with
    tree_learner=data (or the learner ``params`` name) under pre_partition,
    and return (rank 0's Booster, the per-rank model paths).  With
    ``eval_set`` each eval set is sharded the same way and its metrics are
    evaluated over every rank's rows.  ``data_cache``: a save_binary cache
    instead of (X, y), each rank reading only its rows (bin_cache_shard).

    ``max_restarts`` relaunches the fleet after a failure (fresh ports,
    backoff ``restart_backoff_s`` x 2^attempt); with ``snapshot_freq`` > 0
    in ``params`` the relaunch resumes from the newest fleet-valid manifest
    (module docstring), else from scratch.  A hung rank (heartbeat stale
    past ``heartbeat_timeout_s``, or LGBMTPU_HEARTBEAT_TIMEOUT_S, or the
    parameter) is killed and handled as a death.  ``num_slices`` > 1
    (argument or parameter) groups the ranks into slice worlds of
    num_machines / num_slices, each training the shared plan; a failure
    respawns only its slice (up to ``max_restarts`` times) from the newest
    slice-valid round.  The returned booster carries the run's merged
    events, metrics and trace paths (``_fleet_events``, ``_fleet_metrics``,
    ``_fleet_trace``) and, from rank 0, ``_distributed_meta`` (round stats,
    the collectives' counts)."""
    import lightgbm_tpu_torch as lgb

    global _LAST_LAUNCH_DIR
    cfg = Config.from_dict(params)
    num_slices = max(int(num_slices if num_slices is not None else cfg.num_slices), 1)
    ranks_per_slice = num_machines
    slice_of: Optional[Dict[int, int]] = None
    if num_slices > 1:
        if num_machines % num_slices:
            raise ValueError(f"num_machines={num_machines} does not divide into "
                             f"num_slices={num_slices}")
        ranks_per_slice = num_machines // num_slices
        slice_of = {r: r // ranks_per_slice for r in range(num_machines)}
    feature = cfg.tree_learner == "feature"
    n_blocks, per_block = _row_blocks(params, ranks_per_slice)
    if data_cache is not None:
        from ..io.stream import BinCacheStream

        if X is not None or y is not None or weight is not None or group is not None \
                or eval_set:
            raise ValueError("data_cache= carries the rows, labels and weights: "
                             "pass it instead of (X, y), weight, group, eval_set")
        if feature:
            raise ValueError("tree_learner=feature needs every row on every rank; "
                             "pass (X, y)")
        n = BinCacheStream(data_cache).shape[0]
    else:
        n = X.shape[0]

    def plan(rows: int, grp) -> Tuple[list, list]:
        """(lo, hi) and query sizes of each rank of one slice world."""
        if feature:  # rows replicated, features sharded
            return [(0, rows)] * ranks_per_slice, [grp] * ranks_per_slice
        sl, gr = _shard_plan(rows, n_blocks, grp)
        return ([sl[r // per_block] for r in range(ranks_per_slice)],
                [gr[r // per_block] for r in range(ranks_per_slice)])

    slices, groups = plan(n, group)
    for arg_name, arg in (("eval_names", eval_names), ("eval_weight", eval_weight),
                          ("eval_group", eval_group)):
        if arg is not None and len(arg) != len(eval_set or ()):
            raise ValueError(f"{arg_name} has {len(arg)} entries but eval_set has "
                             f"{len(eval_set or ())}")
    eval_plans = []
    for i, ev in enumerate(eval_set or ()):
        Xe, ye = np.asarray(ev[0]), np.asarray(ev[1]).ravel()
        ge = (np.asarray(eval_group[i], np.int64)
              if eval_group is not None and eval_group[i] is not None else None)
        we = (np.asarray(eval_weight[i], np.float64).ravel()
              if eval_weight is not None and eval_weight[i] is not None else None)
        sl, gr = plan(Xe.shape[0], ge)
        eval_plans.append((Xe, ye, we, sl, gr,
                           eval_names[i] if eval_names is not None else f"valid_{i}"))

    tmp = _LAST_LAUNCH_DIR = tempfile.mkdtemp(prefix="lgbm_torch_launch_")
    if heartbeat_timeout_s is None:
        env_hb = os.environ.get("LGBMTPU_HEARTBEAT_TIMEOUT_S")
        heartbeat_timeout_s = float(env_hb) if env_hb else float(cfg.heartbeat_timeout_s)
    env_slow = os.environ.get("LGBMTPU_SLOW_RANK_FACTOR")
    slow_rank_factor = float(env_slow) if env_slow else float(cfg.slow_rank_factor)
    # the launcher owns the fleet's snapshots (the workers' callback runs
    # the manifest protocol): the workers' own snapshot_freq is dropped
    fleet_freq = max(int(cfg.snapshot_freq), 0)
    fleet_keep = max(int(cfg.snapshot_keep), 0)
    params = {k: v for k, v in dict(params).items()
              if _ALIASES.get(k, k) != "snapshot_freq"}
    hb_ages: Dict[int, float] = {}
    _obs.register_collector("fleet_live",
                            _fleet_live_collector(tmp, num_machines, hb_ages, slice_of))
    from ..obs import server as _obs_server

    _obs_server.maybe_start(int(cfg.metrics_port) if cfg.is_set("metrics_port")
                            else None)
    params_path = os.path.join(tmp, "params.npz")
    np.savez(params_path, params=np.asarray(dict(params), dtype=object))
    model_out = os.path.join(tmp, "model.txt")
    shard_fps: Dict[str, str] = {}
    shards_json = os.path.join(tmp, "fleet_shards.json")
    relaunch = {"resume_manifest": None}

    def write_shards(ports) -> None:
        # every shard file and the fingerprint table exist before any
        # worker starts (rank 0 reads the table once)
        for rank in range(num_machines):
            local, sid = rank % ranks_per_slice, rank // ranks_per_slice
            slice_ports = ports[sid * ranks_per_slice:(sid + 1) * ranks_per_slice]
            shard = dict(num_machines=ranks_per_slice,
                         machines=",".join(f"127.0.0.1:{p}" for p in slice_ports),
                         local_listen_port=ports[rank], time_out=2,
                         n_eval=len(eval_plans))
            if data_cache is None:
                Xs, ys, ws, gs = _rank_arrays(slices, groups, local, X, y, weight)
                shard.update(X=Xs, y=ys, w=ws, g=gs)
                for i, (Xe, ye, we, sl, gr, name) in enumerate(eval_plans):
                    Xv, yv, wv, gv = _rank_arrays(sl, gr, local, Xe, ye, we)
                    shard.update({f"ev{i}_X": Xv, f"ev{i}_y": yv, f"ev{i}_w": wv,
                                  f"ev{i}_g": gv, f"ev{i}_name": name})
                shard_fps.setdefault(str(rank), _fingerprint((Xs, ys, ws, gs)))
            elif str(rank) not in shard_fps:
                from ..io.stream import cache_shard_fingerprint

                shard_fps[str(rank)] = cache_shard_fingerprint(data_cache,
                                                               *slices[local])
            np.savez(os.path.join(tmp, f"shard{rank}.npz"), **shard)
        if not os.path.exists(shards_json):
            with open(shards_json, "w", encoding="utf-8") as fh:
                json.dump(shard_fps, fh)

    def spawn(workers, rank: int, resume_manifest: Optional[str] = None,
              exclude_ranks: str = "") -> None:
        local = rank % ranks_per_slice
        env = dict(os.environ)
        env.update(env_extra or {})
        env.update(LIGHTGBM_TPU_RANK=str(local), LGBM_TPU_WORKER_ID=str(rank),
                   LGBM_TPU_REPO=_REPO,
                   LGBM_TPU_SHARD=os.path.join(tmp, f"shard{rank}.npz"),
                   LGBM_TPU_PARAMS=params_path, LGBM_TPU_ROUNDS=str(num_boost_round),
                   LGBM_TPU_MODEL_OUT=model_out,
                   LGBM_TPU_ES_ROUNDS=str(early_stopping_rounds or 0),
                   LGBMTPU_EVENTS_FILE=os.path.join(tmp, f"worker{rank}.events.jsonl"),
                   LGBMTPU_METRICS_SNAPSHOT_FILE=os.path.join(
                       tmp, f"worker{rank}.metrics.json"),
                   LGBMTPU_TRACE_FILE=os.path.join(tmp, f"worker{rank}.trace.json"),
                   LGBMTPU_SHARD_FINGERPRINT=shard_fps[str(rank)])
        if data_cache is not None:
            env["LGBM_TPU_CACHE"] = os.fspath(data_cache)
            env["LGBM_TPU_CACHE_SHARD"] = "%d,%d" % slices[local]
        if fleet_freq > 0:
            env.update(LGBMTPU_FLEET_CKPT_DIR=tmp,
                       LGBMTPU_FLEET_SNAPSHOT_FREQ=str(fleet_freq),
                       LGBMTPU_FLEET_SNAPSHOT_KEEP=str(fleet_keep),
                       LGBMTPU_FLEET_SHARDS_JSON=shards_json)
        if num_slices > 1:
            env["LGBMTPU_FLEET_WORLD"] = str(num_machines)
            env["LGBMTPU_FLEET_SLICES"] = json.dumps({str(r): s
                                                      for r, s in slice_of.items()})
        resume_manifest = resume_manifest or relaunch["resume_manifest"]
        if resume_manifest:
            env["LGBMTPU_RESUME_MANIFEST"] = resume_manifest
        if exclude_ranks:
            env["LGBMTPU_RESUME_EXCLUDE_RANKS"] = exclude_ranks
        if env.get("LGBMTPU_FAULT"):
            # injected faults fire once across relaunches (utils/faults.py)
            env.setdefault("LGBMTPU_FAULT_ONCE_DIR", tmp)
        env.pop("PYTEST_CURRENT_TEST", None)
        # a relaunched rank must not inherit its predecessor's snapshot (its
        # frozen heartbeat would read as a hang) nor its trace
        for key in ("LGBMTPU_METRICS_SNAPSHOT_FILE", "LGBMTPU_TRACE_FILE"):
            try:
                os.unlink(env[key])
            except OSError:
                pass
        log_path = os.path.join(tmp, f"worker{rank}.log")
        with open(log_path, "wb") as log_fh:
            proc = subprocess.Popen([sys.executable, "-c", _WORKER_SRC], env=env,
                                    stdout=log_fh, stderr=subprocess.STDOUT,
                                    start_new_session=True)
        for i, (r, _p, _lp) in enumerate(workers):
            if r == rank:  # a respawned rank replaces its dead entry
                workers[i] = (rank, proc, log_path)
                break
        else:
            workers.append((rank, proc, log_path))
        _obs.counter("launcher_worker_spawns_total").inc()
        _obs.event("worker_spawn", worker_rank=rank, pid=proc.pid)

    def respawn_slice(workers, sid: int, attempt: int, done: set) -> None:
        # only the failed slice restarts, from the newest slice-valid round
        # (the surviving ranks' acks present); a member that already exited
        # 0 is not lost
        lost = tuple(r for r in range(num_machines)
                     if slice_of[r] == sid and r not in done)
        manifest = resumed_round = None
        if fleet_freq > 0:
            fm = _checkpoint.latest_slice_valid_fleet_manifest(tmp, num_machines, lost)
            if fm is not None:
                resumed_round, manifest, _ = fm
        _obs.counter("fleet_slice_resumes_total").inc()
        _obs.event("fleet_slice_resume", slice=sid, ranks=list(lost),
                   round=resumed_round, attempt=attempt)
        log_warning(f"slice {sid} (ranks {list(lost)}) failed; respawning it "
                    + (f"from slice-valid manifest round {resumed_round}"
                       if resumed_round is not None else "from scratch")
                    + f"; the other slices run on (attempt {attempt})")
        for rank in lost:
            spawn(workers, rank, resume_manifest=manifest,
                  exclude_ranks=",".join(str(r) for r in lost))

    def launch_once() -> None:
        # fresh ports each attempt: the machines list is in the shards
        ports = _free_ports(num_machines)
        workers: list = []
        try:
            write_shards(ports)
            for rank in range(num_machines):
                spawn(workers, rank)
        except BaseException:
            for _, p, _ in workers:
                if p.poll() is None:
                    _kill_worker_group(p)
            raise
        slice_restarts = 0
        done: set = set()
        while True:
            try:
                _watch_workers(workers, timeout_s,
                               heartbeat_timeout_s=heartbeat_timeout_s or None,
                               heartbeat_paths={r: os.path.join(
                                   tmp, f"worker{r}.metrics.json")
                                   for r in range(num_machines)},
                               slow_rank_factor=slow_rank_factor, hb_ages=hb_ages,
                               slice_of=slice_of, slice_granular=num_slices > 1,
                               done=done)
                return
            except WorkerFailure as e:
                if e.slice_id is None or slice_restarts >= max_restarts:
                    for _, p, _ in workers:
                        if p.poll() is None:
                            _kill_worker_group(p)
                    raise
                slice_restarts += 1
                respawn_slice(workers, e.slice_id, slice_restarts, done)

    attempt = 0
    run_started = time.time()
    try:
        while True:
            try:
                launch_once()
                break
            except WorkerFailure as e:
                if attempt >= max_restarts:
                    raise
                delay = restart_backoff_s * (2 ** attempt)
                attempt += 1
                resumed_round = None
                if fleet_freq > 0:
                    fm = _checkpoint.latest_valid_fleet_manifest(tmp, num_machines)
                    if fm is not None:
                        resumed_round, relaunch["resume_manifest"], _ = fm
                        _obs.counter("fleet_resumes_total").inc()
                        _obs.gauge("fleet_resumed_round").set(resumed_round)
                        _obs.event("fleet_resume", round=resumed_round,
                                   manifest=relaunch["resume_manifest"],
                                   attempt=attempt)
                _obs.counter("launcher_relaunches_total").inc()
                _obs.event("fleet_relaunch", attempt=attempt, backoff_s=delay,
                           cause=str(e)[:200], hung=bool(e.hung),
                           resumed_round=resumed_round)
                log_warning(f"launcher attempt {attempt}/{max_restarts + 1} failed "
                            f"({str(e)[:200]}); relaunching all workers in "
                            f"{delay:.1f}s"
                            + (f" from fleet checkpoint round {resumed_round}"
                               if resumed_round is not None else " from scratch"))
                time.sleep(delay)
    finally:
        fleet = {}
        for key, fn in (("events", lambda: aggregate_fleet_events(
                tmp, num_machines, since=run_started)),
                        ("metrics", lambda: aggregate_fleet_metrics(tmp, num_machines)),
                        ("trace", lambda: aggregate_fleet_trace(tmp, num_machines))):
            try:
                fleet[key] = fn()
            except (OSError, ValueError) as e:
                log_warning(f"could not write the fleet {key}: {e}")
                fleet[key] = None
    booster = lgb.Booster(model_file=model_out + ".rank0",
                          params={"device_type": cfg.device_type})
    booster._fleet_events = fleet["events"]
    booster._fleet_metrics = fleet["metrics"]
    booster._fleet_trace = fleet["trace"]
    meta_path = model_out + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
        booster.best_iteration = int(meta.get("best_iteration", -1))
        booster.best_score = meta.get("best_score", {})
        booster._distributed_evals_result = meta.get("evals_result", {})
        booster._distributed_meta = meta
    return booster, [model_out + f".rank{r}" for r in range(num_machines)]


def run_spmd(script: str, world: int, workdir: str, *, timeout_s: float = 80.0,
             backend: str = "gloo", cuda: bool = False,
             env_extra: Optional[Dict[str, str]] = None) -> List[str]:
    """Run the Python source ``script`` on ``world`` ranks of a process group
    (a FileStore rendezvous in ``workdir``, no port), under the launcher's
    watchdog with a wall limit of ``timeout_s``.  The script sees RANK,
    WORLD and WORKDIR, imports what it needs (this package, not the
    caller's modules) and writes its results under WORKDIR.  Returns the
    ranks' log paths; raises WorkerFailure if a rank fails or the limit
    passes."""
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "spmd_script.py")
    with open(path, "w") as fh:
        fh.write(script)
    init = os.path.join(workdir, "spmd_store")
    if os.path.exists(init):
        os.unlink(init)
    workers = []
    try:
        for rank in range(world):
            env = dict(os.environ)
            env.update(env_extra or {})
            env.update(LGBM_TPU_REPO=_REPO, LGBMTPU_SPMD_RANK=str(rank),
                       LGBMTPU_SPMD_WORLD=str(world), LGBMTPU_SPMD_DIR=workdir,
                       LGBMTPU_SPMD_SCRIPT=path, LGBMTPU_SPMD_BACKEND=backend,
                       LGBMTPU_SPMD_INIT=f"file://{init}",
                       LGBMTPU_SPMD_TIMEOUT_S=str(timeout_s))
            if cuda:
                env["LGBMTPU_SPMD_CUDA"] = "1"
            env.pop("PYTEST_CURRENT_TEST", None)
            log_path = os.path.join(workdir, f"rank{rank}.log")
            with open(log_path, "wb") as log_fh:
                proc = subprocess.Popen([sys.executable, "-c", _SPMD_SRC], env=env,
                                        stdout=log_fh, stderr=subprocess.STDOUT,
                                        start_new_session=True)
            workers.append((rank, proc, log_path))
        _watch_workers(workers, timeout_s)
    except BaseException:
        for _, p, _ in workers:
            if p.poll() is None:
                _kill_worker_group(p)
        raise
    return [lp for _, _, lp in workers]
