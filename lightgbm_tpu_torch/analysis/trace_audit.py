"""The trace audit: the port's counterpart of lightgbm_tpu/analysis/jaxpr_audit.py.

The JAX package traces its flagship executables to jaxprs and checks them;
the port has no trace to read, so each contract's round body
(contracts.py) runs ONCE under a recorder, and the J rules read what it
did.  The recorder is a ``torch.utils._python_dispatch.TorchDispatchMode``
(every aten and c10d op the body dispatches), plus the hooks of
utils/audit_hooks.py: the kernel wrappers (opaque ctypes calls on the
card) and the collectives of parallel/collectives.py report themselves.

====  ==========================  ========================================
J1    collectives                 exactly the declared collectives, in
                                  order, on the declared mesh axes, with
                                  per-axis bytes (dcn_max_bytes,
                                  feature_max_bytes); a c10d op the
                                  dispatcher sees outside those wrappers is
                                  a finding
J2    static-buffers-kept         every static buffer keeps its storage
                                  (``data_ptr()``) and its identity: the
                                  body writes in place, rebinds nothing
J3    no-f64                      no float64 op beyond the declared
                                  allowance
J4    no-host-sync                no ``aten::_local_scalar_dense``
                                  (``.item()``, a cast of a tensor), no
                                  device-to-host copy, no unsized
                                  ``nonzero``, no accounted read
                                  (utils/sanitizer.py); on the card the
                                  capture refuses a synchronize too
J5    no-host-data                no host-to-device copy, ``lift_fresh``
                                  of host data above the contract's byte
                                  threshold
J6    live-bytes                  the peak live bytes of the tensors the
                                  body makes (a wrapper's: its outputs)
                                  within the budget (on the card also
                                  ``max_memory_allocated``'s rise, every
                                  kernel buffer included)
J7    bin-sweeps                  bytes of the bin matrix (and of copies
                                  made of it) read, over its size, within
                                  the contract's sweep budget: the kernel
                                  wrappers record their bins operand, the
                                  aten ops outside them (the three-pass
                                  window gather, round_cuda.py's
                                  ``index_select``) count at the
                                  dispatcher
====  ==========================  ========================================

A contract-level waiver (``waivers={"J6": "reason"}``) suppresses a rule
for that contract, reason mandatory (a reasonless or unknown-rule waiver
is a P0 finding), as the JAX package's.

The ledger cross-check (``ledger_crosscheck``) runs whole trees through
the production round loop (ops/treegrow_windowed.py
``_run_fused_rounds``) with the recorder on and holds every round to its
contract: one RoundGraphs replay a round (utils/sanitizer.py's counts) on
a single device, and on a sharded one the Mesh.stats collectives equal to
the rounds times the declared sequence.

The sharded contracts need a process group of 4 ranks:
``run_trace_audit`` starts one over gloo (parallel/launcher.py
``run_spmd``) when it is not already inside one.  On the card
chip_smoke.py's phase 26 audits the single-device contracts at its cells'
shapes with the real kernels (``audit_contract(c, "cuda", fixture,
capture=True)``), then captures each body through ops/graphs.py and holds
the graph's launch tally to the contract's declared launches.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import weakref
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..utils import audit_hooks as _hooks
from ..utils import sanitizer as _san
from .contracts import CONTRACTS, WORLD, Contract, Target
from .core import Finding

TRACE_RULES: Dict[str, str] = {
    "J1": "collectives — the exact declared op@axis sequence, per-axis byte "
          "bills (dcn_max_bytes, feature_max_bytes), no c10d op outside "
          "parallel/collectives.py",
    "J2": "static-buffers-kept — every static buffer's storage and identity "
          "unchanged by the body",
    "J3": "no-f64 — float64 ops within the declared allowance",
    "J4": "no-host-sync — no .item()/cast, device-to-host copy, unsized "
          "nonzero or accounted read in the body",
    "J5": "no-host-data — no host-to-device copy or lift_fresh above the "
          "contract's byte threshold",
    "J6": "live-bytes — peak live bytes within the contract's budget",
    "J7": "bin-sweeps — bin-matrix bytes read within the sweep budget",
}

# a collective moving at least this many bytes is a "large" (histogram-
# class) merge; below it, scalar protocol traffic
LARGE_COLLECTIVE_BYTES = 4096

_SYNC_OPS = ("aten._local_scalar_dense.default", "aten.nonzero.default",
             "aten.equal.default", "aten.is_nonzero.default")
_COPY_OPS = ("aten._to_copy.default", "aten.copy_.default",
             "aten._copy_from.default", "aten._copy_from_and_resize.default")
_GATHER_OPS = ("aten.index_select.default", "aten.index.Tensor",
               "aten.gather.default", "aten.take.default")


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _skey(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return 0


class Recorder(TorchDispatchMode):
    """What a body did: its collectives, wrapper calls, float64 ops, host
    reads, host data, live bytes and bin-matrix reads."""

    def __init__(self, bins: Optional[torch.Tensor] = None):
        super().__init__()
        self.collectives: List[Tuple[str, str, int]] = []
        self.wrappers: Counter = Counter()
        self.stray_c10d: List[str] = []
        self.f64_ops: List[str] = []
        self.host_syncs: List[str] = []
        self.h2d: List[Tuple[str, int]] = []
        self.cur = self.peak = 0
        self._live: Dict[int, int] = {}
        self._refs: Counter = Counter()
        self._pending_c10d = 0
        self._depth = 0
        self.bins_bytes = 0
        self.sweep_bytes = 0
        self._tainted = set()
        self._bins_dtype = self._bins_key = None
        if bins is not None:
            self.bins_bytes = bins.numel() * bins.element_size()
            self._bins_key = _skey(bins)
            self._tainted.add(self._bins_key)
            self._bins_dtype = bins.dtype

    # -- utils/audit_hooks.py ------------------------------------------
    def collective(self, op: str, axis: str, nbytes: int) -> None:
        self.collectives.append((op, axis, int(nbytes)))
        self._pending_c10d += 1

    def wrapper_enter(self, entry: str, args, kwargs) -> None:
        if self._depth == 0:
            self.wrappers[entry] += 1
            op = args[0] if args and isinstance(args[0], torch.Tensor) else None
            if op is not None and _skey(op) in self._tainted and op.dim() == 2:
                rows = op.shape[0]
                if "W" in kwargs:  # B3 reads its window's rows through order
                    rows = min(rows, int(kwargs["W"]))
                elif entry.endswith("_lanes") and len(args) > 4:
                    rows = min(int(args[4].numel()), rows * int(args[4].shape[0]))
                self.sweep_bytes += rows * op.shape[1] * op.element_size()
        self._depth += 1

    def wrapper_exit(self, entry: str, out) -> None:
        self._depth -= 1
        if self._depth == 0:  # the wrapper's outputs are the body's
            keys = set()
            for t in _tensors(out):
                self._track(t, keys)

    # -- the dispatcher -------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        if name.startswith("c10d."):
            if self._pending_c10d > 0:
                self._pending_c10d -= 1
            else:
                self.stray_c10d.append(name)
            return func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if self._depth == 0:
            # a kernel wrapper is opaque (on the card a ctypes launch; on
            # the CPU its plain version): J3-J5 and J7 read the body's own
            # ops, the wrapper its one record (wrapper_enter)
            if name in _SYNC_OPS:
                self.host_syncs.append(name)
            elif name in _COPY_OPS:
                self._copies(name, args, kwargs, ins, outs)
            elif name == "aten.lift_fresh.default" and ins:
                self.h2d.append((name, ins[0].numel() * ins[0].element_size()))
            if any(t.dtype == torch.float64 for t in outs):
                self.f64_ops.append(name)
            if self._tainted:
                self._sweeps(name, ins, outs)
        if self._depth == 0:  # inside a wrapper: only its outputs count
            in_keys = {_skey(t) for t in ins}
            for t in outs:
                self._track(t, in_keys)
        return out

    def _copies(self, name, args, kwargs, ins, outs) -> None:
        if name == "aten.copy_.default" and len(ins) >= 2:
            dst, src = ins[0], ins[1]
        elif ins and outs:
            src, dst = ins[0], outs[0]
        else:
            return
        if src.device.type != "cpu" and dst.device.type == "cpu":
            self.host_syncs.append(f"{name} {src.device} -> cpu")
        elif src.device.type == "cpu" and dst.device.type != "cpu":
            self.h2d.append((f"{name} cpu -> {dst.device}",
                             src.numel() * src.element_size()))

    def _sweeps(self, name, ins, outs) -> None:
        read = [t for t in ins if _skey(t) in self._tainted]
        if not read:
            return
        okeys = {_skey(t) for t in outs}
        for t in read:
            if _skey(t) in okeys:  # a view or an in-place op: no new read
                continue
            if name in _GATHER_OPS and outs:
                self.sweep_bytes += outs[0].numel() * t.element_size()
            else:
                self.sweep_bytes += t.numel() * t.element_size()
        for o in outs:  # a copy of bin values is bin data too
            if o.dtype == self._bins_dtype:
                self._tainted.add(_skey(o))

    def _track(self, t: torch.Tensor, in_keys) -> None:
        """Count a new storage the body made (a view or an in-place result
        of a tensor made before the body is none)."""
        key = _skey(t)
        if key == 0 or (key in in_keys and key not in self._live):
            return
        if key not in self._live:
            nbytes = t.untyped_storage().nbytes()
            self._live[key] = nbytes
            self.cur += nbytes
            self.peak = max(self.peak, self.cur)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        self._refs[key] -= 1
        if self._refs[key] <= 0:
            self._refs.pop(key, None)
            self.cur -= self._live.pop(key, 0)
            if key != self._bins_key:  # the address may be reused
                self._tainted.discard(key)

    # -- install / remove -------------------------------------------------
    def __enter__(self):
        _hooks.install(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _hooks.remove(self)


@dataclasses.dataclass
class ContractResult:
    name: str
    findings: List[Finding]
    waived: List[Tuple[Finding, str]]
    detail: Dict[str, object]

    @property
    def ok(self) -> bool:
        return not self.findings


@dataclasses.dataclass
class TraceReport:
    results: List[ContractResult]
    ledger: Dict[str, dict]

    @property
    def findings(self) -> List[Finding]:
        return [f for r in self.results for f in r.findings]

    @property
    def waived(self) -> List[Tuple[Finding, str]]:
        return [w for r in self.results for w in r.waived]

    @property
    def ok(self) -> bool:
        return not self.findings


def _finding(c: Contract, rule: str, msg: str, hint: str = "") -> Finding:
    return Finding(c.file, c.line, rule, f"[{c.name}] {msg}", hint)


def _leaves(tree):
    return [(id(t), t.data_ptr(), tuple(t.shape), t.dtype) for t in _tensors(tree)]


def axis_bytes(found) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for _op, axis, nb in found:
        out[axis] = out.get(axis, 0) + nb
    return out


def tokens(found) -> List[str]:
    return [f"{op}@{axis}" for op, axis, _ in found]


def check(c: Contract, target: Target, rec: Recorder, before, after,
          ledger: Optional[dict] = None) -> Tuple[List[Finding], dict]:
    """The J rules over one recorded run of ``target``'s body."""
    raw: List[Finding] = []
    found = rec.collectives
    toks = tokens(found)
    detail: Dict[str, object] = {
        "note": target.note, "collectives": toks,
        "large_collectives": sum(1 for _o, _a, nb in found
                                 if nb >= LARGE_COLLECTIVE_BYTES),
        "axis_bytes": axis_bytes(found), "wrappers": dict(rec.wrappers),
        "f64_ops": len(rec.f64_ops), "peak_live_bytes": rec.peak,
    }
    # J1
    if tuple(toks) != tuple(c.collectives):
        raw.append(_finding(
            c, "J1", f"collectives {toks} != declared {list(c.collectives)}",
            "every collective of the body is declared, in order, on its axis"))
    declared_axes = {t.split("@", 1)[1] for t in c.collectives}
    for op, axis, _ in found:
        if axis not in declared_axes:
            raw.append(_finding(c, "J1", f"{op} on undeclared axis {axis!r}",
                                "collectives run on the contract's mesh axes"))
    for name in rec.stray_c10d:
        raw.append(_finding(c, "J1", f"{name} outside parallel/collectives.py",
                            "issue collectives through parallel/collectives.py"))
    ab = axis_bytes(found)
    for axis, limit in (("dcn", c.dcn_max_bytes), ("feature", c.feature_max_bytes)):
        if limit is not None:
            detail[f"{axis}_bytes"] = ab.get(axis, 0)
            if ab.get(axis, 0) > limit:
                raw.append(_finding(c, "J1", f"{ab[axis]} bytes over the {axis} axis "
                                    f"> {limit}", f"the {axis} bill is pinned"))
    # J2
    if before != after:
        moved = [i for i, (a, b) in enumerate(zip(before, after)) if a != b]
        raw.append(_finding(c, "J2", f"static buffers rebound or moved (leaves "
                                     f"{moved or 'count'})",
                            "write the static buffers in place (copy_into)"))
    # J3
    if len(rec.f64_ops) > c.max_f64_ops:
        raw.append(_finding(c, "J3", f"{len(rec.f64_ops)} float64 ops > allowance "
                                     f"{c.max_f64_ops}: {sorted(set(rec.f64_ops))[:5]}",
                            "keep the round in f32/int"))
    # J4
    if rec.host_syncs:
        raw.append(_finding(c, "J4", f"host syncs in the body: "
                                     f"{sorted(set(rec.host_syncs))}",
                            "read one round behind (utils/sanitizer.py)"))
    # J5
    big = [(n, b) for n, b in rec.h2d if b > c.max_h2d_bytes]
    detail["h2d_bytes"] = sum(b for _n, b in rec.h2d)
    if big:
        raw.append(_finding(c, "J5", f"host data into the body: {big[:3]} "
                                     f"(> {c.max_h2d_bytes} bytes)",
                            "load it into the static buffers before the round"))
    # J6
    budget = c.live_budget(target)
    detail["live_budget"] = budget
    if rec.peak > budget:
        raw.append(_finding(c, "J6", f"peak live bytes {rec.peak} > budget {budget}",
                            "a state duplication in the round body"))
    # J7
    if target.bins is not None and rec.bins_bytes:
        sweeps = rec.sweep_bytes / rec.bins_bytes
        detail["bin_sweeps"] = round(sweeps, 4)
        if c.bin_sweeps is not None and sweeps > c.bin_sweeps:
            raw.append(_finding(c, "J7", f"{sweeps:.3f} bin-matrix sweeps > "
                                         f"{c.bin_sweeps}",
                                "read the bin matrix once a round"))
    # the launches the body made through the kernel wrappers
    if dict(rec.wrappers) != target.launches(c):
        raw.append(_finding(c, "J1", f"kernel wrapper calls {dict(rec.wrappers)} "
                                     f"!= declared launches {target.launches(c)}",
                            "declare the body's launches"))
    if ledger is not None:
        detail["ledger"] = ledger
        raw.extend(ledger.pop("findings", []))
    return raw, detail


def _apply_waivers(c: Contract, raw: List[Finding]):
    findings: List[Finding] = []
    waived: List[Tuple[Finding, str]] = []
    for rule, reason in c.waivers.items():
        if rule not in TRACE_RULES:
            findings.append(_finding(c, "P0", f"waiver names unknown rule {rule!r}",
                                     f"known rules: {', '.join(sorted(TRACE_RULES))}"))
        elif not str(reason).strip():
            findings.append(_finding(c, "P0", f"waiver for {rule} has no reason",
                                     "every waiver must document why"))
    for f in raw:
        reason = c.waivers.get(f.rule, "")
        if f.rule in c.waivers and str(reason).strip():
            waived.append((f, str(reason)))
        else:
            findings.append(f)
    return findings, waived


def run_body(c: Contract, target: Target, *, graphs: bool = False):
    """Run the body once under a recorder; returns (recorder, leaves
    before, leaves after, ledger).  ``graphs``: through a RoundGraphs cache
    on the target's device (eager on the CPU), as the grower runs it."""
    from ..ops.graphs import RoundGraphs

    meshes = list(target.meshes)
    col0 = sum(m.stats["collectives"] for m in meshes)
    buffers = target.buffers
    g = None
    if graphs:
        g = RoundGraphs(_tensors(buffers)[0].device)  # jaxlint: disable=R2 (one cache a contract: the audit runs each body once, as a grower's first round)
        buffers = g.load(buffers, target.fixed)
    before = _leaves(buffers)
    with _san.DispatchCounter() as dc:
        with Recorder(target.bins) as rec:
            if g is not None:
                g.run(target.key, target.body)
            else:
                target.body(buffers)
    after = _leaves(buffers)
    st = dc.stats()
    if st["host_syncs"] or st["async_resolves"]:
        rec.host_syncs.append(f"accounted reads {st['host_syncs']} + "
                              f"{st['async_resolves']}")
    ledger = {"dispatches": st["dispatches"], "replays": st["replays"],
              "mesh_collectives": sum(m.stats["collectives"] for m in meshes) - col0}
    findings = []
    if graphs and ledger["dispatches"] != 1:
        findings.append(_finding(c, "J1", f"{ledger['dispatches']} dispatches for "
                                          "one round (one replay a round)"))
    if ledger["mesh_collectives"] != len(rec.collectives):
        findings.append(_finding(
            c, "J1", f"Mesh.stats counted {ledger['mesh_collectives']} collectives, "
                     f"the recorder {len(rec.collectives)}"))
    ledger["findings"] = findings
    return rec, before, after, ledger


def audit_contract(c: Contract, device="cpu", fixture=None,
                   capture: bool = False) -> ContractResult:
    """Build ``c``'s body on ``device`` (at ``fixture``'s shape when given),
    run it once under the recorder and check J1-J7.  On the CPU a
    single-device body runs through a RoundGraphs cache (eager), as the
    grower runs it.  ``capture`` (the card): after the recorded eager
    run, capture the body through ops/graphs.py once and hold the graph's
    launch tally to the declared launches and the recorder's wrapper calls;
    and hold ``max_memory_allocated``'s rise over the eager run to J6."""
    target = c.build(device, fixture)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    rec, before, after, ledger = run_body(
        c, target, graphs=not cuda and not c.sharded)
    raw, detail = check(c, target, rec, before, after, ledger)
    if cuda:
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - base
        detail["device_peak_bytes"] = int(rise)
        if rise > detail["live_budget"]:
            raw.append(_finding(c, "J6", f"max_memory_allocated rose {rise} bytes "
                                         f"> budget {detail['live_budget']}"))
    if capture:
        from ..ops.graphs import RoundGraphs
        g = RoundGraphs(device)  # jaxlint: disable=R2 (one capture a contract is the check itself)
        g.load(target.buffers, target.fixed)
        g.run(target.key, target.body)
        tally = g.launches_per_replay().get(target.key, {})
        detail["graph_launches"] = dict(tally)
        detail["declared_launches"] = target.launches(c)
        if dict(tally) != target.launches(c) or dict(tally) != dict(rec.wrappers):
            raw.append(_finding(c, "J1", f"captured launch tally {dict(tally)} != "
                                         f"declared {target.launches(c)} / recorded "
                                         f"{dict(rec.wrappers)}"))
    findings, waived = _apply_waivers(c, raw)
    return ContractResult(c.name, findings, waived, detail)


def check_family_spine(results: Dict[str, ContractResult]) -> List[Finding]:
    """Contracts of one family share their protocol spine: the first and
    last collectives their ``spine`` names."""
    out: List[Finding] = []
    fams: Dict[str, List[Contract]] = {}
    for name in results:
        c = CONTRACTS.get(name)
        if c is not None and c.family and c.spine != (0, 0):
            fams.setdefault(c.family, []).append(c)
    for fam, cs in fams.items():
        ref = cs[0]
        p, s = ref.spine
        want = (ref.collectives[:p], ref.collectives[len(ref.collectives) - s:])
        for c in cs[1:]:
            got = (c.collectives[:p], c.collectives[len(c.collectives) - s:])
            if got != want:
                out.append(_finding(c, "J1", f"family {fam!r} spine {got} != "
                                             f"{ref.name}'s {want}"))
    return out


# ---------------------------------------------------------------------------
# the ledger cross-check: whole trees through the production round loop
# ---------------------------------------------------------------------------

_LEDGER = {"windowed_round_float": "graphs", "windowed_round_sharded_psum": "psum",
           "windowed_round_sharded_scatter": "scatter"}


def ledger_crosscheck(name: str, device="cpu") -> dict:
    """Grow one tree of contract ``name``'s fixture through
    ``_run_fused_rounds`` (the production round loop) with the recorder on:
    every round's collectives and wrapper calls are the contract's, one
    RoundGraphs dispatch a round on a single device, and the meshes'
    collectives the rounds times the declared sequence."""
    from ..ops import treegrow_windowed as tw
    from ..ops.graphs import RoundGraphs

    c = CONTRACTS[name]
    target = c.build(device, None)
    state, inputs, _info = target.buffers
    round_fn = target.round_fn
    graphs = RoundGraphs(device) if not c.sharded else None  # jaxlint: disable=R2 (one cache a tree: the cross-check grows one tree, as a training does)
    run = tw.round_runner(round_fn, state, inputs, target.fixed, target.key[:-1],
                          graphs)
    meshes = list(target.meshes)
    col0 = sum(m.stats["collectives"] for m in meshes)
    per_round: List[Tuple[List[str], dict]] = []
    rec = Recorder()

    def counted(st, W):
        c0, w0 = len(rec.collectives), Counter(rec.wrappers)
        out = run(st, W)
        per_round.append((tokens(rec.collectives[c0:]),
                          dict(Counter(rec.wrappers) - w0)))
        return out

    L = int(state.leaf_cnt.shape[0])
    n = int(state.order.shape[0])
    stats: dict = {}
    with _san.DispatchCounter() as dc:
        with rec:
            tw._run_fused_rounds(counted, state, n_ladder=n,
                                 w_first=tw._window_size(max(n // 2, 1), n),
                                 num_leaves=L, stats=stats, guard_label="")
    rounds = len(per_round)
    out = {"rounds": rounds, "dispatches": dc.dispatches, "replays": dc.replays,
           "mesh_collectives": sum(m.stats["collectives"] for m in meshes) - col0}
    bad = [i for i, (toks, w) in enumerate(per_round)
           if tuple(toks) != tuple(c.collectives) or w != target.launches(c)]
    findings = []
    if bad:
        findings.append(_finding(c, "J1", f"rounds {bad} of {rounds} differ from the "
                                          f"contract: {per_round[bad[0]]}"))
    if graphs is not None and dc.dispatches != rounds:
        findings.append(_finding(c, "J1", f"{dc.dispatches} dispatches for {rounds} "
                                          "rounds (one replay a round)"))
    if out["mesh_collectives"] != rounds * len(c.collectives):
        findings.append(_finding(c, "J1", f"Mesh.stats counted "
                                          f"{out['mesh_collectives']} collectives for "
                                          f"{rounds} rounds of "
                                          f"{len(c.collectives)}"))
    out["findings"] = findings
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _local(names: List[str], runtime: bool) -> TraceReport:
    results = [audit_contract(CONTRACTS[n]) for n in names]
    ledger: Dict[str, dict] = {}
    if runtime:
        for n in names:
            if n in _LEDGER:
                lg = ledger_crosscheck(n)
                fs = lg.pop("findings")
                ledger[_LEDGER[n]] = lg
                if fs:
                    results.append(ContractResult(f"ledger[{_LEDGER[n]}]", fs, [], {}))
    return TraceReport(results, ledger)


_SPMD_SCRIPT = r"""
import json, os
torch.set_num_threads(max(1, (os.cpu_count() or 4) // WORLD))
from lightgbm_tpu_torch.analysis import trace_audit as ta
names = json.loads(os.environ["LGBMTPU_TRACE_NAMES"])
rep = ta._local(names, os.environ["LGBMTPU_TRACE_RUNTIME"] == "1")
with open(os.path.join(WORKDIR, f"trace{RANK}.json"), "w") as fh:
    json.dump(ta.report_to_json(rep), fh, default=str)
"""


def report_to_json(rep: TraceReport) -> dict:
    return {"results": [{"name": r.name,
                         "findings": [dataclasses.asdict(f) for f in r.findings],
                         "waived": [[dataclasses.asdict(f), w] for f, w in r.waived],
                         "detail": r.detail} for r in rep.results],
            "ledger": rep.ledger}


def report_from_json(d: dict) -> TraceReport:
    res = [ContractResult(r["name"], [Finding(**f) for f in r["findings"]],
                          [(Finding(**f), w) for f, w in r["waived"]], r["detail"])
           for r in d["results"]]
    return TraceReport(res, d["ledger"])


def _sharded(names: List[str], runtime: bool, timeout_s: float = 85.0) -> TraceReport:
    """The sharded contracts on 4 gloo ranks (one run_spmd launch); every
    rank's findings, rank 0's details."""
    from ..parallel.launcher import run_spmd

    with tempfile.TemporaryDirectory(prefix="lgbt_trace_") as wd:
        run_spmd(_SPMD_SCRIPT, WORLD, wd, timeout_s=timeout_s,
                 env_extra={"LGBMTPU_TRACE_NAMES": json.dumps(names),
                            "LGBMTPU_TRACE_RUNTIME": "1" if runtime else "0"})
        reps = []
        for r in range(WORLD):
            with open(os.path.join(wd, f"trace{r}.json")) as fh:
                reps.append(report_from_json(json.load(fh)))
    base = reps[0]
    for other in reps[1:]:
        for r0, r in zip(base.results, other.results):
            seen = {f.format() for f in r0.findings}
            r0.findings.extend(f for f in r.findings if f.format() not in seen)
    return base


def in_process_group() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def run_trace_audit(names: Optional[List[str]] = None,
                    runtime: bool = True) -> TraceReport:
    """Audit the selected (default: all) contracts: the single-device ones
    here, the sharded ones on 4 gloo ranks (or here, inside a group), with
    the ledger cross-check (``runtime``)."""
    selected = list(names) if names else sorted(CONTRACTS)
    unknown = [n for n in selected if n not in CONTRACTS]
    if unknown:
        raise ValueError(f"unknown contracts {unknown}; have {sorted(CONTRACTS)}")
    single = [n for n in selected if not CONTRACTS[n].sharded]
    shard = [n for n in selected if CONTRACTS[n].sharded]
    rep = _local(single, runtime)
    if shard:
        srep = (_local(shard, runtime) if in_process_group()
                else _sharded(shard, runtime))
        rep.results.extend(srep.results)
        rep.ledger.update(srep.ledger)
    by_name = {r.name: r for r in rep.results}
    fam = check_family_spine(by_name)
    if fam:
        rep.results.append(ContractResult("family-spine", fam, [], {}))
    return rep
