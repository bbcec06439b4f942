"""Dispatch contracts for the trace audit (trace_audit.py).

Counterpart of lightgbm_tpu/analysis/contracts.py: the same nineteen
contracts under the same names, each now the port's round body.  A
contract pins what one flagship body may do when it runs, the properties
the AST rules cannot see (a captured round is handed to ``graphs.run`` as
a closure): its collectives, its host reads and copies, its float64 ops,
its live bytes, its bin-matrix sweeps and its kernel launches.  Each
bundles:

* a **builder** ``build(device, fixture)`` that makes the body from the
  port's own functions (ops/treegrow_windowed.py ``_w_init``,
  ``windowed_round_fn`` and ``round_body``; ops/treegrow_fleet.py
  ``_fleet_round``; ops/hist_cuda.py ``histogram_multi_carry`` and
  ops/treegrow_ooc.py ``split_chunk``; continual/refit.py ``make_refit_entry``; the GBDT's
  ``_raw_of``) at a small fixture shape, or at a cell's shape from the
  ``fixture`` the caller passes (chip_smoke.py's phase 26 passes its
  Higgs and Epsilon sets);
* the **declared invariants**:

  - ``collectives``: the exact ordered ``op@axis`` sequence (J1), axes
    named by parallel/mesh.py's constants; ``()`` = collective-free;
  - ``dcn_max_bytes`` / ``feature_max_bytes``: J1's per-axis byte bills
    of the hierarchical and 2-D rounds, as the JAX package pins them;
  - ``launches``: the kernel wrappers the body calls, with counts (the
    refit's a tree, times the model's trees): on the card the captured
    graph's launch tally (ops/graphs.py ``RoundGraphs.launches_per_replay``)
    must equal them;
  - ``max_f64_ops``: J3's float64 allowance;
  - ``max_h2d_bytes``: J5's threshold for host data entering the body;
  - ``live``: J6's budget, ``{"floor": bytes, <size>: bytes a unit}``:
    ``LIVE_HEADROOM`` x (the floor plus, for each size the contract
    names, its bytes a unit x the target's ``sizes``).  The sizes:
    ``cells``, a windowed round's (candidate, feature, bin) cells, 2 x
    tile x F x B (x lanes); ``rows``, the rows (x lanes) a body makes
    per-row temporaries for; ``pairs``, a traversal's (row, tree) pairs.
    Each value is fitted to two readings of the body's live bytes: at
    its fixture (the CPU's recorder and the card's
    ``max_memory_allocated`` rise, the larger) and at chip_smoke.py's
    phase 26 cell (the card's rise); the static buffers the body writes
    in place are not in it, so a body that duplicates its state fails;
  - ``bin_sweeps``: J7's budget of bin-matrix sweeps (None: not pinned;
    the estimate means something only at the W = N fixture shape, as in
    the JAX package);
  - ``waivers``: ``{"J<n>": "reason"}``, reason mandatory.

On the CPU the objectives' exp and log run in numpy (ROADMAP C21, C25),
so a converted predict and the refit lift their gradients or outputs into
the body, 4 bytes a row: at the fixtures' 128 rows that stays under J5's
threshold, and on the card, where torch's kernels run, there is none.

The port departs from the JAX contracts where its design does (each
contract's ``departure`` says how): sharded rounds run eagerly (ROADMAP
C17), so no sharded body is captured (J2 still holds: the eager body
writes its state in place through ``round_body``); the
"sharded megakernel" is B3 unfused (``lgbt_round_unfused``) plus the
exact merge; the merge is the exact fixed-point one (C16), so the
collective sequences are the port's, not the JAX package's; the
three-pass round sweeps the bin matrix once (B1's window mode reads the
window's rows through the order), not three times.

Builders import nothing of JAX.  The sharded builders need a process
group of 4 ranks (trace_audit.py starts one over gloo on the CPU, one
``run_spmd`` launch).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# shared fixture shapes (the JAX package's): far below one W-ladder rung,
# so every windowed body runs the one rung W = 8192 (the ladder's floor)
_N, _F, _L, _TILE, _BINS = 512, 8, 7, 4, 32
# the W = N sweep-pin shape: one rung, f = 64 and tile 2 keep the
# go-left column reads (tile / f of a sweep) small
_NS, _FS, _TILES = 8192, 64, 2
WORLD = 4  # the sharded contracts' ranks (trace_audit.py starts them)
_HIER_TOPK = 4  # below F: a real top-k vote
_KB = 1 << 10
# J6: a budget is this many times the live bytes its values were fitted to
LIVE_HEADROOM = 1.5


@dataclasses.dataclass
class Target:
    """What a builder hands the auditor: ``body(buffers)`` runs one round
    in place on ``buffers`` (a tree of tensors: the static buffers);
    ``fixed`` are the tensors it reads where they lie; ``bins`` is the bin
    matrix J7 counts sweeps of; ``meshes`` the Mesh objects whose stats
    the ledger reads; ``key`` the capture key."""

    body: Callable
    buffers: object
    fixed: tuple = ()
    bins: Optional[torch.Tensor] = None
    meshes: tuple = ()
    key: tuple = ("contract",)
    note: str = ""
    round_fn: Optional[Callable] = None  # windowed: the grower's round_fn
    # J6's units by size (module docstring): cells, rows, pairs
    sizes: Mapping[str, int] = dataclasses.field(default_factory=dict)
    repeat: int = 1  # the declared launches are a tree's: times the trees
    # False where the body takes its plain route, which calls no kernel
    # wrapper (the traversal on the CPU: GBDT._raw_of's chunked walk)
    kernels: bool = True

    def launches(self, c: "Contract") -> dict:
        """The launches ``c`` declares for this body."""
        if not self.kernels:
            return {}
        return {k: v * self.repeat for k, v in c.launches.items()}


@dataclasses.dataclass(frozen=True)
class Contract:
    name: str
    description: str
    build: Callable[..., Target]
    collectives: Tuple[str, ...]
    launches: Mapping[str, int]
    max_f64_ops: int
    max_h2d_bytes: int
    live: Mapping[str, int]
    family: str
    spine: Tuple[int, int]
    waivers: Mapping[str, str]
    file: str
    line: int
    sharded: bool = False
    bin_sweeps: Optional[float] = None
    dcn_max_bytes: Optional[int] = None
    feature_max_bytes: Optional[int] = None
    departure: str = ""

    def live_budget(self, target: Target) -> int:
        """J6's budget for ``target`` (module docstring)."""
        per = dict(self.live)
        floor = per.pop("floor", 0)
        return int(LIVE_HEADROOM * (floor + sum(v * target.sizes.get(k, 0)
                                                for k, v in per.items())))


CONTRACTS: Dict[str, Contract] = {}


def contract(name: str, *, description: str,
             collectives: Tuple[str, ...] = (),
             launches: Optional[Mapping[str, int]] = None,
             max_f64_ops: int = 0,
             max_h2d_bytes: int = 4096,
             live: Optional[Mapping[str, int]] = None,
             family: str = "",
             spine: Tuple[int, int] = (0, 0),
             waivers: Optional[Mapping[str, str]] = None,
             sharded: bool = False,
             bin_sweeps: Optional[float] = None,
             dcn_max_bytes: Optional[int] = None,
             feature_max_bytes: Optional[int] = None,
             departure: str = ""):
    """Register a contract; the decorated function is its builder."""

    def deco(build: Callable[..., Target]) -> Callable[..., Target]:
        if name in CONTRACTS:
            raise ValueError(f"duplicate contract {name!r}")
        frame = inspect.stack()[1]
        CONTRACTS[name] = Contract(
            name=name, description=description, build=build,
            collectives=tuple(collectives or ()), launches=dict(launches or {}),
            max_f64_ops=max_f64_ops, max_h2d_bytes=max_h2d_bytes,
            live=dict(live or {}),
            family=family, spine=spine, waivers=dict(waivers or {}),
            file=frame.filename, line=frame.lineno, sharded=sharded,
            bin_sweeps=bin_sweeps,
            dcn_max_bytes=dcn_max_bytes, feature_max_bytes=feature_max_bytes,
            departure=departure)
        return build

    return deco


# ---------------------------------------------------------------------------
# shared builders
# ---------------------------------------------------------------------------

def _split_params():
    from ..ops.split import SplitParams
    return SplitParams(min_data_in_leaf=5)


def windowed_fixture(device, n: int = _N, f: int = _F, num_bins: int = _BINS,
                     num_leaves: int = _L, tile: int = _TILE, seed: int = 0) -> dict:
    """A windowed body's data: random bins and gradients made from a seed
    with numpy (the same on every rank: a sharded builder takes its rows)."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, num_bins, size=(n, f)).astype(np.int16)
    grad = (rng.randn(n) + 0.5 * (bins[:, 0] > num_bins // 2)).astype(np.float32)
    hess = (0.5 + rng.rand(n)).astype(np.float32)
    dev = torch.device(device)
    return dict(
        bins=torch.as_tensor(bins, device=dev), grad=torch.as_tensor(grad, device=dev),
        hess=torch.as_tensor(hess, device=dev),
        nbpf=torch.full((f,), num_bins, dtype=torch.int32, device=dev),
        mbpf=torch.full((f,), -1, dtype=torch.int32, device=dev),
        num_bins=num_bins, num_leaves=num_leaves, tile=tile)


def _windowed_target(fx: dict, *, quantize_bins: int = 0,
                     megakernel: bool = False, sharding=None, rows=None,
                     feature_mask=None, meshes: tuple = (), note: str = "") -> Target:
    """One windowed round at the fixture's first round, as the grower runs
    it: ``_w_init`` (outside the body), then ``round_body`` of
    ``windowed_round_fn`` on the static buffers (state, inputs, info)."""
    from ..ops import treegrow_windowed as tw

    bins, grad, hess = fx["bins"], fx["grad"], fx["hess"]
    if rows is not None:
        bins, grad, hess = bins[rows].contiguous(), grad[rows], hess[rows]
    bins = fx.get("bins_local", bins)
    nbpf, mbpf = fx["nbpf"], fx["mbpf"]
    dev = bins.device
    n = bins.shape[0]
    L, B, T = fx["num_leaves"], fx["num_bins"], fx["tile"]
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    fmask = (torch.ones(nbpf.shape[0], dtype=torch.bool, device=dev)
             if feature_mask is None else feature_mask)
    params = _split_params()
    static = dict(num_leaves=L, num_bins=B, max_depth=-1, params=params,
                  leaf_tile=T, quantize_bins=quantize_bins, megakernel=megakernel,
                  hist_precision="f32")
    state, inputs, _, _ = tw._w_init(
        bins, grad, hess, mask, torch.ones(n, device=dev), nbpf, mbpf, fmask,
        num_leaves=L, num_bins=B, params=params, quantize_bins=quantize_bins,
        stochastic_rounding=False, generator=None, sharding=sharding)
    W = tw._window_size(max(n // 2 if sharding is None else n, 1), n)
    info = torch.zeros(tw.INFO, dtype=torch.int32, device=dev)
    round_fn = tw.windowed_round_fn(bins, nbpf, mbpf, (None, None), None, sharding,
                                    static)
    return Target(tw.round_body(round_fn, W), (state, inputs, info),
                  fixed=(bins, nbpf, mbpf), bins=bins, meshes=meshes,
                  key=("windowed",) + tuple(static.items()) + (W,), note=note,
                  round_fn=round_fn, sizes={"cells": 2 * T * bins.shape[1] * B})


def _fixture_or(fixture, device, **kw) -> dict:
    return fixture if fixture is not None else windowed_fixture(device, **kw)


# ---------------------------------------------------------------------------
# windowed round, single device (ops/treegrow_windowed.py::_round_fused)
# ---------------------------------------------------------------------------

_THREE_PASS_F32 = {"partition_segments": 1, "histogram_window": 1}
# J6 (module docstring; the readings beside each budget in PERF.md section
# 6): a three-pass round's live bytes grow with its (candidate, feature,
# bin) cells, the torch split search's gain planes: 122.3 bytes a cell at
# the Epsilon cell in f32, 121.7 in int8 (fitted to the card's cell and
# fixture readings once the window pass read its rows through the order);
# the floors are the fixtures'.  A merge that scatters the features over
# R ranks searches 1/R of the cells on each.
_SEARCH_F32, _SEARCH_I8 = 123, 122
# the torch split search's per-feature prefix sums: one float64 cast and
# one cumsum a search (ops/split.py: exact, rounded once to f32); the
# megakernel's search runs in B3
_SEARCH_F64 = 2
_THREE_PASS_I8 = {"partition_segments": 1, "histogram_window_quantized": 1}


@contract(
    "windowed_round_float",
    description="single-device windowed round, three-pass, float histograms "
                "(_round_fused through round_body): one replay a round; "
                "collective-free, f64-free, read-free, its static buffers "
                "written in place",
    launches=_THREE_PASS_F32,
    max_f64_ops=_SEARCH_F64,
    live={"floor": 38 * _KB, "cells": _SEARCH_F32},
    family="windowed_single",
)
def _build_windowed_round_float(device="cpu", fixture=None) -> Target:
    return _windowed_target(_fixture_or(fixture, device),
                            note="three-pass round: B2 partition, B1 float "
                                 "window pass through the order")


@contract(
    "windowed_round_quantized",
    description="single-device windowed round, int8-quantized gradients "
                "(the three-pass round: B2, B1's exact int8 window pass); "
                "the same contract as the float round",
    launches=_THREE_PASS_I8,
    max_f64_ops=_SEARCH_F64,
    live={"floor": 40 * _KB, "cells": _SEARCH_I8},
    family="windowed_single",
)
def _build_windowed_round_quantized(device="cpu", fixture=None) -> Target:
    return _windowed_target(_fixture_or(fixture, device), quantize_bins=16)


@contract(
    "windowed_round_megakernel",
    description="single-device megakernel round (B3, ops/round_cuda.py::"
                "round_megakernel): partition, window histograms and the "
                "per-feature search in one launch; collective-free and one "
                "bin-matrix sweep (plus the go-left columns) at W = N",
    launches={"round_megakernel": 1},
    # B3 runs the search in its own launch: 29.0 bytes a cell at Epsilon
    live={"floor": 456 * _KB, "cells": 30},
    family="windowed_single",
    bin_sweeps=1.1,
)
def _build_windowed_round_megakernel(device="cpu", fixture=None) -> Target:
    fx = _fixture_or(fixture, device, n=_NS, f=_FS, tile=_TILES)
    return _windowed_target(fx, megakernel=True)


@contract(
    "windowed_round_three_pass_sweeps",
    description="the three-pass round at the megakernel's W = N fixture: "
                "J7 counts its one bin-matrix sweep (B1's window mode, "
                "hist_cuda.histogram_window: the window's rows read through "
                "the order, no gathered copy) beside the megakernel's one",
    launches=_THREE_PASS_F32,
    max_f64_ops=_SEARCH_F64,
    # the W = N fixture's window rows and slots: a larger floor
    live={"floor": 218 * _KB, "cells": _SEARCH_F32},
    family="windowed_single",
    bin_sweeps=1.1,
    departure="one sweep, not the JAX round's three (gather, transpose, "
              "histogram): B1's window mode reads the window's rows through "
              "the order, with no copy and no transpose",
)
def _build_windowed_round_three_pass_sweeps(device="cpu", fixture=None) -> Target:
    fx = _fixture_or(fixture, device, n=_NS, f=_FS, tile=_TILES)
    return _windowed_target(fx)


# ---------------------------------------------------------------------------
# sharded rounds (ops/treegrow_windowed.py::_round_sharded) — 4 gloo ranks
# ---------------------------------------------------------------------------

def _rank_rows(n: int, mesh_size: int, rank: int):
    per = -(-n // mesh_size)
    lo = min(rank * per, n)
    return lo, slice(lo, min(lo + per, n))



# the data-parallel round's protocol, one op@axis a collective: the
# global physical counts that choose each round's window child (one psum
# of the segments' left counts and lengths) and the window check (fits:
# pmin; rows: pmax) ...
_ROUND_PREFIX = ("psum@data", "pmin@data", "pmax@data")
# ... the exact merge of the window sums (ops/histogram.py::merge_carry:
# the int64 fixed-point grad / hess sums, then the int32 counts) ...
_MERGE = ("psum@data", "psum@data")
# ... and the info merges after the search (the next bound: pmax; finite:
# pmin)
_ROUND_SUFFIX = ("pmax@data", "pmin@data")
# the owned-feature winner election (ops/treegrow.py::elect_best): the
# gain max, the lowest-rank tie-break, the packed winner broadcast by a
# masked psum
_ELECTION = ("pmax@data", "pmin@data", "psum@data")
# the carried float window pass, merged and converted once
_CARRIED = {"partition_segments": 1, "histogram_window_carry": 1,
            "carry_convert": 1}


def _data_sharded_target(device, fixture, merge: str, megakernel: bool = False,
                         quantize_bins: int = 0) -> Target:
    from ..ops import treegrow_windowed as tw
    from ..parallel.mesh import RowShard, make_mesh

    fx = _fixture_or(fixture, device)
    mesh = make_mesh()
    n = fx["bins"].shape[0]
    lo, rows = _rank_rows(n, mesh.size, mesh.rank)
    shard = RowShard(mesh, lo, n)
    fmask = torch.ones(fx["nbpf"].shape[0], dtype=torch.bool,
                       device=fx["bins"].device)
    sh = tw._sharding(shard, merge, None, None, None, fx["nbpf"], fx["mbpf"],
                      fmask, None, None)
    return _windowed_target(fx, megakernel=megakernel, quantize_bins=quantize_bins,
                            sharding=sh, rows=rows, meshes=(mesh,),
                            note=f"merge={merge!r} over {mesh.size} ranks"
                                 + (", B3 unfused" if megakernel else ""))


@contract(
    "windowed_round_sharded_psum",
    description="sharded windowed round, merge='psum' (tree_learner=data): "
                "exactly ONE large collective, the exact histogram merge, "
                "plus the declared scalar protocol merges, all on the data "
                "axis, in order",
    collectives=_ROUND_PREFIX + _MERGE + _ROUND_SUFFIX,
    launches=_CARRIED,
    max_f64_ops=_SEARCH_F64,
    live={"floor": 3 * _KB, "cells": _SEARCH_F32},
    family="windowed_sharded",
    spine=(len(_ROUND_PREFIX), len(_ROUND_SUFFIX)),
    sharded=True,
    departure="eager (C17); the merge is the exact fixed-point sum (C16), "
              "two collectives (sums, counts) where the JAX round has one",
)
def _build_windowed_round_sharded_psum(device="cpu", fixture=None) -> Target:
    return _data_sharded_target(device, fixture, "psum")


@contract(
    "windowed_round_sharded_scatter",
    description="sharded windowed round, merge='scatter' (tree_learner="
                "voting): ONE large collective, the reduce-scatter of the "
                "window sums over the feature blocks, then the owned-feature "
                "winner election (small operands); the psum round's spine",
    collectives=(_ROUND_PREFIX + ("psum_scatter@data",) * 2 + _ELECTION
                 + _ROUND_SUFFIX),
    launches=_CARRIED,
    max_f64_ops=_SEARCH_F64,
    live={"floor": 6 * _KB, "cells": _SEARCH_F32 // WORLD},
    family="windowed_sharded",
    spine=(len(_ROUND_PREFIX), len(_ROUND_SUFFIX)),
    sharded=True,
    departure="eager (C17); the election broadcasts the packed best split "
              "in one masked psum, not one a field",
)
def _build_windowed_round_sharded_scatter(device="cpu", fixture=None) -> Target:
    return _data_sharded_target(device, fixture, "scatter")


@contract(
    "windowed_round_sharded_megakernel_psum",
    description="sharded round with B3 unfused (round_partition_window: "
                "partition and window sums in one launch, left in fixed "
                "point) and the exact merge: the IDENTICAL collective "
                "protocol as the three-pass psum round",
    collectives=_ROUND_PREFIX + _MERGE + _ROUND_SUFFIX,
    launches={"round_partition_window": 1, "carry_convert": 1},
    max_f64_ops=_SEARCH_F64,
    live={"floor": 23 * _KB, "cells": _SEARCH_F32},
    family="windowed_sharded",
    spine=(len(_ROUND_PREFIX), len(_ROUND_SUFFIX)),
    sharded=True,
    departure="the port's sharded megakernel is B3 unfused plus the exact "
              "merge (C17): the fused tail runs after the merge in torch",
)
def _build_windowed_round_sharded_megakernel_psum(device="cpu", fixture=None
                                                  ) -> Target:
    return _data_sharded_target(device, fixture, "psum", megakernel=True)


# ---- hierarchical (parallel/hierarchy.py): 2 slices x 2 ranks ------------

# the dcn bill a round: the top-k vote's gathers and the elected columns'
# merge, C = 2 x tile candidates x 3 channels x k features x B bins in
# fixed point (8 bytes), plus slack for the scalars
_HIER_DCN_BUDGET = 2 * _TILE * 3 * _HIER_TOPK * _BINS * 8 + 2048
# the scalar protocol spans the world (every rank agrees on the window
# and the info); the slice merge rides ici as the flat round's rides data
_HIER_PREFIX = tuple(t.replace("@data", "@world") for t in _ROUND_PREFIX)
_HIER_SUFFIX = tuple(t.replace("@data", "@world") for t in _ROUND_SUFFIX)
_HIER_MERGE = tuple(t.replace("@data", "@ici") for t in _MERGE)
# the dcn vote: the k gains and feature ids gathered, then the elected
# columns' sums and counts merged (the only histogram-shaped dcn operand)
_HIER_VOTE = ("all_gather@dcn", "all_gather@dcn", "psum@dcn", "psum@dcn")


def _hier_target(device, fixture, merge: str) -> Target:
    from ..parallel.hierarchy import SlicedData, hierarchical_sharding
    from ..parallel.mesh import make_mesh_hierarchical

    fx = _fixture_or(fixture, device)
    mesh = make_mesh_hierarchical(2)
    n = fx["bins"].shape[0]
    _, rows = _rank_rows(n, mesh.size, mesh.rank)
    sliced = SlicedData(mesh, fx["bins"][rows], fx["nbpf"], fx["mbpf"])
    fmask = torch.ones(fx["nbpf"].shape[0], dtype=torch.bool,
                       device=fx["bins"].device)
    sh = hierarchical_sharding(sliced, merge, _HIER_TOPK, fmask)
    return _windowed_target(dict(fx, bins_local=sliced.bins), sharding=sh,
                            rows=rows, meshes=tuple(mesh.axes.values()),
                            note=f"(dcn, ici) = {mesh.shape}, merge={merge!r}, "
                                 f"top_k={_HIER_TOPK}")


@contract(
    "windowed_round_hierarchical_psum",
    description="two-level round over the (dcn, ici) mesh, intra-slice "
                "merge='psum': the slice's histogram merge on ici as the "
                "flat round's on data, the scalar protocol on the world, "
                "and the only histogram-shaped dcn traffic the top-k "
                "exchange, byte bill pinned",
    collectives=_HIER_PREFIX + _HIER_MERGE + _HIER_VOTE + _HIER_SUFFIX,
    launches={"partition_segments": 1, "histogram_window_carry": 1,
              "carry_convert": 2},
    # the vote searches the root's and each candidate's elected tables
    max_f64_ops=_SEARCH_F64 * (1 + 2 * _TILE),
    live={"floor": 99 * _KB, "cells": _SEARCH_F32},
    family="windowed_hierarchical",
    spine=(len(_HIER_PREFIX), len(_HIER_SUFFIX)),
    sharded=True,
    dcn_max_bytes=_HIER_DCN_BUDGET,
    departure="eager (C17); the slice sums stay in fixed point until the vote",
)
def _build_windowed_round_hierarchical_psum(device="cpu", fixture=None) -> Target:
    return _hier_target(device, fixture, "psum")


@contract(
    "windowed_round_hierarchical_voting",
    description="two-level round, intra-slice merge='scatter' (tree_learner="
                "voting x num_slices > 1): reduce-scatter and the owned-"
                "feature election over ici, the top-k exchange over dcn "
                "inside each rank's block, byte bill pinned",
    collectives=(_HIER_PREFIX + ("psum_scatter@ici",) * 2
                 + ("psum@dcn", "psum@dcn")
                 + tuple(t.replace("@data", "@ici") for t in _ELECTION)
                 + _HIER_SUFFIX),
    launches=_CARRIED,
    max_f64_ops=_SEARCH_F64,
    live={"floor": 5 * _KB, "cells": _SEARCH_F32 // 2},  # 2 ici ranks
    family="windowed_hierarchical",
    spine=(len(_HIER_PREFIX), len(_HIER_SUFFIX)),
    sharded=True,
    dcn_max_bytes=_HIER_DCN_BUDGET,
    departure="eager (C17); at the exhaustive top-k of the owned block the "
              "slice sums merge over dcn whole (no gathers)",
)
def _build_windowed_round_hierarchical_voting(device="cpu", fixture=None) -> Target:
    return _hier_target(device, fixture, "scatter")


# ---- 2-D (parallel/feature2d.py): 2 row blocks x 2 feature blocks ---------

# the feature axis a round: the go-left decisions (one masked psum of an
# (N_loc,) mask as uint8 / int32) and the election's packed best split
_2D_FEATURE_BUDGET = 2 * _N * 4 + 4096
# the go-left decisions first (one masked psum over the feature axis),
# then the row-domain protocol on the data axis alone (the feature axis
# holds the same rows); the election over the feature axis
_2D_PREFIX = ("psum@feature",) + _ROUND_PREFIX
_2D_ELECTION = tuple(t.replace("@data", "@feature") for t in _ELECTION)


def _2d_target(device, fixture, quantize_bins: int) -> Target:
    from ..ops.treegrow_windowed import Sharding, feature_block_tables
    from ..parallel.feature2d import Sharded2DData
    from ..parallel.mesh import FEATURE_AXIS, make_mesh_2d

    fx = _fixture_or(fixture, device)
    mesh = make_mesh_2d(2, 2)
    n = fx["bins"].shape[0]
    _, rows = _rank_rows(n, 2, mesh.coords[0])
    sd = Sharded2DData(mesh, fx["bins"][rows], fx["nbpf"], fx["mbpf"])
    feature = mesh.axes[FEATURE_AXIS]
    fmask = torch.ones(fx["nbpf"].shape[0], dtype=torch.bool,
                       device=fx["bins"].device)
    tables = feature_block_tables(sd.f0, sd.k, sd.f_pad, sd.num_bins_pf,
                                  sd.missing_bin_pf, fmask, None, None)
    sh = Sharding(sd.shard, "psum", sd.f0, tables, own_mesh=feature,
                  feature_mesh=feature)
    return _windowed_target(dict(fx, bins_local=sd.bins), sharding=sh, rows=rows,
                            quantize_bins=quantize_bins, feature_mask=fmask,
                            meshes=tuple(mesh.axes.values()),
                            note=f"(data, feature) = {mesh.shape}")


@contract(
    "windowed_round_2d_float",
    description="2-D (data x feature) round, float: the histogram merge is "
                "over the data axis ALONE (zero feature-axis histogram "
                "collectives), then the owned-feature election and the "
                "go-left broadcast, the only feature-axis traffic, byte-"
                "billed",
    collectives=_2D_PREFIX + _MERGE + _2D_ELECTION + _ROUND_SUFFIX,
    launches=_CARRIED,
    max_f64_ops=_SEARCH_F64,
    live={"floor": 7 * _KB, "cells": _SEARCH_F32},
    family="windowed_2d",
    spine=(len(_2D_PREFIX), len(_ROUND_SUFFIX)),
    sharded=True,
    feature_max_bytes=_2D_FEATURE_BUDGET,
    departure="eager (C17)",
)
def _build_windowed_round_2d_float(device="cpu", fixture=None) -> Target:
    return _2d_target(device, fixture, 0)


@contract(
    "windowed_round_2d_quantized",
    description="2-D round, int8-quantized gradients: the same sequence "
                "and feature-axis bill as the float round",
    collectives=(_2D_PREFIX + ("psum@data",) + _2D_ELECTION + _ROUND_SUFFIX),
    launches=_THREE_PASS_I8,
    max_f64_ops=_SEARCH_F64,
    live={"floor": 8 * _KB, "cells": _SEARCH_I8},
    family="windowed_2d",
    spine=(len(_2D_PREFIX), len(_ROUND_SUFFIX)),
    sharded=True,
    feature_max_bytes=_2D_FEATURE_BUDGET,
    departure="eager (C17); the int8 window histograms merge as one int32 "
              "psum (ops/histogram.py::merge_int)",
)
def _build_windowed_round_2d_quantized(device="cpu", fixture=None) -> Target:
    return _2d_target(device, fixture, 16)


# ---------------------------------------------------------------------------
# prediction (GBDT._raw_of: on the card the traversal kernel,
# ops/predict_cuda.py::predict_trees, one launch; on the CPU the plain walk
# and sum of ops/predict.py) and the continual refit
# ---------------------------------------------------------------------------

_PN, _PF = 128, 8  # bucket rows, features
# J6: the plain walk's temporaries, (tree, row) node, feature and value
# tensors: 68.4 bytes a pair at the Higgs cell, a floor from the fixture
# (the kernel route holds only its answers)
_TRAVERSAL_LIVE = {"floor": 8 * _KB, "pairs": 69}
_TRAVERSAL_LAUNCHES = {"predict_trees": 1}


def tiny_booster(device="cpu", objective: str = "binary", num_class: int = 1,
                 iterations: int = 2):
    """A small booster trained by the port (the predict, converted and
    refit contracts audit the model's real entries, not a replica)."""
    import lightgbm_tpu_torch as lgb

    rng = np.random.RandomState(0)
    X = rng.randn(192, _PF)
    s = X[:, 0] + 0.25 * X[:, 1]
    y = (np.digitize(s, [-0.5, 0.0, 0.5]) if num_class > 1
         else (s > 0).astype(np.float64))
    p = {"objective": objective, "num_leaves": 4, "min_data_in_leaf": 5,
         "verbosity": -1, "device_type": "cpu" if str(device) == "cpu" else "cuda"}
    if num_class > 1:
        p["num_class"] = num_class
    bst = lgb.train(p, lgb.Dataset(X, label=y, params=p), iterations)
    return bst._gbdt


def _predict_target(gbdt, x: torch.Tensor, convert: bool = False,
                    note: str = "") -> Target:
    """The device part of a warm predict: the traversal of the cached pack
    (``_raw_of``), converted by the objective with ``convert``, written
    into a static output buffer; the pinned read that follows is outside
    the body."""
    s = gbdt._packed(0, -1)
    k = gbdt.num_tree_per_iteration
    out = torch.zeros((x.shape[0],) if k == 1 else (x.shape[0], k),
                      dtype=torch.float32, device=x.device)

    def body(b):
        xs, dst = b
        raw = gbdt._raw_of(s, xs)
        dst.copy_(gbdt.objective.convert_output(raw) if convert else raw)

    walk = tuple(v for v in s["walk"].values() if torch.is_tensor(v))
    return Target(body, (x, out), fixed=walk, key=("predict", k, convert),
                  note=note or f"{x.shape[0]} rows, {len(s['trees'])} trees",
                  sizes={"pairs": x.shape[0] * len(s["trees"])}, kernels=x.is_cuda)


def _predict_rows(device, fixture, n: int = _PN):
    if fixture is not None and "x" in fixture:
        return fixture["x"]
    rng = np.random.RandomState(1)
    return torch.as_tensor(rng.randn(n, _PF).astype(np.float32),
                           device=torch.device(device))


@contract(
    "predict_warm_single",
    description="warm single-class predict traversal (GBDT._raw_of: the "
                "traversal kernel's one launch on the card, the plain walk "
                "and sum on the CPU) on a bucket-padded batch: no "
                "collective, no read, no host data inside",
    launches=_TRAVERSAL_LAUNCHES,
    live=_TRAVERSAL_LIVE,
)
def _build_predict_warm_single(device="cpu", fixture=None) -> Target:
    gbdt = fixture["gbdt"] if fixture else tiny_booster(device)
    return _predict_target(gbdt, _predict_rows(device, fixture))


@contract(
    "predict_warm_multiclass",
    description="warm multiclass predict (k = 4): every class reduced in "
                "the same traversal, one launch of the kernel over a (rows, "
                "classes) grid on the card, no per-class loop",
    launches=_TRAVERSAL_LAUNCHES,
    live=_TRAVERSAL_LIVE,
)
def _build_predict_warm_multiclass(device="cpu", fixture=None) -> Target:
    gbdt = (fixture["gbdt_mc"] if fixture and "gbdt_mc" in fixture
            else tiny_booster(device, "multiclass", 4))
    return _predict_target(gbdt, _predict_rows(device, fixture))


@contract(
    "predict_warm_converted",
    description="converted predict: the traversal (the kernel's one "
                "launch on the card) and objective.convert_output in one "
                "device body, audited on a real binary booster",
    launches=_TRAVERSAL_LAUNCHES,
    live=_TRAVERSAL_LIVE,
)
def _build_predict_warm_converted(device="cpu", fixture=None) -> Target:
    gbdt = fixture["gbdt"] if fixture else tiny_booster(device)
    return _predict_target(gbdt, _predict_rows(device, fixture), convert=True)


@contract(
    "predict_coalesced_bucket",
    description="the serving runtime's coalesced batch (serve/runtime.py -> "
                "GBDT.predict_coalesced): K requests staged into one rung "
                "run the SAME traversal as a warm predict (one kernel "
                "launch on the card), so a serve-owned second entry, a "
                "collective or an in-body copy fails here",
    launches=_TRAVERSAL_LAUNCHES,
    live=_TRAVERSAL_LIVE,
)
def _build_predict_coalesced_bucket(device="cpu", fixture=None) -> Target:
    from ..models.gbdt import _predict_bucket

    gbdt = fixture["gbdt"] if fixture else tiny_booster(device)
    rows = _predict_rows(device, fixture)
    cuts = np.cumsum([0, 1, 7, 64, 30])
    reqs = [rows[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    x = torch.cat(reqs)
    nb = _predict_bucket(x.shape[0])
    staged = torch.zeros((nb, x.shape[1]), dtype=torch.float32, device=x.device)
    staged[:x.shape[0]] = x
    return _predict_target(gbdt, staged, convert=True,
                           note=f"{len(reqs)} requests, {x.shape[0]} rows in "
                                f"the {nb}-row rung")


@contract(
    "continual_refit_leaves",
    description="the continual runner's leaf refit (continual/refit.py::"
                "make_refit_entry): the per-tree gradients at the running "
                "score, B1's per-leaf sums and the renewed tables in one "
                "device body, collective-free and read-free",
    launches={"histogram_multi": 1},
    # the gradients at the running score, a row's: 49.2 bytes at Higgs
    live={"floor": 2 * _KB, "rows": 50},
)
def _build_continual_refit_leaves(device="cpu", fixture=None) -> Target:
    from ..continual import refit

    gbdt = fixture["gbdt"] if fixture else tiny_booster(device)
    s = gbdt._packed(0, -1)
    dev = gbdt.device
    lv0, shrink = refit._tables(s["trees"], dev)
    rng = np.random.RandomState(2)
    xs = (fixture["x"] if fixture and "x" in fixture
          else torch.as_tensor(rng.randn(_PN, _PF).astype(np.float32), device=dev))
    leaves = refit._traverse(gbdt, s, xs)
    label = (fixture["y"] if fixture and "y" in fixture
             else torch.as_tensor((rng.rand(xs.shape[0]) < 0.5).astype(np.float32),
                                  device=dev))
    entry = refit.make_refit_entry(gbdt.objective, float(gbdt.cfg.refit_decay_rate),
                                   float(gbdt.cfg.lambda_l2))
    out = torch.zeros_like(lv0)

    def body(b):
        lv, sh, lf, lab, dst = b
        dst.copy_(entry(lv, sh, lf, lab, None))

    return Target(body, (lv0, shrink, leaves, label, out), key=("refit",),
                  note=f"{lv0.shape[0]} trees, {leaves.shape[0]} rows",
                  repeat=lv0.shape[0], sizes={"rows": leaves.shape[0]})


# ---------------------------------------------------------------------------
# fleet round (ops/treegrow_fleet.py::_fleet_round)
# ---------------------------------------------------------------------------

_FB = 4  # lanes


@contract(
    "fleet_round_batched",
    description="the fleet round (B boosters a round): the solo round's "
                "stages a lane around ONE lane-mode B2 and ONE lane-mode B1 "
                "launch, and the (B, 6) -> (6,) info fold; zero collectives, "
                "the stacked state written in place, live bytes linear in B",
    launches={"partition_segments_lanes": 1, "histogram_multi_lanes": 1},
    max_f64_ops=_SEARCH_F64 * _FB,  # a lane's search each
    # fitted to the fixture (4 x 512 rows) and Higgs (4 x 1M rows)
    live={"rows": 36, "cells": 62},
    family="fleet",
    departure="the lanes' stages run lane by lane around the lane-mode "
              "kernels (A26), not as one vmapped body",
)
def _build_fleet_round_batched(device="cpu", fixture=None) -> Target:
    from ..ops import treegrow_fleet as tf
    from ..ops import treegrow_windowed as tw

    fx = _fixture_or(fixture, device)
    lanes = int(fx.get("lanes", _FB))
    bins, nbpf, mbpf = fx["bins"], fx["nbpf"], fx["mbpf"]
    dev = bins.device
    n = bins.shape[0]
    L, B, T = fx["num_leaves"], fx["num_bins"], fx["tile"]
    params = _split_params()
    fmask = torch.ones(nbpf.shape[0], dtype=torch.bool, device=dev)
    states, inputs = [], []
    for b in range(lanes):
        g = torch.roll(fx["grad"], 17 * b)
        st, inp, _, _ = tw._w_init(
            bins, g, fx["hess"], torch.ones(n, dtype=torch.bool, device=dev),
            torch.ones(n, device=dev), nbpf, mbpf, fmask, num_leaves=L,
            num_bins=B, params=params, quantize_bins=0, stochastic_rounding=False,
            generator=None, check_finite=False)
        states.append(st)
        inputs.append(inp)
    static = dict(num_leaves=L, num_bins=B, max_depth=-1, params=params,
                  leaf_tile=T, quantize_bins=0, hist_precision="f32")
    floor = tf.lane_floor(lanes)
    W = tw._window_size(max(n // 2, 1), n, floor)

    def round_fn(sts, inps, W_):
        return tf._fleet_round(sts, inps, bins, nbpf, mbpf, W=W_, **static)

    info = torch.zeros(tw.INFO, dtype=torch.int32, device=dev)
    return Target(tw.round_body(round_fn, W), (tuple(states), tuple(inputs), info),
                  fixed=(bins, nbpf, mbpf), bins=bins,
                  key=("fleet", lanes) + tuple(static.items()) + (W,),
                  note=f"{lanes} lanes", sizes={"cells": lanes * 2 * T * bins.shape[1] * B,
                                                "rows": lanes * n})


# ---------------------------------------------------------------------------
# spill grower chunk steps (ops/treegrow_ooc.py)
# ---------------------------------------------------------------------------

_CN, _CC = 4096, 1024  # resident rows, chunk rows


def _ooc_fixture(device, fixture):
    fx = _fixture_or(fixture, device, n=_CN)
    from ..ops.hist_cuda import CarryAccumulator, fixed_shift_tensor
    dev = fx["bins"].device
    n, f = fx["bins"].shape
    cc = int(fx.get("chunk_rows", _CC))
    shift = fixed_shift_tensor(fx["grad"], fx["hess"])
    acc = CarryAccumulator(1, f, fx["num_bins"], shift, dev)
    return fx, dev, n, cc, acc


@contract(
    "ooc_root_chunk",
    description="spill-grower root-pass chunk step: B1's carried "
                "sums of one streamed chunk added into the pass's accumulator "
                "in place, one launch a chunk, no read",
    launches={"histogram_multi_carry": 1},
    live={},  # it makes nothing, at the fixture and at Higgs
)
def _build_ooc_root_chunk(device="cpu", fixture=None) -> Target:
    from ..ops.hist_cuda import histogram_multi_carry

    fx, dev, n, cc, acc = _ooc_fixture(device, fixture)
    chunk = fx["bins"][:cc].contiguous()
    slot = torch.zeros(n, dtype=torch.int32, device=dev)
    mask = torch.ones(cc, dtype=torch.bool, device=dev)

    def body(b):
        a64, a32, m = b
        acc.acc64, acc.acc32 = a64, a32
        histogram_multi_carry(chunk, fx["grad"][:cc], fx["hess"][:cc], m, slot[:cc],
                              0, acc, finalize=cc == n)

    return Target(body, (acc.acc64, acc.acc32, mask),
                  fixed=(chunk, fx["grad"], fx["hess"], slot), bins=chunk,
                  key=("ooc_root",), note=f"chunk {cc} of {n} rows",
                  sizes={"rows": cc})


@contract(
    "ooc_split_chunk",
    description="spill-grower split chunk step (split_chunk, then B1): "
                "the chunk's leaf-id update in place, then the small child's "
                "carried sums; leaf ids and the accumulator both static",
    launches={"histogram_multi_carry": 1},
    live={"floor": 512, "rows": 10},  # the split column, go-left, the mask
)
def _build_ooc_split_chunk(device="cpu", fixture=None) -> Target:
    from ..ops.split import BestSplit
    from ..ops.hist_cuda import histogram_multi_carry
    from ..ops.treegrow_ooc import split_chunk

    fx, dev, n, cc, acc = _ooc_fixture(device, fixture)
    chunk = fx["bins"][:cc].contiguous()
    slot = torch.zeros(n, dtype=torch.int32, device=dev)
    leaf_id = torch.zeros(n, dtype=torch.int32, device=dev)
    B = fx["num_bins"]

    def t(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    s = BestSplit(*[torch.zeros((), device=dev)] * len(BestSplit._fields))._replace(
        feature=t(0, torch.int32), threshold_bin=t(B // 2, torch.int32),
        default_left=t(True, torch.bool), is_cat=t(False, torch.bool),
        cat_mask=torch.zeros(B, dtype=torch.bool, device=dev))
    feat = s.feature.long()
    mb = fx["mbpf"].index_select(0, feat.reshape(1))
    best_leaf, new_leaf = t(0, torch.int64), t(1, torch.int64)
    small = t(1, torch.int64)

    def body(b):
        lid, a64, a32 = b
        acc.acc64, acc.acc32 = a64, a32
        split_chunk(lid, chunk, 0, cc, s, feat, mb, best_leaf, new_leaf, None)
        histogram_multi_carry(chunk, fx["grad"][:cc], fx["hess"][:cc],
                              lid[:cc] == small, slot[:cc], 0, acc, finalize=cc == n)

    return Target(body, (leaf_id, acc.acc64, acc.acc32),
                  fixed=(chunk, fx["grad"], fx["hess"], slot), bins=chunk,
                  key=("ooc_split",), note=f"chunk {cc} of {n} rows",
                  sizes={"rows": cc})
