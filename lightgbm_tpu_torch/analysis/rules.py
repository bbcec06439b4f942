"""jaxlint rules R1-R21 over the port.

Counterpart of lightgbm_tpu/analysis/rules.py.  A rule keeps its ID and
takes the torch meaning of its JAX one; scope vocabulary (core.py):

* *hot function* — a round body (the body given to ``RoundGraphs.run`` or
  the round function given to ``round_runner``), reachable from one
  through the package call graph, or nested inside one: the code a
  captured round runs, which a CUDA graph replays without its Python;
* *host round loop* — a non-hot function whose ``for``/``while`` loop launches
  rounds (``graphs.run`` or a hot function), or one of the growers' round
  loops (core.ROUND_LOOPS).

====  ===============================  ====================================
R1    host-sync-in-hot-path            ``.item()``/``.tolist()``/``.cpu()``/
                                       ``.numpy()``, ``float``/``int``/
                                       ``bool`` of a tensor expression,
                                       ``torch.cuda.synchronize()``, an
                                       unsized ``nonzero()``, in a hot
                                       function (the loop body of a host
                                       round loop: the item/tolist/cpu/
                                       numpy reads)
R2    fresh-capture-per-call           ``torch.cuda.CUDAGraph()`` or
                                       ``RoundGraphs(...)`` built in a
                                       function whose result is not kept
                                       (a fresh capture a call)
R3    (scoped out)                     use-after-donate: the port donates
                                       nothing; a round writes its static
                                       buffers in place, which the trace
                                       audit's J2 checks (trace_audit.py)
R4    collective-axis-name             a string axis name given to
                                       ``Mesh``/``GridMesh`` or read from a
                                       mesh's ``axes`` that is not one of
                                       parallel/mesh.py's ``*_AXIS``
R5    impure-in-captured-body          ``time.*``/``random.*``/
                                       ``np.random.*`` calls and
                                       ``global``/``nonlocal`` writes in a
                                       hot function: they run once, at
                                       capture, never on replay
R6    fusable-round-loop               two ``graphs.run`` replays in one
                                       round loop with no host consumer
                                       between them
R7    host-nonfinite-guard             ``math``/``np.isnan`` of a tensor,
                                       or ``bool``/``if`` of a
                                       ``torch.isnan``/``isfinite`` result,
                                       in a host round loop
R8    unbucketed-predict-entry         a mask-subscripted batch
                                       (``X[mask]``) given to a predict
                                       entry or a hot function in a loop
R9    untimed-device-section           a ``perf_counter`` delta around
                                       launches with no synchronize, event
                                       wait or accounted read before the
                                       second read
R10   sync-in-span-close               a fresh device read or synchronize
                                       in a span's close path
R11   (scoped out)                     whole-array VMEM staging: there is
                                       no Pallas ``BlockSpec`` in the port
R12   raw-model-write                  as the JAX package's
R13   collective-outside-round-body    a collective issued from a host
                                       round loop, outside the round body
R14   metadata-via-device-pull         ``np.asarray(x).shape``,
                                       ``x.cpu().shape``,
                                       ``x.numpy().shape``,
                                       ``len(x.tolist())``
R15   staging-alloc-in-serve-loop      ``np.empty``/``zeros`` or a
                                       ``pin_memory=True`` allocation per
                                       request in a loop that predicts
R16   mutation-outside-version-bump    as the JAX package's
R17   full-histogram-over-dcn          a collective over the dcn mesh
                                       moving a histogram operand
R18   host-loop-over-independent-      as the JAX package's
      boosters
R19   unbounded-retry                  as the JAX package's
R20   feature-axis-hist-collective     a collective over the feature mesh
                                       moving a histogram operand
R21   unlinked-cross-thread-span       as the JAX package's
====  ===============================  ====================================

The port's collectives (parallel/collectives.py) take the mesh where the
JAX package's take an axis name, in the same argument position, so R17
and R20 read the mesh expression as the JAX rules read the axis.

R3 and R11 are registered (a pragma naming them is known, and stale) with
no torch meaning: the port has no donated buffers (ops/graphs.py writes
each round's state back into its static buffers) and no Pallas kernels
(csrc/*.cu stage their own tiles).
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from .core import (Finding, FuncInfo, PackageIndex, dotted_name,
                   has_cache_decorator, is_graphs_run, register_rule)

_NUMPY_ALIASES = ("np", "numpy", "onp")
_SYNC_ATTRS = ("item", "tolist", "cpu", "numpy")
_NP_SYNC_FUNCS = ("asarray", "array")
_CAST_BUILTINS = ("float", "int", "bool")
_SHAPE_ATTRS = ("shape", "ndim", "size", "dtype", "numel", "dim")
# methods whose result is a (0-d) tensor: a cast of an expression calling
# one of them reads the card
_TENSOR_METHODS = ("sum", "max", "min", "any", "all", "amax", "amin", "mean",
                   "argmax", "argmin", "prod", "count_nonzero", "norm")
_TORCH_ALIASES = ("torch",)
_PY_IMPURE_MODULES = ("time", "random")
# the port's kernel wrappers (ops/*_cuda.py): a call launches
_WRAPPER_NAMES = ("histogram_multi", "histogram_multi_quantized",
                  "histogram_multi_carry", "histogram_multi_lanes",
                  "histogram_multi_quantized_lanes", "histogram_window",
                  "histogram_window_quantized", "histogram_window_carry",
                  "partition_segments", "partition_segments_lanes",
                  "round_megakernel", "round_partition_window", "predict_trees")
# the port's collectives (parallel/collectives.py) and torch.distributed's
_COLLECTIVES = ("psum", "pmax", "pmin", "psum_scatter", "all_gather",
                "all_gather_ragged", "broadcast_from", "all_reduce",
                "reduce_scatter", "reduce_scatter_tensor",
                "all_gather_into_tensor", "reduce_scatter_single",
                "all_gather_single", "all_to_all", "broadcast")
# calls that read a device value to the host, or wait for the card
_HOST_READS = ("item", "tolist", "cpu", "numpy", "synchronize", "sync_pull",
               "async_pull_result", "elapsed_time", "wait_event")


def _own_body(fi: FuncInfo, include_nested: bool = False
              ) -> Iterator[ast.AST]:
    """Walk fi's body.  With include_nested=False (the default), nested
    function defs are skipped — each nested def is its own FuncInfo, so
    per-function iteration visits every node exactly ONCE (no duplicate
    findings) while lambdas, which have no FuncInfo, stay with the
    enclosing function.  include_nested=True additionally descends into
    nested defs; use it only when iterating top-level functions
    exclusively (R17 and R20 do, to see an enclosing scope's gathers)."""

    def rec(node: ast.AST) -> Iterator[ast.AST]:
        for child in ast.iter_child_nodes(node):
            if (not include_nested and isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef))):
                continue
            yield child
            yield from rec(child)

    def top() -> Iterator[ast.AST]:
        for stmt in fi.node.body:
            yield stmt
            if (not include_nested and isinstance(
                    stmt, (ast.FunctionDef, ast.AsyncFunctionDef))):
                continue  # direct nested def: own FuncInfo covers its body
            yield from rec(stmt)

    return top()


def _is_np_attr(node: ast.AST, attrs) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr in attrs
            and isinstance(node.value, ast.Name)
            and node.value.id in _NUMPY_ALIASES)


def _last(node: ast.AST) -> str:
    """The last component of a call's function name (``a.b.c`` -> c)."""
    fn = dotted_name(node) if not isinstance(node, ast.Call) else (
        dotted_name(node.func))
    if fn is None:
        f = node.func if isinstance(node, ast.Call) else node
        return getattr(f, "attr", "")
    return fn.split(".")[-1]


def _is_shape_like(node: ast.AST) -> bool:
    """x.shape[0] / len(x) / x.numel(): Python ints, no read."""
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in _SHAPE_ATTRS:
            return True
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "len"):
            return True
    return False


def _tensor_expr(node: ast.AST) -> bool:
    """An expression that evaluates a tensor: a call of a reduction method
    or of a ``torch.*`` function (a bare name may be a Python number)."""
    for n in ast.walk(node):
        if not isinstance(n, ast.Call):
            continue
        if isinstance(n.func, ast.Attribute) and n.func.attr in _TENSOR_METHODS:
            return True
        fn = dotted_name(n.func) or ""
        if fn.split(".")[0] in _TORCH_ALIASES:
            return True
    return False


def _finding(fi: FuncInfo, node: ast.AST, rule: str, msg: str, hint: str
             ) -> Finding:
    return Finding(str(fi.module.path), getattr(node, "lineno", fi.node.lineno),
                   rule, msg, hint)


def _calls_hot(pkg: PackageIndex, fi: FuncInfo, node: ast.Call) -> bool:
    """The call launches a round: graphs.run, or a hot function."""
    if is_graphs_run(node):
        return True
    target = pkg.resolve_call(fi.module, node.func, fi)
    return target is not None and target in pkg.hot


def _launches(pkg: PackageIndex, fi: FuncInfo, node: ast.Call) -> bool:
    """The call launches device work: a round, or a kernel wrapper."""
    return _calls_hot(pkg, fi, node) or _last(node) in _WRAPPER_NAMES


# ---------------------------------------------------------------------------
# R1 — host-sync-in-hot-path
# ---------------------------------------------------------------------------

@register_rule("R1", "host-sync-in-hot-path")
def r1_host_sync(pkg: PackageIndex) -> Iterator[Finding]:
    """``.item()``/``.tolist()``/``.cpu()``/``.numpy()`` read a tensor to
    the host; ``float``/``int``/``bool`` of a tensor expression does the
    same; ``torch.cuda.synchronize()`` drains the card; ``nonzero()``
    without a size reads its count.  In a hot function any of them breaks
    a CUDA-graph capture (a capture cannot read the card) or, run
    eagerly, stalls the round; in a host round loop each is a blocking
    read a round.  The accounted reads (utils/sanitizer.py ``sync_pull``,
    ``async_pull_result``, one round behind) are the supported pattern."""
    for mod in pkg.modules.values():
        for fi in mod.functions.values():
            hot = pkg.is_hot(fi)
            loop = pkg.is_round_loop(fi)
            if not hot and not loop:
                continue
            where = "a captured round body" if hot else "a host round loop"
            loop_nodes = PackageIndex._loop_body_walk(fi) if loop else None
            for node in _own_body(fi):
                if not isinstance(node, ast.Call):
                    continue
                if loop_nodes is not None and node not in loop_nodes:
                    continue
                fn = dotted_name(node.func) or ""
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _SYNC_ATTRS and not node.args
                        and not _is_np_attr(node.func, _SYNC_ATTRS)):
                    yield _finding(
                        fi, node, "R1",
                        f".{node.func.attr}() reads the card in {where} "
                        f"({fi.qualname})",
                        "keep the value on the device; read it once, one "
                        "round behind (utils/sanitizer.py async_pull_*)")
                elif not hot:
                    continue
                elif fn in ("torch.cuda.synchronize", "cuda.synchronize"):
                    yield _finding(
                        fi, node, "R1",
                        f"torch.cuda.synchronize() in {where} "
                        f"({fi.qualname})",
                        "a captured body cannot wait for the card; order "
                        "work by streams and events instead")
                elif (fn.split(".")[-1] == "nonzero"
                        and not any(kw.arg in ("size", "as_tuple")
                                    for kw in node.keywords)):
                    yield _finding(
                        fi, node, "R1",
                        f"nonzero() without a size in {where} "
                        f"({fi.qualname}): its length is read from the card",
                        "use a fixed-size mask or torch.nonzero_static")
                elif (isinstance(node.func, ast.Name)
                        and node.func.id in _CAST_BUILTINS
                        and len(node.args) == 1
                        and _tensor_expr(node.args[0])
                        and not _is_shape_like(node.args[0])):
                    yield _finding(
                        fi, node, "R1",
                        f"{node.func.id}() of a tensor in {where} "
                        f"({fi.qualname})",
                        "operate on the tensor with torch; keep 0-d "
                        "tensors on the device")


# ---------------------------------------------------------------------------
# R2 — fresh-capture-per-call
# ---------------------------------------------------------------------------

def _enclosing_is_cached(fi: FuncInfo) -> bool:
    cur: Optional[FuncInfo] = fi
    while cur is not None:
        if has_cache_decorator(cur.node):
            return True
        cur = cur.parent
    return False


_R2_CTORS = ("CUDAGraph", "RoundGraphs")


@register_rule("R2", "fresh-capture-per-call")
def r2_fresh_capture(pkg: PackageIndex) -> Iterator[Finding]:
    """A ``torch.cuda.CUDAGraph()`` or ``RoundGraphs(...)`` built inside a
    function and not kept (on an attribute, or by a memoized factory)
    captures afresh every call: each call pays a capture, its warm-up
    round and a new memory pool, and its replays never amortize.  The
    supported pattern is one cache a training (models/gbdt.py keeps its
    ``RoundGraphs``), captured once per key (ops/graphs.py)."""
    for mod in pkg.modules.values():
        for fi in mod.functions.values():
            if _enclosing_is_cached(fi):
                continue
            kept = set()
            for node in _own_body(fi):
                if isinstance(node, (ast.Assign, ast.AnnAssign)):
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    if any(isinstance(t, (ast.Attribute, ast.Subscript))
                           for t in targets):
                        kept.update(id(n) for n in ast.walk(node.value))
            for node in _own_body(fi):
                if (isinstance(node, ast.Call) and _last(node) in _R2_CTORS
                        and id(node) not in kept):
                    yield _finding(
                        fi, node, "R2",
                        f"{_last(node)}(...) built inside {fi.qualname} and "
                        "not kept: a fresh capture every call",
                        "keep the cache on the training (an attribute) and "
                        "capture once per static key")


# ---------------------------------------------------------------------------
# R3, R11 — registered, scoped out
# ---------------------------------------------------------------------------

@register_rule("R3", "use-after-donate", layer="scoped")
def r3_scoped_out(pkg: PackageIndex) -> Iterator[Finding]:
    """Scoped out: the port donates no buffer.  A captured round writes its
    state back into its static buffers (ops/graphs.py), so there is no dead
    pre-call value to read; the trace audit's J2 holds the buffers' storage
    fixed instead (trace_audit.py)."""
    return iter(())


@register_rule("R11", "whole-array-vmem-staging", layer="scoped")
def r11_scoped_out(pkg: PackageIndex) -> Iterator[Finding]:
    """Scoped out: the port has no Pallas ``BlockSpec`` or VMEM scratch;
    its kernels (csrc/*.cu) stage their own shared-memory tiles."""
    return iter(())


# ---------------------------------------------------------------------------
# R4 — collective-axis-name
# ---------------------------------------------------------------------------

_R4_MESH_CTORS = ("Mesh", "GridMesh")


def _r4_string_value(pkg: PackageIndex, mod, node: ast.AST):
    """A literal string, or a name bound to a module-level string."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value, repr(node.value)
    if isinstance(node, ast.Name):
        value = mod.str_constants.get(node.id)
        if value is None:
            imp = mod.imports.get(node.id)
            if imp is not None and imp[0] == "func":
                src = pkg.modules.get(imp[1][0])
                if src is not None:
                    value = src.str_constants.get(imp[1][1])
        if value is not None:
            return value, f"{node.id}={value!r}"
    return None


@register_rule("R4", "collective-axis-name")
def r4_axis_names(pkg: PackageIndex) -> Iterator[Finding]:
    """Every string axis name given to ``Mesh(group, axis)`` /
    ``GridMesh(shape, (row, col))`` or read from a grid mesh's ``axes``
    must be one of the axis constants parallel/mesh.py declares
    (``DATA_AXIS``, ``FEATURE_AXIS``, ``ICI_AXIS``, ``DCN_AXIS``,
    ``WORLD_AXIS``): a typo'd name keys per-axis stats nobody reads, or a
    ``KeyError`` that shows only when a mesh of that shape finally runs.
    Names that flow in as parameters are dynamic and skipped."""
    declared = pkg.axis_names
    if not declared:
        return
    hint = ("use the axis constants of parallel/mesh.py (DATA_AXIS, "
            "FEATURE_AXIS, ICI_AXIS, DCN_AXIS, WORLD_AXIS)")
    for mod in pkg.modules.values():
        for node in ast.walk(mod.tree):
            cands = []
            if isinstance(node, ast.Call) and _last(node) in _R4_MESH_CTORS:
                args = list(node.args[1:2]) + [kw.value for kw in node.keywords
                                               if kw.arg in ("axis", "names")]
                for a in args:
                    cands.extend(a.elts if isinstance(a, ast.Tuple) else [a])
            elif (isinstance(node, ast.Subscript)
                    and isinstance(node.value, ast.Attribute)
                    and node.value.attr == "axes"):
                cands.append(node.slice)
            for c in cands:
                got = _r4_string_value(pkg, mod, c)
                if got is not None and got[0] not in declared:
                    yield Finding(
                        str(mod.path), c.lineno, "R4",
                        f"mesh axis name {got[1]} is not a declared mesh "
                        f"axis {sorted(declared)}", hint)


# ---------------------------------------------------------------------------
# R5 — impure-in-captured-body
# ---------------------------------------------------------------------------

@register_rule("R5", "impure-in-captured-body")
def r5_impure(pkg: PackageIndex) -> Iterator[Finding]:
    """Python side effects in a captured round body run ONCE, when the
    graph is captured, and never on a replay: a ``time.*`` read, a
    stdlib ``random`` or ``np.random`` draw, a ``global``/``nonlocal``
    write is frozen into the first round.  Draw on the device from a
    generator or a table the grower loads into the static buffers
    (ops/treegrow_windowed.py ``WInputs.rng``), and pass host values in
    through them."""
    for mod in pkg.modules.values():
        for fi in mod.functions.values():
            if not pkg.is_hot(fi):
                continue
            for node in _own_body(fi):
                if isinstance(node, (ast.Global, ast.Nonlocal)):
                    kind = ("global" if isinstance(node, ast.Global)
                            else "nonlocal")
                    yield _finding(
                        fi, node, "R5",
                        f"{kind} write ({', '.join(node.names)}) in captured "
                        f"{fi.qualname} runs at capture only",
                        "carry state in the static buffers instead")
                if not isinstance(node, ast.Call):
                    continue
                fn = dotted_name(node.func)
                if fn is None:
                    continue
                parts = fn.split(".")
                if parts[0] in _PY_IMPURE_MODULES and len(parts) > 1:
                    yield _finding(
                        fi, node, "R5",
                        f"{fn}() in captured {fi.qualname} is evaluated "
                        "once, at capture",
                        "pass host values in through the static buffers")
                elif (len(parts) >= 3 and parts[0] in _NUMPY_ALIASES
                        and parts[1] == "random"):
                    yield _finding(
                        fi, node, "R5",
                        f"{fn}() host draw in captured {fi.qualname} (one "
                        "sample frozen into the graph)",
                        "draw on the device (a torch.Generator) or load "
                        "the draws into the static buffers")


# ---------------------------------------------------------------------------
# R6 — fusable-round-loop
# ---------------------------------------------------------------------------

def _is_host_read(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    if _last(node) in _HOST_READS or _is_np_attr(node.func, _NP_SYNC_FUNCS):
        return True
    return isinstance(node.func, ast.Name) and node.func.id in _CAST_BUILTINS


@register_rule("R6", "fusable-round-loop")
def r6_fusable_round_loop(pkg: PackageIndex) -> Iterator[Finding]:
    """Two ``graphs.run`` replays in one round loop with no host consumer
    between them are one captured round waiting to happen: each replay
    is its own launch of the graph, and splitting a round in two graphs
    doubles that cost for nothing the host needs in between.  A host read
    (an accounted ``sync_pull``, ``.item()``, a cast) between the two is a
    real dependency and is not flagged."""
    for mod in pkg.modules.values():
        for fi in mod.functions.values():
            if pkg.is_hot(fi):
                continue
            for loop in _own_body(fi):
                if not isinstance(loop, (ast.For, ast.While)):
                    continue
                nodes = [n for n in ast.walk(loop) if isinstance(n, ast.Call)]
                runs = sorted(n.lineno for n in nodes if is_graphs_run(n))
                reads = [n.lineno for n in nodes if _is_host_read(n)]
                for la, lb in zip(runs, runs[1:]):
                    if any(la < lr <= lb for lr in reads):
                        continue
                    yield Finding(
                        str(mod.path), lb, "R6",
                        f"a second graphs.run in {fi.qualname}'s round loop "
                        f"(the first at line {la}) with no host consumer "
                        "between them",
                        "capture both in one round body (one replay a "
                        "round); read what the host needs one round behind")


# ---------------------------------------------------------------------------
# R7 — host-nonfinite-guard
# ---------------------------------------------------------------------------

_NONFINITE_FUNCS = ("isnan", "isfinite", "isinf")
_NONFINITE_HOST_MODULES = _NUMPY_ALIASES + ("math",)


@register_rule("R7", "host-nonfinite-guard")
def r7_host_nonfinite_guard(pkg: PackageIndex) -> Iterator[Finding]:
    """A non-finite check read on the host inside a grower's round loop:
    ``math.isnan``/``np.isnan`` of a per-round value, or ``bool``/``if``/
    ``assert`` on a ``torch.isnan(...)``/``isfinite(...)`` result, is one
    blocking read a round.  Fold the finite flag into the round's info
    vector and read it one round behind (ops/treegrow_windowed.py), or
    accumulate a device flag read at an existing read (models/gbdt.py
    ``_guard_accumulate``)."""
    hint = ("keep the finite check on the device: fold it into the round's "
            "info vector, read one round behind, or accumulate a device "
            "flag (models/gbdt.py::_guard_accumulate)")

    def device_call(node: ast.AST) -> Optional[str]:
        for inner in ast.walk(node):
            if not isinstance(inner, ast.Call):
                continue
            ifn = dotted_name(inner.func) or ""
            parts = ifn.split(".")
            if parts[-1] in _NONFINITE_FUNCS and (
                    parts[0] in _TORCH_ALIASES or len(parts) == 2
                    and parts[0] not in _NONFINITE_HOST_MODULES):
                return ifn
        return None

    for mod in pkg.modules.values():
        for fi in mod.functions.values():
            if not pkg.is_round_loop(fi):
                continue
            loop_nodes = PackageIndex._loop_body_walk(fi)
            flagged = set()
            for node in _own_body(fi):
                if node not in loop_nodes:
                    continue
                if isinstance(node, (ast.If, ast.While, ast.Assert)):
                    ifn = device_call(node.test)
                    if ifn is not None:
                        flagged.update(ast.walk(node.test))
                        yield _finding(
                            fi, node.test, "R7",
                            f"branching on {ifn}(...) reads the card "
                            f"(implicit bool) in {fi.qualname}'s round loop",
                            hint)
                    continue
                if not isinstance(node, ast.Call) or node in flagged:
                    continue
                fn = dotted_name(node.func) or ""
                parts = fn.split(".")
                if (len(parts) >= 2 and parts[-1] in _NONFINITE_FUNCS
                        and parts[0] in _NONFINITE_HOST_MODULES):
                    yield _finding(
                        fi, node, "R7",
                        f"host {fn}() check of a per-round value in "
                        f"{fi.qualname}'s round loop", hint)
                elif (isinstance(node.func, ast.Name)
                        and node.func.id in _CAST_BUILTINS and node.args):
                    ifn = device_call(node.args[0])
                    if ifn is not None:
                        yield _finding(
                            fi, node, "R7",
                            f"{node.func.id}({ifn}(...)) reads a finite "
                            f"flag in {fi.qualname}'s round loop", hint)


# ---------------------------------------------------------------------------
# R8 — unbucketed-predict-entry
# ---------------------------------------------------------------------------

_MASK_PRODUCING_FNS = ("nonzero", "flatnonzero", "where", "isnan",
                       "isfinite", "isinf")


def _masklike_names(fi: FuncInfo) -> set:
    """Names assigned (in ``fi``) from a boolean-mask-shaped expression."""
    def masky(expr: ast.AST) -> bool:
        for node in ast.walk(expr):
            if isinstance(node, ast.Compare):
                return True
            if isinstance(node, ast.BinOp) and isinstance(
                    node.op, (ast.BitAnd, ast.BitOr)):
                return True
            if isinstance(node, ast.UnaryOp) and isinstance(
                    node.op, ast.Invert):
                return True
            if isinstance(node, ast.Call) and _last(node) in _MASK_PRODUCING_FNS:
                return True
        return False

    out = set()
    for node in _own_body(fi):
        if isinstance(node, ast.Assign) and masky(node.value):
            for t in node.targets:
                out |= {n.id for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(node, ast.AugAssign) and (
                masky(node.value)
                or isinstance(node.op, (ast.BitAnd, ast.BitOr))):
            out |= {n.id for n in ast.walk(node.target)
                    if isinstance(n, ast.Name)}
    return out


@register_rule("R8", "unbucketed-predict-entry")
def r8_unbucketed_predict_entry(pkg: PackageIndex) -> Iterator[Finding]:
    """A predict entry (a ``predict*`` call) or a hot function called in a
    loop with a mask-subscripted batch (``X[active]``): every distinct
    mask count is a new leading dimension, so the cached predict's pinned
    rungs and a captured round's static shapes no longer apply (a rung
    pinned per count, a capture refused).  Keep every row in the
    bucket-padded batch and mask on the device (ops/predict.py
    ``active=``, models/gbdt.py ``_predict_bucket``)."""
    hint = ("pad the batch to its rung and pass the mask to the device "
            "(ops/predict.py active=); a host-side mask changes the shape "
            "every call")
    for mod in pkg.modules.values():
        for fi in mod.functions.values():
            loop_nodes = PackageIndex._loop_body_walk(fi)
            if not loop_nodes:
                continue
            masky = _masklike_names(fi)
            for node in _own_body(fi):
                if node not in loop_nodes or not isinstance(node, ast.Call):
                    continue
                if not (_last(node).startswith("predict")
                        or _calls_hot(pkg, fi, node)):
                    continue
                args = list(node.args) + [kw.value for kw in node.keywords]
                for arg in args:
                    if not isinstance(arg, ast.Subscript):
                        continue
                    idx = arg.slice
                    if isinstance(idx, ast.Name) and idx.id in masky:
                        why = f"boolean-mask subscript [{idx.id}]"
                    elif isinstance(idx, ast.Compare):
                        why = "inline comparison-mask subscript"
                    else:
                        continue
                    yield _finding(
                        fi, node, "R8",
                        f"{_last(node)} called in {fi.qualname}'s loop with "
                        f"a data-dependent leading dimension ({why})", hint)


# ---------------------------------------------------------------------------
# R9 — untimed-device-section
# ---------------------------------------------------------------------------

_TIMER_ATTRS = ("perf_counter", "monotonic", "perf_counter_ns",
                "monotonic_ns")


def _is_timer_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = dotted_name(node.func)
    if fn is None:
        return False
    parts = fn.split(".")
    if parts[-1] in _TIMER_ATTRS:
        return True
    return len(parts) >= 2 and parts[-1] == "time" and "time" in parts[0]


@register_rule("R9", "untimed-device-section")
def r9_untimed_device_section(pkg: PackageIndex) -> Iterator[Finding]:
    """A ``time.perf_counter()`` delta around launches (a kernel wrapper,
    ``graphs.run`` or a hot function) with no synchronize, event wait or
    accounted read between the last launch and the second timer read:
    launches are asynchronous, so the delta times the enqueue, not the
    card.  ``torch.cuda.synchronize()``, an event's ``synchronize()``/
    ``elapsed_time``, ``sync_pull``/``async_pull_result`` or a host read
    (``.item()``, ``.cpu()``) after the launch makes it honest, as does
    utils/profiling.py ``timed_section(sync=True)``."""
    hint = ("synchronize (torch.cuda.synchronize, an event) or make an "
            "accounted read before the second timer read, or use "
            "utils/profiling.py timed_section(sync=True)")
    for mod in pkg.modules.values():
        for fi in mod.functions.values():
            if pkg.is_hot(fi):
                continue  # time.* in a captured body is R5's
            timer_starts: dict = {}
            subs = []
            launch_lines = []
            sync_lines = []
            for node in _own_body(fi):
                if (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and _is_timer_call(node.value)):
                    timer_starts.setdefault(
                        node.targets[0].id, []).append(node.lineno)
                    continue
                if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
                    inline = any(_is_timer_call(x) for x in ast.walk(node))
                    names = {x.id for x in ast.walk(node)
                             if isinstance(x, ast.Name)}
                    if names:
                        subs.append((node.lineno, names, inline))
                if isinstance(node, ast.Call):
                    if _launches(pkg, fi, node):
                        launch_lines.append(node.lineno)
                    if _is_host_read(node):
                        sync_lines.append(node.lineno)
            deltas = [(ln, names) for ln, names, inline in subs
                      if (names & set(timer_starts))
                      and (inline or len(names & set(timer_starts)) >= 2)]
            if not launch_lines or not deltas:
                continue
            for dline, names in deltas:
                for var in names & set(timer_starts):
                    starts = [ln for ln in timer_starts[var] if ln < dline]
                    if not starts:
                        continue
                    s = max(starts)
                    disp = [d for d in launch_lines if s < d < dline]
                    if not disp:
                        continue
                    last_d = max(disp)
                    if any(last_d <= sl <= dline for sl in sync_lines):
                        continue
                    yield Finding(
                        str(mod.path), dline, "R9",
                        f"wall-clock delta (started line {s}) read around a "
                        f"launch (line {last_d}) with no synchronize before "
                        f"the read in {fi.qualname}", hint)


# ---------------------------------------------------------------------------
# R10 — sync-in-span-close
# ---------------------------------------------------------------------------

# fresh reads of the card (a positive finding here, so the accounted
# readers sync_pull / async_pull_result are allowed: closing a span AT an
# accounted read is the supported pattern)
_R10_FRESH_PULL_ATTRS = ("asarray", "array", "item", "tolist", "cpu", "numpy",
                         "synchronize")
_R10_ACCOUNTED = ("sync_pull", "async_pull_result")
_R10_CLOSE_NAMES = ("__exit__", "close", "end", "finish")


def _is_contextmanager(node: ast.FunctionDef) -> bool:
    return any((dotted_name(d) or "").split(".")[-1] == "contextmanager"
               for d in node.decorator_list)


def _r10_close_paths(mod) -> Iterator:
    """(FuncInfo, first_line) pairs whose body (from first_line on, or all
    of it for None) is a span close path: the ``__exit__``/``close`` of a
    span-named class, or the after-``yield`` tail of a
    ``@contextmanager`` generator named like a span."""
    for fi in mod.functions.values():
        parts = fi.qualname.split(".")
        if (len(parts) >= 2 and parts[-1] in _R10_CLOSE_NAMES
                and any("span" in p.lower() for p in parts[:-1])):
            yield fi, None
            continue
        if "span" in parts[-1].lower() and _is_contextmanager(fi.node):
            ylines = [n.lineno for n in ast.walk(fi.node)
                      if isinstance(n, (ast.Yield, ast.YieldFrom))]
            if ylines:
                yield fi, min(ylines)


@register_rule("R10", "sync-in-span-close")
def r10_sync_in_span_close(pkg: PackageIndex) -> Iterator[Finding]:
    """A span ``__exit__``/``close`` (or the after-yield tail of a
    ``@contextmanager`` span) that reads the card afresh (``.item()``,
    ``.cpu()``, ``np.asarray`` of a tensor) or synchronizes it to make its
    duration "honest": spans open around the round loops, so the close
    adds a blocking read a span.  Close the span at an existing accounted
    read instead (obs/trace.py ``record_span`` after the round's info
    resolve); ``sync_pull``/``async_pull_result`` are allowed here."""
    hint = ("span closes must not read the card: record the interval at "
            "an existing accounted read (obs/trace.py record_span)")
    for mod in pkg.modules.values():
        for fi, after_line in _r10_close_paths(mod):
            for node in _own_body(fi):
                if not isinstance(node, ast.Call):
                    continue
                if after_line is not None and node.lineno <= after_line:
                    continue
                last = _last(node)
                if last in _R10_ACCOUNTED:
                    continue
                if last in _R10_FRESH_PULL_ATTRS:
                    yield _finding(
                        fi, node, "R10",
                        f"span close path {fi.qualname} reads the card afresh "
                        f"({last}): a hidden blocking read a span", hint)


# ---------------------------------------------------------------------------
# R12 — raw-model-write
# ---------------------------------------------------------------------------

# name fragments marking an expression as a model/snapshot artifact path —
# matched case-insensitively against identifiers, attribute names, and
# string literals inside the written-path expression
_R12_ARTIFACT_TOKENS = ("model", "snapshot", "manifest", "checkpoint",
                        "ckpt")


def _r12_mentions_artifact(node: ast.AST) -> bool:
    for n in ast.walk(node):
        name = None
        if isinstance(n, ast.Name):
            name = n.id
        elif isinstance(n, ast.Attribute):
            name = n.attr
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            name = n.value
        if name is not None:
            low = name.lower()
            if any(t in low for t in _R12_ARTIFACT_TOKENS):
                return True
    return False


@register_rule("R12", "raw-model-write")
def r12_raw_model_write(pkg: PackageIndex) -> Iterator[Finding]:
    """A durable write of a model/snapshot artifact OUTSIDE
    utils/checkpoint.py: ``open(path, "w"/"wb")``, ``np.save``/
    ``np.savez[_compressed]``, or a hand-rolled ``os.replace`` whose
    target expression names a model/snapshot/manifest path.  Every
    durable model write must go through the atomic sha256-trailed helper
    (``checkpoint.atomic_write_text`` / ``save_snapshot``): a raw
    ``open(..., "w")`` torn by a crash leaves a half-file a restart
    happily parses into a half-model — the silent-corruption class the
    checkpoint layer exists to exclude — and a raw ``os.replace``
    without the fsync'd temp protocol can still publish an incompletely
    flushed file.  Writes of non-artifact paths (logs, predictions,
    metrics, data caches with their own CRC trailers) are not flagged;
    an intentional raw artifact write (e.g. generated source code whose
    name merely contains 'model') takes a pragma with its reason."""
    hint = ("route durable model writes through utils/checkpoint.py: "
            "atomic_write_text(path, text) for plain models, "
            "save_snapshot(path, text, iteration) for trailer-stamped "
            "snapshots, write_fleet_checkpoint for fleet rounds — see "
            "docs/ROBUSTNESS.md and docs/ANALYSIS.md R12")
    for mod in pkg.modules.values():
        if str(mod.path).endswith("checkpoint.py"):
            continue  # the sanctioned writer itself
        for fi in mod.functions.values():
            for node in _own_body(fi):
                if not isinstance(node, ast.Call):
                    continue
                fn = dotted_name(node.func) or ""
                last = fn.split(".")[-1]
                how = None
                if last == "open" and "." not in fn and node.args:
                    mode = None
                    if (len(node.args) > 1
                            and isinstance(node.args[1], ast.Constant)):
                        mode = node.args[1].value
                    for kw in node.keywords:
                        if (kw.arg == "mode"
                                and isinstance(kw.value, ast.Constant)):
                            mode = kw.value.value
                    if (isinstance(mode, str) and "w" in mode
                            and _r12_mentions_artifact(node.args[0])):
                        how = f"open(..., {mode!r})"
                elif (_is_np_attr(node.func,
                                  ("save", "savez", "savez_compressed"))
                      and any(_r12_mentions_artifact(a)
                              for a in node.args)):
                    how = f"np.{last}"
                elif (fn == "os.replace" and len(node.args) > 1
                      and _r12_mentions_artifact(node.args[1])):
                    how = "os.replace"
                if how is not None:
                    yield _finding(
                        fi, node, "R12",
                        f"{fi.qualname} writes a model/snapshot artifact "
                        f"via raw {how} — outside the atomic "
                        "sha256-trailed checkpoint helper, a crash can "
                        "leave a torn file a restart will trust", hint)



# ---------------------------------------------------------------------------
# R13 — collective-outside-round-body
# ---------------------------------------------------------------------------

@register_rule("R13", "collective-outside-round-body")
def r13_collective_outside_round_body(pkg: PackageIndex) -> Iterator[Finding]:
    """A collective (parallel/collectives.py ``psum``/``psum_scatter``/
    ``all_gather``/``pmax``/``pmin``/``broadcast_from``, or a
    ``torch.distributed`` call) issued from a host round loop,
    outside the round body: every round then pays a collective the host
    launches on its own, between rounds, at the cadence a round body
    exists to remove (LightGBM's per-split ReduceScatter).  The merge
    belongs inside the round function (ops/treegrow_windowed.py
    ``_round_sharded``).  Collectives inside a hot function are the fix,
    not a finding.  Today the sharded rounds run eagerly (ROADMAP C17,
    A27), so the host-loop sites that remain carry a pragma whose reason
    names C17/A27."""
    hint = ("merge inside the round function (ops/treegrow_windowed.py::"
            "_round_sharded); if the host needs the reduced value, return "
            "it in the round's info vector")
    for mod in pkg.modules.values():
        for fi in mod.functions.values():
            if not pkg.is_round_loop(fi):
                continue
            loop_nodes = PackageIndex._loop_body_walk(fi)
            for node in _own_body(fi):
                if node not in loop_nodes or not isinstance(node, ast.Call):
                    continue
                if _last(node) in _COLLECTIVES:
                    yield _finding(
                        fi, node, "R13",
                        f"host-issued collective {_last(node)}() in "
                        f"{fi.qualname}'s round loop, outside the round "
                        "body", hint)


# ---------------------------------------------------------------------------
# R14 — metadata-via-device-pull
# ---------------------------------------------------------------------------

_R14_META_ATTRS = ("shape", "ndim", "size", "dtype")
_R14_PULLS = ("cpu", "numpy", "tolist")


def _r14_pull(node: ast.AST) -> Optional[str]:
    """``np.asarray(x)`` / ``x.cpu()`` / ``x.numpy()`` / ``x.tolist()``:
    the spelling, else None."""
    if not isinstance(node, ast.Call):
        return None
    if _is_np_attr(node.func, _NP_SYNC_FUNCS):
        return f"np.{node.func.attr}(...)"
    if (isinstance(node.func, ast.Attribute) and node.func.attr in _R14_PULLS
            and not node.args):
        return f"x.{node.func.attr}()"
    return None


@register_rule("R14", "metadata-via-device-pull")
def r14_metadata_via_device_pull(pkg: PackageIndex) -> Iterator[Finding]:
    """Reading metadata through a whole-tensor host copy:
    ``np.asarray(x).shape``, ``x.cpu().shape``, ``x.numpy().dtype``,
    ``len(x.tolist())``, ``len(np.asarray(x))``, ``x.shape[0].item()``.
    On a CUDA tensor the copy is a blocking read of the whole buffer, paid
    for a property the tensor exposes for free; on a host array it is
    still a gratuitous O(N) copy.  Fires everywhere, not only in hot
    paths: a metadata read never needs the copy."""
    hint = ("read .shape/.dtype/len() off the tensor or array itself "
            "(np.shape(x) for maybe-list inputs); convert once and bind "
            "the result if the data is needed too")
    for mod in pkg.modules.values():
        for fi in mod.functions.values():
            for node in _own_body(fi):
                if (isinstance(node, ast.Attribute)
                        and node.attr in _R14_META_ATTRS
                        and _r14_pull(node.value) is not None):
                    yield _finding(
                        fi, node, "R14",
                        f"{_r14_pull(node.value)}.{node.attr} in "
                        f"{fi.qualname}: a whole-array copy to read metadata "
                        "the array already exposes", hint)
                elif (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == "len" and len(node.args) == 1
                        and _r14_pull(node.args[0]) is not None):
                    yield _finding(
                        fi, node, "R14",
                        f"len({_r14_pull(node.args[0])}) in {fi.qualname}: "
                        "a whole-array copy to read a length .shape already "
                        "exposes", hint)
                elif (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "item" and not node.args
                        and isinstance(node.func.value, ast.Subscript)
                        and isinstance(node.func.value.value, ast.Attribute)
                        and node.func.value.value.attr == "shape"):
                    yield _finding(
                        fi, node, "R14",
                        f".shape[...].item() in {fi.qualname}: shape entries "
                        "are Python ints already", hint)


# ---------------------------------------------------------------------------
# R15 — staging-alloc-in-serve-loop
# ---------------------------------------------------------------------------

_R15_FRESH_ALLOCS = ("empty", "zeros", "ones", "full")
_R15_HOST_SOURCES = _R15_FRESH_ALLOCS + ("asarray", "array", "empty_like",
                                         "zeros_like", "ones_like",
                                         "full_like")
_R15_UPLOADS = ("as_tensor", "tensor", "from_numpy")


def _r15_is_fresh_alloc(node: ast.AST) -> Optional[str]:
    """np.empty/zeros/ones/full, or a torch allocation with
    pin_memory=True: a fresh host buffer a call."""
    if not isinstance(node, ast.Call):
        return None
    if _is_np_attr(node.func, _R15_FRESH_ALLOCS):
        return f"np.{node.func.attr}"
    fn = dotted_name(node.func) or ""
    if (fn.split(".")[0] in _TORCH_ALIASES
            and fn.split(".")[-1] in _R15_FRESH_ALLOCS + ("empty_like",)
            and any(kw.arg == "pin_memory" and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True for kw in node.keywords)):
        return f"{fn}(pin_memory=True)"
    return None


def _r15_is_upload_of_fresh_host(node: ast.AST) -> bool:
    """torch.as_tensor / torch.tensor / torch.from_numpy of a freshly made
    host array (np.zeros(...), np.asarray(...), ...): an
    allocate-then-upload a call.  Uploads of a NAMED buffer are clean."""
    if not (isinstance(node, ast.Call) and node.args
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _R15_UPLOADS
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in _TORCH_ALIASES):
        return False
    arg = node.args[0]
    return (isinstance(arg, ast.Call)
            and _is_np_attr(arg.func, _R15_HOST_SOURCES))


def _r15_is_predict_entry(node: ast.AST) -> bool:
    """An accounted serving dispatch: a call whose final name is a
    predict entry or the accounted ``sync_pull`` itself."""
    if not isinstance(node, ast.Call):
        return False
    last = _last(node)
    return last.startswith("predict") or last == "sync_pull"


@register_rule("R15", "staging-alloc-in-serve-loop")
def r15_staging_alloc_in_serve_loop(pkg: PackageIndex) -> Iterator[Finding]:
    """A fresh host staging allocation inside a loop that also predicts:
    ``np.empty``/``np.zeros`` a request, a ``torch.empty(...,
    pin_memory=True)`` a request (pinning costs a page-locking syscall
    each time), or ``torch.as_tensor(np.zeros(...))`` (allocate, then
    upload).  A serving loop runs at request cadence; the pinned staging
    pairs of serve/runtime.py (one pair a rung, reused) exist to remove
    exactly that.  Uploading a named, reused buffer in the loop is the
    design, not a finding."""
    hint = ("hoist the staging buffer out of the loop and reuse it "
            "(serve/runtime.py keeps one pinned pair a rung)")
    for mod in pkg.modules.values():
        for fi in mod.functions.values():
            if pkg.is_hot(fi):
                continue
            for loop in _own_body(fi):
                if not isinstance(loop, (ast.For, ast.While)):
                    continue
                nodes = list(ast.walk(loop))
                if not any(_r15_is_predict_entry(n) for n in nodes):
                    continue
                wrapped = {id(n.args[0]) for n in nodes
                           if _r15_is_upload_of_fresh_host(n)}
                for n in nodes:
                    alloc = _r15_is_fresh_alloc(n)
                    if alloc is not None and id(n) not in wrapped:
                        yield _finding(
                            fi, n, "R15",
                            f"per-iteration host staging allocation "
                            f"{alloc}(...) in {fi.qualname}'s serving loop",
                            hint)
                    elif _r15_is_upload_of_fresh_host(n):
                        yield _finding(
                            fi, n, "R15",
                            f"{dotted_name(n.func)}(np.{n.args[0].func.attr}"
                            f"(...)) in {fi.qualname}'s serving loop: "
                            "allocate-then-upload a request", hint)


# ---------------------------------------------------------------------------
# R16 — mutation-outside-version-bump
# ---------------------------------------------------------------------------

# the ensemble state whose mutation MUST route through the versioned
# pack invalidation: the tree list and the per-tree leaf tables
_R16_ENSEMBLE_ATTRS = ("models", "_models", "leaf_value")
_R16_LIST_MUTATORS = ("append", "extend", "insert", "pop", "remove",
                      "clear", "sort", "reverse")
_R16_BUMP = "_invalidate_pred_cache"
# only serve/continual code paths are in scope: they run BESIDE live
# serving readers, where an unbumped mutation hands an in-flight predict
# a pack that no longer matches the trees (docs/ANALYSIS.md static-limits
# note covers the rest of the tree)
_R16_SCOPED_DIRS = ("serve", "continual")


def _r16_ensemble_attr(node: ast.AST) -> Optional[str]:
    """The ensemble attribute an expression touches: ``x.models`` /
    ``x._models`` / ``tree.leaf_value`` (as an Attribute), or a Subscript
    over one (``x.models[i]``, ``tree.leaf_value[k]``)."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and node.attr in _R16_ENSEMBLE_ATTRS:
        return node.attr
    return None


def _r16_has_bump(fi: FuncInfo) -> bool:
    for node in _own_body(fi):
        if isinstance(node, ast.Call):
            fn = dotted_name(node.func) or ""
            if fn.split(".")[-1] == _R16_BUMP:
                return True
    return False


@register_rule("R16", "mutation-outside-version-bump")
def r16_mutation_outside_version_bump(pkg: PackageIndex) -> Iterator[Finding]:
    """An ensemble-mutating write in serve/continual code that does not
    route through ``_invalidate_pred_cache``: assigning to ``.models`` /
    ``._models`` / ``.leaf_value`` (whole, element, or slice) or calling
    a list mutator on them, in a function whose own body never bumps the
    pack version.  The ``_packed`` cache is keyed on
    ``_pack_version``; a mutation that skips the bump leaves the CURRENT
    version's device pack describing trees that no longer exist — a
    live serving reader then returns predictions from the pre-mutation
    ensemble indefinitely (stale, not just racy), and the lock
    making bump+lookup atomic cannot help a bump that never happens.
    Scoped to modules under ``serve/`` and ``continual/`` directories —
    the code that runs beside live serving readers; trainer-side
    mutations elsewhere are covered by the versioned key's belt-and-
    braces components and the runtime budget pins (static-limits note in
    docs/ANALYSIS.md)."""
    hint = ("mutate, then call gbdt._invalidate_pred_cache('<reason>') in "
            "the SAME function (continual/refit.py::refit_leaves is the "
            "pattern) — or mutate a private clone and publish it through "
            "ServingRuntime.swap_model")
    for mod in pkg.modules.values():
        parts = getattr(mod.path, "parts", ())
        if not any(d in parts for d in _R16_SCOPED_DIRS):
            continue
        for fi in mod.functions.values():
            if _r16_has_bump(fi):
                continue
            for node in _own_body(fi):
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (node.targets
                               if isinstance(node, ast.Assign)
                               else [node.target])
                    for t in targets:
                        attr = _r16_ensemble_attr(t)
                        if attr is not None:
                            yield _finding(
                                fi, node, "R16",
                                f"write to .{attr} in {fi.qualname} "
                                "without a _pack_version bump — the "
                                "serving pack cache now describes trees "
                                "that no longer exist", hint)
                elif (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in _R16_LIST_MUTATORS):
                    attr = _r16_ensemble_attr(node.func.value)
                    if attr is not None:
                        yield _finding(
                            fi, node, "R16",
                            f".{attr}.{node.func.attr}(...) in "
                            f"{fi.qualname} without a _pack_version bump "
                            "— an in-place ensemble edit invisible to "
                            "the versioned pack cache", hint)


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# R17 — full-histogram-over-dcn
# ---------------------------------------------------------------------------

_R17_COLLECTIVES = ("psum", "psum_scatter", "all_gather", "pmean",
                    "all_to_all", "ppermute", "pmax", "pmin",
                    "all_gather_ragged", "broadcast_from")
# gather-style calls whose result is top-k-shaped by construction: an
# operand assigned from one of these is an elected subset, not the
# full-F plane
_R17_TOPK_GATHERS = ("take_along_axis", "top_k", "dynamic_slice",
                     "dynamic_slice_in_dim")


def _r17_axis_mentions_dcn(axis_arg: ast.AST) -> bool:
    """The collective's axis expression references the DCN axis: the
    'dcn' string literal, the DCN_AXIS constant, or any dcn-named
    variable — including tuple axes like (ICI_AXIS, DCN_AXIS)."""
    for sub in ast.walk(axis_arg):
        if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                and "dcn" in sub.value.lower()):
            return True
        if isinstance(sub, ast.Name) and "dcn" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and "dcn" in sub.attr.lower():
            return True
    return False


def _r17_hist_name(expr: ast.AST) -> Optional[str]:
    """The operand's name when it reads as a histogram buffer."""
    if isinstance(expr, ast.Subscript):
        return _r17_hist_name(expr.value)
    if isinstance(expr, ast.Name):
        nm = expr.id
    elif isinstance(expr, ast.Attribute):
        nm = expr.attr
    else:
        return None
    return nm if "hist" in nm.lower() else None


def _r17_topk_shaped(fi: FuncInfo, name: str) -> bool:
    """True when ``name`` is assigned (anywhere in the function) from a
    top-k gather — take_along_axis / top_k / dynamic_slice family — so a
    hist-named operand is actually an elected feature subset."""
    for node in _own_body(fi, include_nested=True):
        if not isinstance(node, ast.Assign):
            continue
        targets = {t.id for t in node.targets if isinstance(t, ast.Name)}
        if name not in targets:
            continue
        for sub in ast.walk(node.value):
            if isinstance(sub, ast.Call):
                fn = dotted_name(sub.func) or ""
                if fn.split(".")[-1] in _R17_TOPK_GATHERS:
                    return True
    return False


@register_rule("R17", "full-histogram-over-dcn")
def r17_full_histogram_over_dcn(pkg: PackageIndex) -> Iterator[Finding]:
    """A collective whose axis set includes the DCN axis moving a FULL
    histogram operand.  The hierarchical two-level merge's contract
    (docs/DISTRIBUTED.md "Hierarchical merge") is that full (…, F, B)
    histogram planes merge only INSIDE a slice's ICI axis — crossing
    DCN is reserved for top-k-shaped payloads (elected feature columns,
    gathered by the vote's indices) and scalars, because DCN bandwidth
    is an order of magnitude below ICI and a full-F merge there erases
    the multi-slice speedup at exactly the scale it was bought for.
    Statically: any collective (parallel/collectives.py; its mesh
    argument stands where the JAX package's axis name does) whose mesh
    expression references the dcn axis and whose operand NAMES a histogram
    (``*hist*``) is flagged, unless that operand is assigned from a
    top-k gather (``take_along_axis``/``top_k``/``dynamic_slice``) in
    the same function — the elected-subset shape
    ``parallel/hierarchy.py::dcn_topk_best`` ships.  Name-heuristic by
    necessity (the AST has no avals); the trace audit's ``dcn_max_bytes``
    contract pin is the sound byte-level half (trace_audit.py J1)."""
    hint = ("merge full histograms over the ici axis only; cross dcn "
            "with the elected top-k feature columns "
            "(parallel/hierarchy.py::dcn_topk_best) or scalars — see "
            "docs/DISTRIBUTED.md 'Hierarchical merge' and the "
            "trace audit's dcn_max_bytes pin")
    for mod in pkg.modules.values():
        for fi in mod.functions.values():
            if fi.parent is not None:
                # nested defs are walked through their ENCLOSING function
                # (include_nested below) — visiting them again would both
                # duplicate findings and lose sight of a top-k gather
                # assigned in the enclosing scope (the R3 discipline)
                continue
            for node in _own_body(fi, include_nested=True):
                if not isinstance(node, ast.Call):
                    continue
                fn = dotted_name(node.func)
                if fn is None or fn.split(".")[-1] not in _R17_COLLECTIVES:
                    continue
                if not node.args:
                    continue
                axis_arg = None
                for kw in node.keywords:
                    if kw.arg in ("axis_name", "axis", "mesh"):
                        axis_arg = kw.value
                if axis_arg is None and len(node.args) > 1:
                    axis_arg = node.args[1]
                if axis_arg is None or not _r17_axis_mentions_dcn(axis_arg):
                    continue
                hist_nm = _r17_hist_name(node.args[0])
                if hist_nm is None:
                    continue
                if _r17_topk_shaped(fi, hist_nm):
                    continue
                yield _finding(
                    fi, node, "R17",
                    f"{fn}({hist_nm}, …) in {fi.qualname} moves a full "
                    "histogram operand across the dcn axis — the "
                    "cross-slice merge must be top-k-shaped or scalar",
                    hint)


# ---------------------------------------------------------------------------
# R18 — host-loop-over-independent-boosters

# ---------------------------------------------------------------------------
# R18 — host-loop-over-independent-boosters
# ---------------------------------------------------------------------------

# the per-model entry points a fleet batches: one dispatch per round for
# ALL models (ops/treegrow_fleet.py) instead of one per model per round
_R18_ENTRIES = ("train_one_iter", "refit_leaves")
# "train" is a common verb — only the package entry spellings count
# (bare `train` from `from lightgbm_tpu_torch import train`, or qualified
# through the canonical module aliases); `self.train()` methods do not
_R18_TRAIN_QUALS = ("train", "lgb.train", "engine.train",
                    "lightgbm_tpu_torch.train", "lightgbm_tpu_torch.engine.train")


def _r18_is_entry(fn: str) -> bool:
    last = fn.split(".")[-1]
    if last in _R18_ENTRIES:
        return True
    return fn in _R18_TRAIN_QUALS


def _r18_walk_no_defs(node: ast.AST) -> Iterator[ast.AST]:
    """ast.walk minus nested function defs — their bodies are their own
    FuncInfo's territory (the _own_body discipline)."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield child
        yield from _r18_walk_no_defs(child)


def _r18_loop_assigned(loop: ast.For) -> set:
    """Names assigned by statements in the loop body — the loop-carried
    candidates.  A call argument reading one of these means iteration i
    consumes iteration i-1's output (warm-started training, a running
    score feeding the next refit): sequentially dependent, not a fleet."""
    out = set()
    for node in ast.walk(loop):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for sub in ast.walk(t):
                    if isinstance(sub, ast.Name):
                        out.add(sub.id)
        elif isinstance(node, ast.AugAssign):
            if isinstance(node.target, ast.Name):
                out.add(node.target.id)
    return out


@register_rule("R18", "host-loop-over-independent-boosters")
def r18_host_loop_over_independent_boosters(
        pkg: PackageIndex) -> Iterator[Finding]:
    """A host ``for`` loop training or refitting boosters one model per
    iteration with no cross-iteration data dependence: each pass calls
    ``train`` / ``train_one_iter`` / ``refit_leaves`` on its own
    element of a model list/dict, so every round costs one dispatch PER
    MODEL — B dispatch fees, B recompilation keys, B host round-trips —
    for work that is one vmapped dispatch in total.  The booster fleet
    (``lgb.train_fleet``, ``ops/treegrow_fleet.py``) trains B
    independent boosters in ONE donated dispatch per round, and
    ``continual.fleet_refit_leaves`` is the batched refit twin; at
    B=64 the batched path is the difference between a fleet sweep and a
    lunch break (BENCH_fleet artifacts).  A call argument that READS a
    name assigned inside the loop body is a loop-carried dependence
    (warm-start chains like ``bst = train(..., init_model=bst)``, a
    running score feeding the next refit) — sequential by construction,
    not flagged.  Name-heuristic on the entry spellings: bare/qualified
    package ``train`` plus any ``train_one_iter``/``refit_leaves``
    (methods named ``.train`` on other objects are out of scope)."""
    hint = ("batch the models: lgb.train_fleet(datasets, params) trains "
            "B boosters in one dispatch per round "
            "(lightgbm_tpu/models/fleet.py); "
            "continual.fleet_refit_leaves batches the refit — or "
            "suppress with the dependence that makes the loop "
            "sequential")
    for mod in pkg.modules.values():
        for fi in mod.functions.values():
            seen = set()
            for node in _own_body(fi):
                if not isinstance(node, ast.For):
                    continue
                carried = _r18_loop_assigned(node)
                for sub in _r18_walk_no_defs(node):
                    if not isinstance(sub, ast.Call) or id(sub) in seen:
                        continue
                    fn = dotted_name(sub.func)
                    if fn is None and isinstance(sub.func, ast.Attribute):
                        # subscripted receiver (lanes[i].train_one_iter):
                        # no dotted spelling, but the method name decides
                        if sub.func.attr in _R18_ENTRIES:
                            fn = sub.func.attr
                    if fn is None or not _r18_is_entry(fn):
                        continue
                    seen.add(id(sub))
                    arg_names = {
                        s.id for a in (list(sub.args)
                                       + [k.value for k in sub.keywords])
                        for s in ast.walk(a) if isinstance(s, ast.Name)}
                    if arg_names & carried:
                        continue  # loop-carried input: sequential
                    yield _finding(
                        fi, sub, "R18",
                        f"{fn}(...) inside {fi.qualname}'s host loop "
                        "trains/refits one model per iteration — B "
                        "independent models cost B dispatches per round "
                        "where a fleet costs one", hint)


# ---------------------------------------------------------------------------
# R19 — unbounded-retry
# ---------------------------------------------------------------------------

# IO/dispatch-ish call spellings worth retry discipline: a failure here is
# transient-by-nature (network, device runtime, filesystem), which is what
# tempts the swallow-and-spin loop this rule exists to catch
_R19_IO_RE = re.compile(
    r"(request|urlopen|fetch|download|upload|connect|send|recv|rpc|query"
    r"|dispatch|predict|submit|read|write|open|post|push|pull)",
    re.IGNORECASE)
# loop identifiers that evidence a retry BUDGET or DEADLINE — any of these
# appearing anywhere in the loop (test or body) means the author bounded it
_R19_BUDGET_RE = re.compile(
    r"(attempt|retr(y|ies)|budget|deadline|tries|remaining|give_up|giveup)",
    re.IGNORECASE)
# pacing call spellings: a loop that sleeps, backs off, or waits between
# attempts cannot hot-spin
_R19_PACING = ("sleep", "wait")
_R19_PACING_RE = re.compile(r"(backoff|jitter)", re.IGNORECASE)
# exception spellings broad enough to swallow EVERY transient failure —
# catching these without re-raising, bounding or pacing is the hallmark
_R19_BROAD = ("Exception", "BaseException", "OSError", "IOError",
              "EnvironmentError", "TimeoutError", "ConnectionError")


def _r19_is_broad_handler(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in types:
        nm = dotted_name(e)
        if nm is not None and nm.split(".")[-1] in _R19_BROAD:
            return True
    return False


def _r19_handler_escapes(handler: ast.ExceptHandler) -> bool:
    """True when the handler leaves the loop or re-raises — the failure
    is surfaced, not swallowed back into another attempt."""
    for node in _r18_walk_no_defs(handler):
        if isinstance(node, (ast.Raise, ast.Break, ast.Return)):
            return True
    return False


def _r19_is_pacing_call(node: ast.Call) -> bool:
    fn = dotted_name(node.func)
    last = (fn.split(".")[-1] if fn is not None
            else getattr(node.func, "attr", ""))
    if last in _R19_PACING or _R19_PACING_RE.search(last or ""):
        return True
    # a bare `.get()` / `.get(timeout=...)` on some receiver is a BLOCKING
    # queue handoff — the worker-loop shape (the serve dispatcher): the
    # loop stalls for fresh WORK between iterations, so it cannot spin.
    # `dict.get(key)` passes positional args and does not count.
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr == "get" and not node.args)


def _r19_loop_is_paced_or_bounded(loop: ast.While) -> bool:
    for node in _r18_walk_no_defs(loop):
        if isinstance(node, ast.Call) and _r19_is_pacing_call(node):
            return True
        if isinstance(node, ast.Name) and _R19_BUDGET_RE.search(node.id):
            return True
        if (isinstance(node, ast.Attribute)
                and _R19_BUDGET_RE.search(node.attr)):
            return True
    # the loop TEST is not inside walk(loop)'s body-only iteration? it is —
    # ast.iter_child_nodes(While) yields test first; kept explicit anyway
    for node in ast.walk(loop.test):
        if isinstance(node, ast.Name) and _R19_BUDGET_RE.search(node.id):
            return True
    return False


@register_rule("R19", "unbounded-retry")
def r19_unbounded_retry(pkg: PackageIndex) -> Iterator[Finding]:
    """A ``while`` loop that swallows broad exceptions around an
    IO/dispatch-ish call and loops straight back into the next attempt —
    no sleep/backoff/jitter between tries, no attempt budget, no
    deadline.  Under a persistent failure (a device runtime wedged, an
    endpoint down, a full disk) the loop hot-spins: 100% host CPU,
    a log volcano, and — when the callee holds locks or device queues —
    a livelock that looks exactly like the hang it was written to
    survive.  The serve fleet's discipline is the counter-example
    (serve/fleet.py): every redispatch pays a retry-budget token, every
    restart backs off exponentially with jitter, and deadlines turn a
    sick fleet into typed shedding.  Statically: a ``while`` containing
    a ``try`` whose handler catches ``Exception``/``BaseException``/
    ``OSError``/``TimeoutError``/bare without raising or leaving the
    loop, whose try body makes an IO-ish call, in a loop with no pacing
    call (``sleep``/``wait``/``backoff``/``jitter``/blocking queue
    ``.get()``) and no budget/deadline identifier
    (``attempt``/``retry``/``budget``/``deadline``/``tries``/
    ``remaining``).  Narrow catches (``except Empty``) pass clean —
    they name the one expected failure instead of swallowing all of
    them."""
    hint = ("bound the loop: pace attempts (time.sleep with exponential "
            "backoff + jitter), spend a retry budget, or check a "
            "deadline — and re-raise or surface the error once the "
            "budget is gone (serve/fleet.py::_retry_or_fail_locked is "
            "the in-tree shape); narrow the except to the one expected "
            "failure where possible")
    for mod in pkg.modules.values():
        for fi in mod.functions.values():
            for node in _own_body(fi):
                if not isinstance(node, ast.While):
                    continue
                if _r19_loop_is_paced_or_bounded(node):
                    continue
                for sub in _r18_walk_no_defs(node):
                    if not isinstance(sub, ast.Try):
                        continue
                    broad = [h for h in sub.handlers
                             if _r19_is_broad_handler(h)
                             and not _r19_handler_escapes(h)]
                    if not broad:
                        continue
                    io_call = None
                    for b in sub.body:
                        for c in _r18_walk_no_defs(b):
                            if isinstance(c, ast.Call):
                                fn = (dotted_name(c.func)
                                      or getattr(c.func, "attr", ""))
                                if fn and _R19_IO_RE.search(fn):
                                    io_call = fn.split(".")[-1]
                                    break
                        if io_call:
                            break
                    if io_call is None:
                        continue
                    yield _finding(
                        fi, sub, "R19",
                        f"retry loop in {fi.qualname} swallows broad "
                        f"exceptions around {io_call}(...) with no "
                        "backoff, budget or deadline — a persistent "
                        "failure hot-spins forever", hint)
                    break  # one finding per loop is enough


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# R20 — feature-axis-hist-collective
# ---------------------------------------------------------------------------


def _r20_axis_mentions_feature(axis_arg: ast.AST) -> bool:
    """The axis expression references the feature mesh axis: the string
    literal, the FEATURE_AXIS mesh constant, or a *feature*-named
    variable/attribute (feature_axis_name) — including inside a tuple."""
    for sub in ast.walk(axis_arg):
        if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                and "feature" in sub.value.lower()):
            return True
        if isinstance(sub, ast.Name) and "feature" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and "feature" in sub.attr.lower():
            return True
    return False


@register_rule("R20", "feature-axis-hist-collective")
def r20_feature_axis_hist_collective(pkg: PackageIndex) -> Iterator[Finding]:
    """A collective whose axis set includes the FEATURE mesh axis moving a
    histogram operand.  The 2-D (feature x row) layout's entire point
    (docs/DISTRIBUTED.md "2-D sharding", parallel/feature2d.py) is that
    each device's ``(F/d_f, N/d_r)`` bin tile builds histograms that are
    already COMPLETE for the owned feature block — the merge is the row
    psum alone, and the feature axis carries only the winner's go/no-go
    row broadcast and election scalars.  A histogram collective over the
    feature axis re-replicates what the layout made local, paying d_f
    times the merge bytes to erase the axis the mesh was widened for.
    Statically: any collective whose mesh expression references the
    feature axis and whose first operand NAMES a
    histogram (``*hist*``) is flagged, unless that operand is assigned
    from a top-k gather in the same function (an elected subset, the R17
    escape).  Name-heuristic by necessity; the ``windowed_round_2d_*``
    trace-audit contracts are the sound IR-level half — they pin ZERO
    feature-axis collectives in the histogram phase and bill every axis's
    bytes (docs/ANALYSIS.md)."""
    hint = ("histograms over the feature-sharded bin tile are complete "
            "for the owned block by layout — merge over the row axis "
            "only, and cross the feature axis with the winner's row "
            "decisions or election scalars "
            "(parallel/feature2d.py, docs/DISTRIBUTED.md '2-D sharding')")
    for mod in pkg.modules.values():
        for fi in mod.functions.values():
            if fi.parent is not None:
                # nested defs walk through their enclosing function (the
                # R17 discipline): one visit, enclosing-scope gathers seen
                continue
            for node in _own_body(fi, include_nested=True):
                if not isinstance(node, ast.Call):
                    continue
                fn = dotted_name(node.func)
                if fn is None or fn.split(".")[-1] not in _R17_COLLECTIVES:
                    continue
                if not node.args:
                    continue
                axis_arg = None
                for kw in node.keywords:
                    if kw.arg in ("axis_name", "axis", "mesh"):
                        axis_arg = kw.value
                if axis_arg is None and len(node.args) > 1:
                    axis_arg = node.args[1]
                if axis_arg is None or not _r20_axis_mentions_feature(
                        axis_arg):
                    continue
                hist_nm = _r17_hist_name(node.args[0])
                if hist_nm is None:
                    continue
                if _r17_topk_shaped(fi, hist_nm):
                    continue
                yield _finding(
                    fi, node, "R20",
                    f"{fn}({hist_nm}, …) in {fi.qualname} moves a "
                    "histogram operand across the feature axis — the "
                    "feature-sharded tile's histograms are complete for "
                    "the owned block; merge over the row axis only",
                    hint)



# ---------------------------------------------------------------------------
# R21 — unlinked-cross-thread-span
# ---------------------------------------------------------------------------

# span-creation call names (last dotted component): the obs/trace.py API
# surface that records into the span ring
_R21_SPAN_CALLS = ("span", "record_span", "Span")
# a span call carrying any of these keywords names its causal identity
# explicitly and is immune to the thread-local-stack trap
_R21_LINK_KWARGS = ("ctx", "parent", "links")


def _r21_thread_entry_names(mod) -> set:
    """Names of functions this module hands to a worker thread: the
    ``target=`` of any ``*.Thread(...)`` ctor, or the first argument of
    any ``*.submit(...)`` call (executor dispatch).  Both ``self._fn``
    and bare ``fn`` references resolve to their last component — entry
    functions are matched per-module by unqualified name."""
    names: set = set()

    def ref_name(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Attribute):
            return node.attr
        if isinstance(node, ast.Name):
            return node.id
        return None

    for fi in mod.functions.values():
        for node in _own_body(fi):
            if not isinstance(node, ast.Call):
                continue
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "Thread"):
                for kw in node.keywords:
                    if kw.arg == "target":
                        nm = ref_name(kw.value)
                        if nm:
                            names.add(nm)
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "submit" and node.args):
                nm = ref_name(node.args[0])
                if nm:
                    names.add(nm)
    return names


@register_rule("R21", "unlinked-cross-thread-span")
def r21_unlinked_cross_thread_span(pkg: PackageIndex) -> Iterator[Finding]:
    """A span created INSIDE a thread-entry function — one
    handed to ``threading.Thread(target=...)`` or ``executor.submit(...)``
    in the same module — without an explicit causal identity: no ``ctx=``,
    ``parent=`` or ``links=`` keyword on the ``span(``/``record_span(``/
    ``Span(`` call, and no ``.link(`` call in the function's own body.
    The span stack that supplies implicit parentage is THREAD-LOCAL
    (``obs/trace.py``): on a worker thread it is empty, so an implicit
    span silently roots a brand-new top-level trace instead of joining
    the request that crossed the thread boundary — the request's slice
    then reconstructs without its dispatch/leg spans and the flight
    recorder shows a broken story.
    Scoped to ``serve/``/``continual/`` modules — where worker threads
    carry request/rollover contexts; own-body only (a helper the entry
    calls is that helper's finding when it, too, becomes an entry —
    static-limits note in docs/ANALYSIS.md)."""
    hint = ("carry the TraceContext across the boundary explicitly: mint "
            "or receive a ctx on the queued work item and pass ctx=/"
            "parent= to span()/record_span(), or adopt members via "
            "links=[...] (serve/runtime.py::_dispatch_loop is the "
            "pattern); an intentional rootless maintenance span takes a "
            "pragma with its reason")
    for mod in pkg.modules.values():
        parts = getattr(mod.path, "parts", ())
        if not any(d in parts for d in _R16_SCOPED_DIRS):
            continue
        entries = _r21_thread_entry_names(mod)
        if not entries:
            continue
        for fi in mod.functions.values():
            if fi.qualname.split(".")[-1] not in entries:
                continue
            linked_via_api = any(
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "link"
                for n in _own_body(fi))
            if linked_via_api:
                continue
            for node in _own_body(fi):
                if not isinstance(node, ast.Call):
                    continue
                fn = dotted_name(node.func)
                if fn is None or fn.split(".")[-1] not in _R21_SPAN_CALLS:
                    continue
                if any(kw.arg in _R21_LINK_KWARGS for kw in node.keywords):
                    continue
                yield _finding(
                    fi, node, "R21",
                    f"{fn}(...) in thread-entry {fi.qualname} without "
                    "ctx=/parent=/links= — the thread-local span stack is "
                    "empty on a worker thread, so this span roots a NEW "
                    "trace instead of joining the request that crossed "
                    "the boundary",
                    hint)
