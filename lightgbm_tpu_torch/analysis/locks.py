"""jaxlint concurrency layer: lock-discipline rules L1-L5.

A copy of lightgbm_tpu/analysis/locks.py (it imports no JAX; the port
keeps its own copy rather than importing the JAX package), with the lock
factories those of :mod:`lightgbm_tpu_torch.utils.locktrace`, the port's
copy of the runtime lock tracer.  The rules and their meaning are the JAX
package's: tests/test_torch_lint_rules.py holds the two analyzers' L
findings equal on the same sources.

The package is genuinely concurrent — the serve coalescer/dispatcher
pair, the continual runner, the periodic-snapshot and watchdog threads,
and the HTTP server all share mutable state behind ~10 ad-hoc locks, and
their races were found by hand-auditing; this layer turns that checklist
into a pinned contract, the way R1-R21 pin round-body purity and J1-J7
the round bodies' dispatch.

The pass builds a whole-package **lock model** from the ASTs the shared
:class:`~.core.PackageIndex` already parsed:

* *lock definitions* — ``self._x = threading.Lock()/RLock()/Condition()``
  (or the :mod:`lightgbm_tpu_torch.utils.locktrace` factories ``lock()`` /
  ``rlock()`` / ``condition()``) on instance attributes, and the same
  assigned to module-level names.  Each definition gets a canonical id
  ``module.Class._attr`` / ``module._name``.
* *lock getters* — a zero-arg method whose body returns one of the
  class's known lock attributes (``GBDT._plock``): ``with self._plock():``
  acquires the attribute the getter manages.
* *acquisition sites* — ``with <lock>:`` blocks over any of the above.
* *held sets* — for every statement, which locks are held lexically; a
  method called ONLY from under-lock sites additionally inherits the
  intersection of its callers' held sets (one-level-deep contextual
  propagation through ``self.meth()`` and same-module calls), so the
  "caller holds _lock" helper idiom is analyzed in its real context.
* *guarded mutations* — attribute stores/augmented-assigns/del and
  mutating method calls (``append``/``pop``/``update``/...) recorded
  with the held set in effect.

Rules (catalogue + examples: docs/ANALYSIS.md "Concurrency layer"):

====  ==========================  ========================================
L1    lock-order-inversion        the static acquired-while-holding graph
                                  has a cycle (A taken under B somewhere,
                                  B under A elsewhere)
L2    blocking-call-under-lock    device sync (np.asarray / .item() /
                                  block_until_ready / sync_pull), file
                                  I/O, subprocess, socket or sleep inside
                                  a held-lock body
L3    unguarded-shared-mutation   an attribute mutated under a lock at
                                  one site is mutated with NO guard at
                                  another (outside __init__)
L4    wait-without-predicate-loop Condition.wait outside a while loop
                                  (lost-wakeup / spurious-wakeup hazard)
L5    orphan-thread               threading.Thread started with neither a
                                  join() nor a stop-Event path in module
====  ==========================  ========================================

Pragmas work exactly like the AST layer's::

    self._fh.write(line)  # jaxlint: disable=L2 (dedicated IO leaf lock)

Static limits (also in docs/ANALYSIS.md): ``.acquire()``/``.release()``
call pairs are invisible (only ``with`` blocks count); contextual held
sets propagate through resolvable calls only (``self.meth()`` and
same-module function calls — calls through containers or callbacks are
not followed); L2 flags DIRECT blocking calls under a lock, not blocking
work buried in transitively-called functions; L3 treats "held ANY lock
that guards this attribute elsewhere" as guarded.  The runtime witness
graph (:mod:`lightgbm_tpu_torch.utils.locktrace`) covers the dynamic orders
the static pass cannot see.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .core import (Finding, FuncInfo, ModuleInfo, PackageIndex, dotted_name,
                   register_rule)

# receivers whose .write/.flush/.close under a lock count as file I/O:
# the attribute name (last segment) must contain one of these fragments
_FH_NAME_FRAGMENTS = ("fh", "file", "fp", "sock", "stream")
# attribute calls that are blocking no matter the receiver
_BLOCKING_ATTR_CALLS = {
    "block_until_ready": "device sync",
    "item": "device sync (host pull)",
    "tolist": "device sync (host pull)",
}
# numpy conversions of (potentially) device values
_NP_SYNC_FUNCS = ("asarray", "array")
_NUMPY_ALIASES = ("np", "numpy", "onp")
# dotted-call prefixes that block
_BLOCKING_DOTTED_PREFIXES = {
    "subprocess.": "subprocess",
    "socket.": "socket",
    "urllib.": "network I/O",
    "requests.": "network I/O",
    "shutil.": "file I/O",
    "time.sleep": "sleep",
    "os.replace": "file I/O",
    "os.rename": "file I/O",
    "os.fsync": "file I/O",
    "os.remove": "file I/O",
    "os.makedirs": "file I/O",
}
# container-mutating method names for L3 (same set R16 polices, plus dict)
_MUTATOR_METHODS = ("append", "extend", "insert", "pop", "popleft", "remove",
                    "clear", "update", "setdefault", "appendleft", "sort")
_LOCK_FACTORY_ATTRS = ("Lock", "RLock", "Condition")
_LOCKTRACE_FACTORIES = ("lock", "rlock", "condition")
_LOCKTRACE_MODULE_ALIASES = ("locktrace", "_locktrace", "_lt")


def _is_lock_ctor(node: ast.AST) -> Optional[str]:
    """``threading.Lock()`` / ``locktrace.condition("name")`` -> kind
    ("lock" | "rlock" | "condition"), else None."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)):
        if f.value.id == "threading" and f.attr in _LOCK_FACTORY_ATTRS:
            return {"Lock": "lock", "RLock": "rlock",
                    "Condition": "condition"}[f.attr]
        if (f.value.id in _LOCKTRACE_MODULE_ALIASES
                and f.attr in _LOCKTRACE_FACTORIES):
            return f.attr
    return None


class LockDef:
    """One declared lock: canonical id + kind + declaration site."""

    __slots__ = ("lock_id", "kind", "module", "line", "attr", "cls")

    def __init__(self, lock_id: str, kind: str, module: str, line: int,
                 attr: str, cls: Optional[str]) -> None:
        self.lock_id = lock_id      # "mod.Class._attr" or "mod._name"
        self.kind = kind            # lock | rlock | condition
        self.module = module
        self.line = line
        self.attr = attr            # bare attribute / name ("_cv")
        self.cls = cls              # owning class qualname or None


class MutationSite:
    __slots__ = ("fi", "node", "attr", "held")

    def __init__(self, fi: FuncInfo, node: ast.AST, attr: str,
                 held: Tuple[str, ...]) -> None:
        self.fi = fi
        self.node = node
        self.attr = attr  # "Class.attr" or "mod.name" for globals
        self.held = held


class LockModel:
    """The whole-package lock facts every L rule shares (built once per
    :func:`build_model` call and cached on the PackageIndex)."""

    def __init__(self, pkg: PackageIndex) -> None:
        self.pkg = pkg
        # lock_id -> LockDef
        self.locks: Dict[str, LockDef] = {}
        # (module, class) -> {attr -> lock_id}
        self.class_locks: Dict[Tuple[str, str], Dict[str, str]] = {}
        # module -> {name -> lock_id} (module-level locks)
        self.module_locks: Dict[str, Dict[str, str]] = {}
        # (module, class) -> {getter method name -> lock attr}
        self.lock_getters: Dict[Tuple[str, str], Dict[str, str]] = {}
        # fi.key -> locks held at entry via caller propagation
        self.entry_held: Dict[Tuple[str, str], Set[str]] = {}
        # directed acquired-while-holding edges:
        # (held, acquired) -> (file, line) of the first site seen
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self._collect_locks()
        self._collect_getters()
        self._propagate_entry_held()
        self._collect_edges()

    # -- lock discovery ---------------------------------------------------
    def _collect_locks(self) -> None:
        for mod in self.pkg.modules.values():
            # module-level: `_lock = threading.RLock()`
            for node in mod.tree.body:
                if (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    kind = _is_lock_ctor(node.value)
                    if kind:
                        name = node.targets[0].id
                        lid = f"{mod.name}.{name}"
                        self.locks[lid] = LockDef(lid, kind, mod.name,
                                                  node.lineno, name, None)
                        self.module_locks.setdefault(mod.name, {})[name] = lid
            # instance attrs: `self._x = threading.Lock()` anywhere in a
            # method (init, lazy recreation, setstate)
            for fi in mod.functions.values():
                cls = self._owning_class(fi)
                if cls is None:
                    continue
                for node in self.pkg._own_body_walk(fi):
                    if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                        continue
                    value = node.value
                    kind = _is_lock_ctor(value)
                    if not kind:
                        continue
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    for t in targets:
                        # `lock = self._pack_lock = threading.RLock()`
                        # chains: take every self-attr target
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            lid = f"{mod.name}.{cls}.{t.attr}"
                            if lid not in self.locks:
                                self.locks[lid] = LockDef(
                                    lid, kind, mod.name, node.lineno,
                                    t.attr, cls)
                            self.class_locks.setdefault(
                                (mod.name, cls), {})[t.attr] = lid

    @staticmethod
    def _owning_class(fi: FuncInfo) -> Optional[str]:
        """'Class' for a method qualname 'Class.meth', else None (nested
        defs inside methods keep the class prefix, so split on the last
        dot only when the prefix names a class — heuristically: the
        qualname has >= 2 parts and the function is not nested in
        another function)."""
        if fi.parent is not None:
            return LockModel._owning_class(fi.parent)
        if "." in fi.qualname:
            return fi.qualname.rsplit(".", 1)[0]
        return None

    def _collect_getters(self) -> None:
        """Methods whose body returns (or lazily creates and returns) one
        of the class's lock attributes: ``with self._plock():`` then
        acquires that attribute's lock."""
        for mod in self.pkg.modules.values():
            for fi in mod.functions.values():
                cls = self._owning_class(fi)
                if cls is None:
                    continue
                attrs = self.class_locks.get((mod.name, cls), {})
                if not attrs:
                    continue
                meth = fi.qualname.rsplit(".", 1)[-1]
                for node in ast.walk(fi.node):
                    if not isinstance(node, ast.Return) or node.value is None:
                        continue
                    v = node.value
                    # `return self._x` / `return lock` where lock was read
                    # from self._x earlier — handle the direct form plus a
                    # Name whose function body reads getattr(self,"_x")
                    target_attr = None
                    if (isinstance(v, ast.Attribute)
                            and isinstance(v.value, ast.Name)
                            and v.value.id == "self" and v.attr in attrs):
                        target_attr = v.attr
                    elif isinstance(v, ast.Name):
                        for sub in ast.walk(fi.node):
                            if (isinstance(sub, ast.Call)
                                    and isinstance(sub.func, ast.Name)
                                    and sub.func.id == "getattr"
                                    and len(sub.args) >= 2
                                    and isinstance(sub.args[1], ast.Constant)
                                    and sub.args[1].value in attrs):
                                target_attr = sub.args[1].value
                                break
                    if target_attr:
                        self.lock_getters.setdefault(
                            (mod.name, cls), {})[meth] = target_attr
                        break

    # -- resolution -------------------------------------------------------
    def resolve_lock_expr(self, fi: FuncInfo, expr: ast.AST) -> Optional[str]:
        """``with <expr>:`` -> lock_id when expr names a known lock."""
        mod = fi.module
        cls = self._owning_class(fi)
        # self._x  /  self._cv
        if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and cls is not None):
            return self.class_locks.get((mod.name, cls), {}).get(expr.attr)
        # module-level `_lock`
        if isinstance(expr, ast.Name):
            return self.module_locks.get(mod.name, {}).get(expr.id)
        # self._plock()  (lock getter)
        if (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute)
                and isinstance(expr.func.value, ast.Name)
                and expr.func.value.id == "self" and cls is not None):
            attr = self.lock_getters.get((mod.name, cls), {}).get(
                expr.func.attr)
            if attr:
                return self.class_locks.get((mod.name, cls), {}).get(attr)
        return None

    def resolve_method_call(self, fi: FuncInfo, call: ast.Call
                            ) -> Optional[FuncInfo]:
        """Resolve ``self.meth(...)`` to the same-class FuncInfo, or a
        bare/module call through the core call graph."""
        f = call.func
        cls = self._owning_class(fi)
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id == "self" and cls is not None):
            return fi.module.functions.get(f"{cls}.{f.attr}")
        target = self.pkg.resolve_call(fi.module, f)
        if target is not None:
            return self.pkg.lookup(target)
        return None

    # -- held-set walk ----------------------------------------------------
    def walk_held(self, fi: FuncInfo):
        """Yield ``(node, held)`` for every node in fi's own body, where
        ``held`` is the tuple of lock_ids held lexically at that node
        (entry-inherited locks first, innermost ``with`` last).  A
        ``with``-statement node and its context expressions are reported
        under the OUTER held set; its body under the inner one.  Nested
        defs/lambdas are skipped (they run later, on their own)."""
        base = tuple(sorted(self.entry_held.get(fi.key, set())))
        skip = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

        def emit(node: ast.AST, held: Tuple[str, ...]):
            if isinstance(node, skip):
                return
            yield (node, held)
            if isinstance(node, ast.With):
                acquired: List[str] = []
                for item in node.items:
                    lid = self.resolve_lock_expr(fi, item.context_expr)
                    if lid:
                        acquired.append(lid)
                    yield from walk(item, held)
                inner = held + tuple(a for a in acquired if a not in held)
                for stmt in node.body:
                    yield from emit(stmt, inner)
            else:
                yield from walk(node, held)

        def walk(node: ast.AST, held: Tuple[str, ...]):
            for child in ast.iter_child_nodes(node):
                yield from emit(child, held)

        for stmt in fi.node.body:
            yield from emit(stmt, base)

    def _direct_acquires(self, fi: FuncInfo) -> Set[str]:
        out: Set[str] = set()
        for node in self.pkg._own_body_walk(fi):
            if isinstance(node, ast.With):
                for item in node.items:
                    lid = self.resolve_lock_expr(fi, item.context_expr)
                    if lid:
                        out.add(lid)
        return out

    def _propagate_entry_held(self) -> None:
        """Contextual held sets: a PRIVATE function called only from
        under-lock sites inherits the intersection of its callers' held
        sets — the ``def _helper(self): ... # caller holds _lock`` idiom
        analyzed in its real context.  Public functions are API surface
        (open world: external callers the index cannot see), so they
        never inherit — only leading-underscore callees, whose in-package
        call graph is complete, do.  A bounded monotone fixpoint over
        resolvable calls (``self.meth()`` + same-module names)."""
        all_funcs = [fi for mod in self.pkg.modules.values()
                     for fi in mod.functions.values()]
        self.entry_held = {fi.key: set() for fi in all_funcs}
        for _ in range(4):  # bounded fixpoint (call chains here are shallow)
            sites: Dict[Tuple[str, str], List[Set[str]]] = {}
            for fi in all_funcs:
                for node, held in self.walk_held(fi):
                    if not isinstance(node, ast.Call):
                        continue
                    callee = self.resolve_method_call(fi, node)
                    if (callee is not None and
                            callee.qualname.rsplit(".", 1)[-1].startswith("_")):
                        sites.setdefault(callee.key, []).append(set(held))
            changed = False
            for key, heldsets in sites.items():
                inter = set.intersection(*heldsets)
                if self.entry_held.get(key) != inter:
                    self.entry_held[key] = inter
                    changed = True
            if not changed:
                break

    # -- order graph ------------------------------------------------------
    def _collect_edges(self) -> None:
        """acquired-while-holding edges: lexical nesting plus one level of
        resolvable calls (f holds A, calls g, g's body acquires B)."""
        for mod in self.pkg.modules.values():
            for fi in mod.functions.values():
                for node, held in self.walk_held(fi):
                    acquired: List[str] = []
                    if isinstance(node, ast.With):
                        for item in node.items:
                            lid = self.resolve_lock_expr(fi, item.context_expr)
                            if lid:
                                acquired.append(lid)
                    elif isinstance(node, ast.Call):
                        callee = self.resolve_method_call(fi, node)
                        if callee is not None:
                            acquired.extend(self._direct_acquires(callee))
                    for lid in acquired:
                        for h in held:
                            if h == lid:
                                continue  # reentrant same-lock nesting
                            self.edges.setdefault(
                                (h, lid),
                                (str(mod.path), getattr(node, "lineno",
                                                        fi.node.lineno)))


_MODEL_CACHE: Dict[int, LockModel] = {}


def build_model(pkg: PackageIndex) -> LockModel:
    """The shared lock model, built once per PackageIndex instance."""
    model = _MODEL_CACHE.get(id(pkg))
    if model is None or model.pkg is not pkg:
        model = LockModel(pkg)
        _MODEL_CACHE.clear()  # one live index at a time; no unbounded growth
        _MODEL_CACHE[id(pkg)] = model
    return model


def _finding(fi: FuncInfo, node: ast.AST, rule: str, msg: str, hint: str
             ) -> Finding:
    return Finding(str(fi.module.path),
                   getattr(node, "lineno", fi.node.lineno), rule, msg, hint)


def _short(lock_id: str) -> str:
    """mod.Class._attr -> Class._attr (message brevity)."""
    parts = lock_id.split(".")
    return ".".join(parts[-2:]) if len(parts) >= 2 else lock_id


# ---------------------------------------------------------------------------
# L1 — lock-order-inversion
# ---------------------------------------------------------------------------

@register_rule("L1", "lock-order-inversion", layer="locks")
def l1_lock_order_inversion(pkg: PackageIndex) -> Iterator[Finding]:
    """Cycle in the static acquired-while-holding graph: lock B is taken
    while holding A at one site and A while holding B at another — two
    threads interleaving those sites deadlock.  Edges come from lexical
    ``with`` nesting plus one level of resolvable calls.  Fix: pick one
    global order (document it next to the lock definitions) and re-nest
    the minority site; the runtime witness graph (utils/locktrace)
    enforces the same order dynamically."""
    model = build_model(pkg)
    adj: Dict[str, Set[str]] = {}
    for (a, b) in model.edges:
        adj.setdefault(a, set()).add(b)

    def reachable(src: str, dst: str) -> bool:
        seen, stack = set(), [src]
        while stack:
            cur = stack.pop()
            if cur == dst:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(adj.get(cur, ()))
        return False

    reported: Set[frozenset] = set()
    for (a, b), (path, line) in sorted(model.edges.items()):
        if not reachable(b, a):
            continue
        key = frozenset((a, b))
        if key in reported:
            continue
        reported.add(key)
        back = model.edges.get((b, a))
        via = (f"; reverse edge first seen at {back[0]}:{back[1]}"
               if back else " (via intermediate locks)")
        yield Finding(
            path, line, "L1",
            f"lock-order inversion: {_short(b)} acquired while holding "
            f"{_short(a)}, but the witness graph also orders "
            f"{_short(b)} before {_short(a)}{via}",
            "pick one global acquisition order and re-nest the minority "
            "site")


# ---------------------------------------------------------------------------
# L2 — blocking-call-under-lock
# ---------------------------------------------------------------------------

def _blocking_reason(fi: FuncInfo, node: ast.Call) -> Optional[str]:
    f = node.func
    # open(...)
    if isinstance(f, ast.Name) and f.id == "open":
        return "file I/O (open)"
    dotted = dotted_name(f)
    if dotted:
        for prefix, why in _BLOCKING_DOTTED_PREFIXES.items():
            if dotted == prefix.rstrip(".") or dotted.startswith(prefix):
                return why
        # np.asarray / np.array of a runtime value (shape-free heuristic:
        # any argument — the AST layer's R1 refines what is a device
        # value; under a lock ANY host materialization is suspect)
        parts = dotted.split(".")
        if (len(parts) == 2 and parts[0] in _NUMPY_ALIASES
                and parts[1] in _NP_SYNC_FUNCS):
            return "potential device sync (host materialization)"
    if isinstance(f, ast.Attribute):
        if f.attr in _BLOCKING_ATTR_CALLS:
            return _BLOCKING_ATTR_CALLS[f.attr]
        if f.attr == "sync_pull":
            return "accounted device sync (sync_pull)"
        if f.attr in ("write", "flush", "close", "tell"):
            recv = f.value
            recv_name = (recv.attr if isinstance(recv, ast.Attribute)
                         else recv.id if isinstance(recv, ast.Name) else "")
            if any(fragment in recv_name.lower()
                   for fragment in _FH_NAME_FRAGMENTS):
                return f"file I/O (.{f.attr} on {recv_name})"
        if f.attr == "join":
            # thread joins block indefinitely; string ".join" is filtered
            # by the receiver check (str literals/Names named *sep* etc.
            # rarely match the thread fragment)
            recv = f.value
            recv_name = (recv.attr if isinstance(recv, ast.Attribute)
                         else recv.id if isinstance(recv, ast.Name) else "")
            if "thread" in recv_name.lower() or recv_name in ("t", "worker"):
                return "thread join"
    # bare sync_pull (from-imported)
    if isinstance(f, ast.Name) and f.id == "sync_pull":
        return "accounted device sync (sync_pull)"
    return None


@register_rule("L2", "blocking-call-under-lock", layer="locks")
def l2_blocking_call_under_lock(pkg: PackageIndex) -> Iterator[Finding]:
    """A device sync (np.asarray / .item() / block_until_ready /
    sync_pull), file I/O, subprocess, socket, sleep or thread join runs
    with a lock held — every other thread contending on that lock stalls
    behind host-blocking work (device pulls under ``_pack_lock`` once
    stalled serving).  Fix: move the
    blocking work outside the critical section (snapshot under the lock,
    write after), or split the state lock from a dedicated IO leaf lock
    and pragma the leaf."""
    model = build_model(pkg)
    for mod in pkg.modules.values():
        for fi in mod.functions.values():
            for node, held in model.walk_held(fi):
                if not held or not isinstance(node, ast.Call):
                    continue
                why = _blocking_reason(fi, node)
                if why is None:
                    continue
                yield _finding(
                    fi, node, "L2",
                    f"{why} while holding {', '.join(_short(h) for h in held)}",
                    "hoist the blocking call out of the critical section "
                    "or split a dedicated IO leaf lock")


# ---------------------------------------------------------------------------
# L3 — unguarded-shared-mutation
# ---------------------------------------------------------------------------

def _mutations(model: LockModel, fi: FuncInfo
               ) -> Iterator[Tuple[ast.AST, str, Tuple[str, ...]]]:
    """(node, 'Class.attr' | 'mod:name', held) for every mutation of a
    self-attribute or module global in fi's own body."""
    cls = model._owning_class(fi)
    mod = fi.module

    def attr_of(t: ast.AST) -> Optional[str]:
        # self.x  => Class.x ; self.x[k] => Class.x ; global NAME[k]
        if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                and t.value.id == "self" and cls is not None):
            return f"{cls}.{t.attr}"
        if isinstance(t, ast.Subscript):
            return attr_of(t.value)
        if isinstance(t, ast.Name) and t.id in _module_globals(mod):
            return f"{mod.name}:{t.id}"
        return None

    for node, held in model.walk_held(fi):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                a = attr_of(t)
                if a:
                    yield (node, a, held)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                a = attr_of(t)
                if a:
                    yield (node, a, held)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr in _MUTATOR_METHODS):
            a = attr_of(node.func.value)
            if a:
                yield (node, a, held)


_GLOBALS_CACHE: Dict[str, Set[str]] = {}


def _module_globals(mod: ModuleInfo) -> Set[str]:
    """Names declared ``global`` inside any function of the module — the
    only module-level names whose in-function rebinding L3 considers
    (import-time assignments are single-threaded by definition)."""
    cached = _GLOBALS_CACHE.get(mod.name)
    if cached is not None:
        return cached
    out: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Global):
            out.update(node.names)
    _GLOBALS_CACHE[mod.name] = out
    return out


@register_rule("L3", "unguarded-shared-mutation", layer="locks")
def l3_unguarded_shared_mutation(pkg: PackageIndex) -> Iterator[Finding]:
    """Guard inference, the lock-discipline analogue of R16: when the
    mutation sites of an attribute (or declared-global) are MOSTLY under
    a lock, a site holding none of the guards races them.  Inference is
    majority-vote (RacerD-style): an attribute counts as lock-guarded
    only when at least half of its mutation sites hold a lock — a single
    incidental under-lock store among many bare trainer-path stores does
    not make the attribute "guarded".
    ``__init__``/``__new__``/``__setstate__`` bodies are construction-
    time (pre-publication) and exempt.  A site under a DIFFERENT lock
    than its siblings passes this rule (multi-lock designs exist); the
    runtime witness layer sees what the static union cannot."""
    model = build_model(pkg)
    _GLOBALS_CACHE.clear()
    sites: Dict[Tuple[str, str], List[MutationSite]] = {}
    for mod in pkg.modules.values():
        for fi in mod.functions.values():
            leaf = fi.qualname.rsplit(".", 1)[-1]
            ctor = leaf in ("__init__", "__new__", "__setstate__")
            for node, attr, held in _mutations(model, fi):
                if ctor:
                    continue
                sites.setdefault((mod.name, attr), []).append(
                    MutationSite(fi, node, attr, held))
    for (modname, attr), muts in sorted(sites.items()):
        guards: Set[str] = set()
        for m in muts:
            guards.update(m.held)
        if not guards:
            continue
        bare = [m for m in muts if not (set(m.held) & guards)]
        if not bare or len(bare) > len(muts) - len(bare):
            continue  # majority unguarded: the lock section is incidental
        for m in bare:
            guarded_eg = next(x for x in muts if x.held)
            yield _finding(
                m.fi, m.node, "L3",
                f"{attr.split('.')[-1]} mutated with no lock held, but "
                f"guarded by {_short(sorted(guards)[0])} at "
                f"{guarded_eg.fi.module.path.name}:"
                f"{getattr(guarded_eg.node, 'lineno', 0)}",
                "take the same lock here, or pragma with the reason the "
                "site cannot race (e.g. single-thread phase)")


# ---------------------------------------------------------------------------
# L4 — wait-without-predicate-loop
# ---------------------------------------------------------------------------

@register_rule("L4", "wait-without-predicate-loop", layer="locks")
def l4_wait_without_predicate_loop(pkg: PackageIndex) -> Iterator[Finding]:
    """``Condition.wait`` outside a ``while``: spurious wakeups and
    notify-before-wait races make a bare ``if``-guarded (or unguarded)
    wait return with the predicate still false.  Only receivers that
    resolve to a known Condition are checked (``queue.Queue`` internals
    etc. are out of scope); ``wait_for`` embeds its own loop and passes."""
    model = build_model(pkg)
    for mod in pkg.modules.values():
        for fi in mod.functions.values():
            cls = model._owning_class(fi)
            # condition attrs visible to this function
            cond_attrs = {
                attr for attr, lid in model.class_locks.get(
                    (mod.name, cls), {}).items()
                if model.locks[lid].kind == "condition"} if cls else set()
            cond_names = {
                name for name, lid in model.module_locks.get(
                    mod.name, {}).items()
                if model.locks[lid].kind == "condition"}
            if not cond_attrs and not cond_names:
                continue
            # statement -> enclosing-while map over fi's own body
            in_while: Set[ast.AST] = set()

            def mark(node: ast.AST, inside: bool) -> None:
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef, ast.Lambda)):
                        continue
                    now = inside or isinstance(child, ast.While)
                    if inside:
                        in_while.add(child)
                    mark(child, now)

            for stmt in fi.node.body:
                mark(stmt, isinstance(stmt, ast.While))
            for node in pkg._own_body_walk(fi):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "wait"):
                    continue
                recv = node.func.value
                is_cond = (
                    (isinstance(recv, ast.Attribute)
                     and isinstance(recv.value, ast.Name)
                     and recv.value.id == "self"
                     and recv.attr in cond_attrs)
                    or (isinstance(recv, ast.Name) and recv.id in cond_names))
                if not is_cond or node in in_while:
                    continue
                yield _finding(
                    fi, node, "L4",
                    "Condition.wait outside a while loop — a spurious "
                    "wakeup or a notify landing before the wait returns "
                    "with the predicate still false",
                    "use `while not pred: cv.wait(...)` or cv.wait_for")


# ---------------------------------------------------------------------------
# L5 — orphan-thread
# ---------------------------------------------------------------------------

def _thread_ctor_sites(fi: FuncInfo
                       ) -> Iterator[Tuple[ast.AST, Optional[str]]]:
    """(ctor call node, bound name) for `x = threading.Thread(...)` /
    `self._t = threading.Thread(...)` in fi's own body."""
    for node in _own_body_nodes(fi):
        if not isinstance(node, ast.Assign):
            continue
        v = node.value
        if not (isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute)
                and v.func.attr == "Thread"
                and isinstance(v.func.value, ast.Name)
                and v.func.value.id == "threading"):
            continue
        name = None
        t = node.targets[0]
        if isinstance(t, ast.Name):
            name = t.id
        elif (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
              and t.value.id == "self"):
            name = t.attr
        yield (v, name)


def _own_body_nodes(fi: FuncInfo) -> Iterator[ast.AST]:
    def rec(node: ast.AST) -> Iterator[ast.AST]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            yield child
            yield from rec(child)

    for stmt in fi.node.body:
        yield stmt
        yield from rec(stmt)


def _aliased_join(mod: ModuleInfo, name: str) -> bool:
    """The swap-join idiom: some function in the module binds a local
    from ``self.<name>`` (e.g. ``t, self._thread = self._thread, None``)
    and also calls ``.join(`` — the thread handle is joined through the
    alias, not the attribute."""
    for fi in mod.functions.values():
        reads_attr = False
        joins = False
        for node in _own_body_nodes(fi):
            if isinstance(node, ast.Assign):
                for sub in ast.walk(node.value):
                    if (isinstance(sub, ast.Attribute) and sub.attr == name
                            and isinstance(sub.value, ast.Name)
                            and sub.value.id == "self"):
                        reads_attr = True
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr == "join"):
                joins = True
        if reads_attr and joins:
            return True
    return False


@register_rule("L5", "orphan-thread", layer="locks")
def l5_orphan_thread(pkg: PackageIndex) -> Iterator[Finding]:
    """``threading.Thread`` constructed with no stop path visible in the
    module: the bound name (``self._thread`` / local ``t``) is never
    ``.join()``-ed anywhere in the module AND the constructing function
    wires no stop ``threading.Event`` (the ``Event`` + daemon +
    ``stop.set()`` generator idiom).  Orphan threads outlive tests,
    pin the interpreter at exit (non-daemon) or die mid-write (daemon),
    and are invisible to shutdown paths."""
    for mod in pkg.modules.values():
        src = "\n".join(mod.source_lines)
        for fi in mod.functions.values():
            for ctor, name in _thread_ctor_sites(fi):
                if name is not None and (f"{name}.join(" in src
                                         or f"{name}[0].join(" in src):
                    continue
                if name is not None and _aliased_join(mod, name):
                    continue
                # stop-Event pattern: the constructing function also
                # creates a threading.Event whose .set() appears in module
                has_event = False
                for node in _own_body_nodes(fi):
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and node.func.attr == "Event"
                            and isinstance(node.func.value, ast.Name)
                            and node.func.value.id == "threading"):
                        has_event = True
                        break
                if has_event and ".set()" in src:
                    continue
                yield _finding(
                    fi, ctor, "L5",
                    f"thread {name or '<unbound>'} started with no join() "
                    "or stop-Event path in this module",
                    "keep a handle and join() it in stop(), or wire a "
                    "stop Event the loop polls")
