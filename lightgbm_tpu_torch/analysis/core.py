"""jaxlint core for the port: package indexing, pragma handling, rule
registry.

Counterpart of lightgbm_tpu/analysis/core.py, copied but for the JAX
package's jit helpers (``is_jax_jit_expr``, ``jit_info_from_call`` and the
decorators' static and donated arguments), which give way to the port's
notion of a *hot function*.  The bug classes the AST shows are the torch
counterparts of the JAX package's: hidden host syncs in round loops,
a fresh CUDA-graph capture a call, side effects in a captured body (a
CUDA graph replays without running Python), axis-name drift between the
meshes and the collectives, and the rest of the catalogue in rules.py.

Architecture
------------
``PackageIndex`` parses every ``.py`` file under the given roots ONCE and
builds the shared facts rules need:

* per-module ASTs, source lines and ``# jaxlint: disable=`` pragmas,
* every function definition (module-level and nested),
* a package-local call graph (calls resolved through ``from .x import y``
  relative imports, module-level names and the enclosing functions'
  nested defs, so a closure's callee is found),
* the *round bodies*: a function passed as the body to
  ``RoundGraphs.run`` (``graphs.run(key, body)``, ops/graphs.py) or as
  the round function to ``round_runner`` (ops/treegrow_windowed.py); where
  a factory's call makes it (``round_body(round_fn, W)``), the factory and
  the functions handed to it,
* the *hot set*: the round bodies, everything reachable from them through
  the call graph, and their nested defs: the code a captured round runs,
* the *host round loops*: non-hot functions whose ``for``/``while`` loop calls
  ``graphs.run`` or a hot function, and the growers' round loops named in
  ``ROUND_LOOPS`` (their round function reaches them as a parameter, which
  the call graph cannot follow),
* declared mesh axis names (module-level ``NAME_AXIS = "literal"``).

Rules live in ``rules.py`` and ``locks.py`` and register themselves with
``@register_rule``; each receives the ``PackageIndex`` and yields
``Finding`` objects.  The runner applies pragma suppression afterwards so
suppressed findings can still be listed (``--show-suppressed``).

Pragma format (every exception must be documented)::

    x = t.cpu()  # jaxlint: disable=R1 (reason why this is intended)

The format keeps the JAX package's ``jaxlint`` word: the port's copies of
obs/ and serve/ must stay the JAX modules but for their names
(tests/test_torch_runtime.py::test_obs_modules_are_the_jax_ones_but_for_their_names),
pragmas included.  A pragma on a comment-only line suppresses the next
code line.  A pragma without a parenthesised reason, or naming an unknown
rule, is itself a finding (``P0``) and cannot be suppressed.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Set, Tuple

PRAGMA_RE = re.compile(
    r"#\s*jaxlint:\s*disable=(?P<rules>[A-Za-z0-9_,\s]+?)"
    r"(?:\s*\((?P<reason>.*)\))?\s*$"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer hit: location + rule + message + one-line fix hint."""

    file: str
    line: int
    rule: str
    message: str
    hint: str = ""

    def format(self) -> str:
        s = f"{self.file}:{self.line}: {self.rule} {self.message}"
        if self.hint:
            s += f"  | hint: {self.hint}"
        return s


@dataclasses.dataclass(frozen=True)
class Pragma:
    line: int  # line the pragma suppresses (resolved for comment-only lines)
    pragma_line: int  # line the pragma text sits on
    rules: Tuple[str, ...]
    reason: str


class FuncInfo:
    def __init__(self, module: "ModuleInfo", node: ast.FunctionDef,
                 qualname: str, parent: Optional["FuncInfo"]) -> None:
        self.module = module
        self.node = node
        self.qualname = qualname
        self.parent = parent
        self.params: Tuple[str, ...] = tuple(
            a.arg for a in (node.args.posonlyargs + node.args.args
                            + node.args.kwonlyargs))
        # resolved package-local callees: set of (modname, funcname)
        self.callees: Set[Tuple[str, str]] = set()
        # resolved callees invoked from inside a for/while loop
        self.loop_calls: Set[Tuple[str, str]] = set()
        # a for/while loop of its own body calls graphs.run
        self.loop_runs_graphs = False

    @property
    def key(self) -> Tuple[str, str]:
        return (self.module.name, self.qualname)


def has_cache_decorator(node: ast.FunctionDef) -> bool:
    """``functools.lru_cache`` / ``functools.cache`` (bare or called)."""
    for dec in node.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = target.attr if isinstance(target, ast.Attribute) else (
            target.id if isinstance(target, ast.Name) else "")
        if name in ("lru_cache", "cache"):
            return True
    return False


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` expression -> "a.b.c", else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class ModuleInfo:
    def __init__(self, path: Path, name: str, source: str) -> None:
        self.path = path
        self.name = name  # dotted name relative to the scan root
        self.is_package = path.name == "__init__.py"
        self.source_lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        self.pragmas: List[Pragma] = []
        self.bad_pragmas: List[Tuple[int, str]] = []  # (line, why)
        self.functions: Dict[str, FuncInfo] = {}
        # name visible at module level -> ("module", modname) for package
        # modules, or ("func", (modname, funcname)) for imported functions
        self.imports: Dict[str, Tuple[str, object]] = {}
        self.axis_constants: Dict[str, str] = {}  # NAME_AXIS -> "literal"
        self.str_constants: Dict[str, str] = {}  # any NAME -> "literal"
        self._collect_pragmas()
        self._collect_axis_constants()

    # -- pragmas ---------------------------------------------------------
    def _comment_lines(self) -> Set[int]:
        """Lines carrying a REAL comment token.  The pragma regex alone
        also matches pragma-shaped text inside string literals (the
        docstring examples in this very package) — those never suppressed
        anything, but the stale-pragma pass would flag them as retired.
        Tokenizing once keeps pragmas a comments-only construct."""
        import io
        import tokenize
        out: Set[int] = set()
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO("\n".join(self.source_lines)).readline):
                if tok.type == tokenize.COMMENT:
                    out.add(tok.start[0])
        except (tokenize.TokenError, IndentationError):
            # unterminated constructs: fall back to every line (regex-only
            # behavior) rather than silently dropping real pragmas
            return set(range(1, len(self.source_lines) + 1))
        return out

    def _collect_pragmas(self) -> None:
        comment_lines = self._comment_lines()
        for i, text in enumerate(self.source_lines, start=1):
            if i not in comment_lines:
                continue
            m = PRAGMA_RE.search(text)
            if not m:
                continue
            rules = tuple(r.strip() for r in m.group("rules").split(",")
                          if r.strip())
            reason = (m.group("reason") or "").strip()
            target = i
            if text.lstrip().startswith("#"):
                # comment-only pragma line: applies to the next CODE line
                # (skipping further comments and blank lines)
                j = i
                while j < len(self.source_lines) and (
                        not self.source_lines[j].strip()
                        or self.source_lines[j].lstrip().startswith("#")):
                    j += 1
                target = j + 1 if j < len(self.source_lines) else i
            if not reason:
                self.bad_pragmas.append(
                    (i, "pragma has no reason; write "
                        "`# jaxlint: disable=R<n> (<why>)`"))
                continue
            self.pragmas.append(Pragma(target, i, rules, reason))

    def _collect_axis_constants(self) -> None:
        for node in self.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                name = node.targets[0].id
                self.str_constants[name] = node.value.value
                if name.endswith("_AXIS"):
                    self.axis_constants[name] = node.value.value

    def suppressed(self, finding: Finding) -> Optional[Pragma]:
        for p in self.pragmas:
            if p.line == finding.line and (
                    finding.rule in p.rules or "ALL" in p.rules):
                return p
        return None


class PackageIndex:
    """Parsed view of every module under the scan roots."""

    def __init__(self, roots: Iterable[Path]) -> None:
        self.roots = [Path(r).resolve() for r in roots]
        self.modules: Dict[str, ModuleInfo] = {}
        self.errors: List[Finding] = []
        for root in self.roots:
            for path in self._iter_py(root):
                name = self._module_name(root, path)
                try:
                    src = path.read_text()
                    self.modules[name] = ModuleInfo(path, name, src)
                except (SyntaxError, UnicodeDecodeError) as e:
                    self.errors.append(Finding(
                        str(path), getattr(e, "lineno", 1) or 1, "E0",
                        f"failed to parse: {e}",
                        "fix the syntax error; jaxlint needs a valid AST"))
        self._index_functions()
        self._resolve_imports()
        self._build_call_graph()
        self.hot: Set[Tuple[str, str]] = self._compute_hot_set()
        self.axis_names: Set[str] = set()
        for mod in self.modules.values():
            self.axis_names.update(mod.axis_constants.values())

    # -- discovery -------------------------------------------------------
    @staticmethod
    def _iter_py(root: Path) -> Iterator[Path]:
        if root.is_file():
            yield root
            return
        for p in sorted(root.rglob("*.py")):
            yield p

    @staticmethod
    def _module_name(root: Path, path: Path) -> str:
        if root.is_file():
            return path.stem
        rel = path.relative_to(root).with_suffix("")
        parts = [root.name] + list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    # -- function index --------------------------------------------------
    def _index_functions(self) -> None:
        for mod in self.modules.values():
            def visit(body, prefix: str, parent: Optional[FuncInfo]) -> None:
                for node in body:
                    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        qual = f"{prefix}{node.name}"
                        fi = FuncInfo(mod, node, qual, parent)
                        mod.functions[qual] = fi
                        visit(node.body, qual + ".", fi)
                    elif isinstance(node, ast.ClassDef):
                        visit(node.body, f"{prefix}{node.name}.", parent)
                    elif parent is not None:
                        # a def inside a with/try/if/loop block of a
                        # function is still that function's nested def
                        # (the growers define their round functions under
                        # a `with` counter)
                        for field in ("body", "orelse", "finalbody",
                                      "handlers"):
                            sub = getattr(node, field, None)
                            if isinstance(sub, list):
                                visit(sub, prefix, parent)
                        for h in getattr(node, "handlers", []) or []:
                            visit(h.body, prefix, parent)

            visit(mod.tree.body, "", None)

    # -- imports ---------------------------------------------------------
    def _resolve_imports(self) -> None:
        for mod in self.modules.values():
            # containing package: a package module (__init__.py) IS its own
            # package — its name already lost the __init__ segment, so
            # stripping another level would resolve relative imports one
            # package too high
            pkg_parts = mod.name.split(".")
            if not mod.is_package:
                pkg_parts = pkg_parts[:-1]
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ImportFrom) and node.level > 0:
                    base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                    target = ".".join(base + (node.module or "").split("."))
                    target = target.rstrip(".")
                    for alias in node.names:
                        local = alias.asname or alias.name
                        sub = f"{target}.{alias.name}"
                        # `from ..ops import predict` imports the SUBMODULE
                        # predict, not a function — check that first (the
                        # parent package's __init__ is always indexed, so
                        # "target in modules" alone cannot discriminate)
                        if sub in self.modules:
                            mod.imports[local] = ("module", sub)
                        elif target in self.modules:
                            mod.imports[local] = ("func", (target, alias.name))

    def _resolve_export(self, modname: str, funcname: str,
                        _seen: Optional[Set[Tuple[str, str]]] = None
                        ) -> Optional[Tuple[str, str]]:
        """Find the defining module of `modname.funcname`, following
        re-export chains (`__init__.py` doing `from .impl import f`)."""
        mod = self.modules.get(modname)
        if mod is None:
            return None
        if funcname in mod.functions:
            return (modname, funcname)
        imp = mod.imports.get(funcname)
        if imp and imp[0] == "func":
            key = (modname, funcname)
            _seen = _seen or set()
            if key in _seen:
                return None
            _seen.add(key)
            return self._resolve_export(imp[1][0], imp[1][1], _seen)
        return None

    def resolve_call(self, mod: ModuleInfo, func_expr: ast.AST,
                     fi: Optional[FuncInfo] = None
                     ) -> Optional[Tuple[str, str]]:
        """Resolve a call's target to a (modname, funcname) in the package.
        With ``fi`` (the calling function) a bare name is looked up in the
        enclosing functions' nested defs first (a closure's callee)."""
        if isinstance(func_expr, ast.Name):
            name = func_expr.id
            cur = fi
            while cur is not None:
                qual = f"{cur.qualname}.{name}"
                if qual in mod.functions:
                    return (mod.name, qual)
                cur = cur.parent
            if name in mod.functions:
                return (mod.name, name)
            imp = mod.imports.get(name)
            if imp and imp[0] == "func":
                return self._resolve_export(imp[1][0], imp[1][1])
        elif isinstance(func_expr, ast.Attribute) and isinstance(
                func_expr.value, ast.Name):
            imp = mod.imports.get(func_expr.value.id)
            if imp and imp[0] == "module":
                return self._resolve_export(imp[1], func_expr.attr)
        return None

    def lookup(self, key: Tuple[str, str]) -> Optional[FuncInfo]:
        mod = self.modules.get(key[0])
        return mod.functions.get(key[1]) if mod else None

    # -- call graph ------------------------------------------------------
    def _build_call_graph(self) -> None:
        self.round_bodies: Set[Tuple[str, str]] = set()
        for mod in self.modules.values():
            for fi in mod.functions.values():
                # direct statements only (nested defs carry their own edges)
                own_nodes = self._own_body_walk(fi)
                loop_nodes = self._loop_body_walk(fi)
                for node in own_nodes:
                    if not isinstance(node, ast.Call):
                        continue
                    target = self.resolve_call(mod, node.func, fi)
                    if target is not None:
                        fi.callees.add(target)
                        if node in loop_nodes:
                            fi.loop_calls.add(target)
                    if is_graphs_run(node):
                        if node in loop_nodes:
                            fi.loop_runs_graphs = True
                        body = node.args[1] if len(node.args) > 1 else None
                    elif (dotted_name(node.func) or "").split(".")[-1] == \
                            "round_runner":
                        body = node.args[0] if node.args else None
                    else:
                        continue
                    # a factory call makes the body: the factory and the
                    # functions handed to it (round_body(round_fn, W))
                    cands = ([body.func] + list(body.args)
                             if isinstance(body, ast.Call) else [body])
                    for c in cands:
                        key = (self.resolve_call(mod, c, fi)
                               if isinstance(c, (ast.Name, ast.Attribute))
                               else None)
                        if key is not None:
                            self.round_bodies.add(key)

    @staticmethod
    def _own_body_walk(fi: FuncInfo) -> List[ast.AST]:
        """All nodes in fi's body EXCLUDING nested function bodies."""
        out: List[ast.AST] = []

        def rec(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue
                out.append(child)
                rec(child)

        for stmt in fi.node.body:  # body only: decorators are not "inside"
            out.append(stmt)
            rec(stmt)
        return out

    @staticmethod
    def _loop_body_walk(fi: FuncInfo) -> Set[ast.AST]:
        """Nodes inside a for/while in fi's own body (no nested defs)."""
        out: Set[ast.AST] = set()

        def rec(node: ast.AST, in_loop: bool) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue
                child_in_loop = in_loop or isinstance(
                    child, (ast.For, ast.While))
                if in_loop:
                    out.add(child)
                rec(child, child_in_loop)

        for stmt in fi.node.body:
            rec(stmt, isinstance(stmt, (ast.For, ast.While)))
        return out

    # -- hot set ---------------------------------------------------------
    def _compute_hot_set(self) -> Set[Tuple[str, str]]:
        """The round bodies plus everything reachable from them, nested
        defs included."""
        children: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
        for mod in self.modules.values():
            for fi in mod.functions.values():
                if fi.parent is not None:
                    children.setdefault(fi.parent.key, []).append(fi.key)
        hot: Set[Tuple[str, str]] = set(self.round_bodies)
        stack: List[Tuple[str, str]] = list(hot)
        while stack:
            key = stack.pop()
            fi = self.lookup(key)
            if fi is None:
                continue
            for target in list(fi.callees) + children.get(key, []):
                if target not in hot:
                    hot.add(target)
                    stack.append(target)
        return hot

    def is_hot(self, fi: FuncInfo) -> bool:
        """In a captured round: a round body, reachable from one, or
        nested in one."""
        cur: Optional[FuncInfo] = fi
        while cur is not None:
            if cur.key in self.hot:
                return True
            cur = cur.parent
        return False

    def is_round_loop(self, fi: FuncInfo) -> bool:
        """A host round loop: a loop of its own body launches a round
        (graphs.run or a hot function), or it is one of ROUND_LOOPS."""
        if self.is_hot(fi):
            return False
        if fi.loop_runs_graphs or any(t in self.hot for t in fi.loop_calls):
            return True
        return any(fi.module.name.endswith(m) and fi.qualname == q
                   for m, q in ROUND_LOOPS)


# the growers' round loops, whose round function arrives as a parameter
# (or is the loop body itself): the strict grower's steps, the windowed
# and rounds growers' shared round protocol, the spill grower's splits
ROUND_LOOPS = (
    ("ops.treegrow", "_grow"),
    ("ops.treegrow_windowed", "_run_fused_rounds"),
    ("ops.treegrow_ooc", "_grow"),
)


def is_graphs_run(node: ast.Call) -> bool:
    """``graphs.run(...)`` / ``self._graphs.run(...)``: a RoundGraphs
    replay (the receiver's name ends in "graphs")."""
    fn = dotted_name(node.func) or ""
    parts = fn.split(".")
    return (len(parts) >= 2 and parts[-1] == "run"
            and parts[-2].lower().endswith("graphs"))


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------

RuleFn = Callable[[PackageIndex], Iterable[Finding]]


@dataclasses.dataclass(frozen=True)
class Rule:
    rule_id: str
    name: str
    fn: RuleFn
    doc: str
    # which analysis layer the rule belongs to: "ast" (the R-rules),
    # "locks" (the concurrency layer L-rules) or "scoped" (an R-rule with
    # no torch meaning, registered so its ID stays known; it finds
    # nothing).  The CLI's --locks flag selects by layer; a plain run
    # executes every registered rule regardless of layer.
    layer: str = "ast"


RULES: Dict[str, Rule] = {}


def register_rule(rule_id: str, name: str,
                  layer: str = "ast") -> Callable[[RuleFn], RuleFn]:
    def deco(fn: RuleFn) -> RuleFn:
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id}")
        RULES[rule_id] = Rule(rule_id, name, fn, (fn.__doc__ or "").strip(),
                              layer)
        return fn

    return deco


@dataclasses.dataclass
class Report:
    findings: List[Finding]
    suppressed: List[Tuple[Finding, Pragma]]
    # pragmas whose line no longer triggers a rule they name: each entry is
    # a ready-to-print Finding (rule "P1") pointing at the pragma line.
    # Default-on WARNING (the CLI prints them to stderr); --strict-pragmas
    # promotes them into `findings` so retired suppressions cannot
    # accumulate silently.
    stale: List[Finding] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings


def run(roots: Iterable[Path], rule_ids: Optional[Iterable[str]] = None,
        strict_pragmas: bool = False) -> Report:
    """Run the selected rules over the roots; apply pragma suppression.

    ``strict_pragmas`` promotes stale-pragma findings (P1: a
    ``disable=Rn`` whose line no longer triggers rule Rn) from warnings
    into real findings.  Staleness is only judged for rules that were
    actually selected this run — a subset run cannot conclude anything
    about an unselected rule's pragmas."""
    from . import rules as _rules  # noqa: F401  (registers built-in rules)
    from . import locks as _locks  # noqa: F401  (registers L1-L5)

    pkg = PackageIndex(roots)
    selected = sorted(rule_ids) if rule_ids else sorted(RULES)
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise ValueError(f"unknown rule ids: {unknown} (have {sorted(RULES)})")

    raw: List[Finding] = list(pkg.errors)
    for rid in selected:
        raw.extend(RULES[rid].fn(pkg))

    # pragma validation: unknown rule names and missing reasons are findings
    for mod in pkg.modules.values():
        for line, why in mod.bad_pragmas:
            raw.append(Finding(str(mod.path), line, "P0", why,
                               "document every suppression with a reason"))
        for p in mod.pragmas:
            for rid in p.rules:
                if rid != "ALL" and rid not in RULES:
                    raw.append(Finding(
                        str(mod.path), p.pragma_line, "P0",
                        f"pragma names unknown rule {rid!r}",
                        f"known rules: {', '.join(sorted(RULES))}"))

    path_to_mod = {str(m.path): m for m in pkg.modules.values()}
    findings: List[Finding] = []
    suppressed: List[Tuple[Finding, Pragma]] = []
    for f in raw:
        mod = path_to_mod.get(f.file)
        p = mod.suppressed(f) if (mod and f.rule != "P0") else None
        if p is not None:
            suppressed.append((f, p))
        else:
            findings.append(f)

    # stale-pragma detection: a suppression whose target line no longer
    # triggers the rule it names.  Judged against the RAW findings (before
    # suppression), per named rule, only for rules selected this run.
    triggered = {(f.file, f.line, f.rule) for f in raw}
    triggered_lines = {(f.file, f.line) for f in raw}
    sel = set(selected)
    stale: List[Finding] = []
    for mod in pkg.modules.values():
        for p in mod.pragmas:
            for rid in p.rules:
                if rid == "ALL":
                    if (sel == set(RULES)
                            and (str(mod.path), p.line) not in triggered_lines):
                        stale.append(Finding(
                            str(mod.path), p.pragma_line, "P1",
                            "stale pragma: disable=ALL but line "
                            f"{p.line} triggers no rule at all",
                            "delete the retired suppression"))
                elif rid in RULES and rid in sel and (
                        str(mod.path), p.line, rid) not in triggered:
                    stale.append(Finding(
                        str(mod.path), p.pragma_line, "P1",
                        f"stale pragma: disable={rid} but line {p.line} "
                        f"no longer triggers {rid}",
                        "delete the retired suppression (reason: "
                        f"{p.reason!r})"))
    stale.sort(key=lambda f: (f.file, f.line))
    if strict_pragmas:
        findings.extend(stale)

    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return Report(findings=findings, suppressed=suppressed, stale=stale)
