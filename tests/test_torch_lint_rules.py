"""Rule self-tests of the port's analyzer: one positive and one negative
fixture per rule (R1-R21, L1-L5), each finding reported under its own ID,
pragma handling, the two scoped-out rules, and the parity case: where a
rule's meaning is the JAX package's (L1-L5, R12, R16, R18, R19, R21), the
port's analyzer and lightgbm_tpu/analysis (its AST layer, which imports no
JAX) give the same (file, line, rule) findings on the same sources."""

import textwrap
from pathlib import Path

import pytest

from lightgbm_tpu_torch.analysis import run

# a captured round body: round_runner's round function is hot
_HOT = """
    import math
    import random
    import time
    import numpy as np
    import torch

    def round_runner(fn, state):
        return fn

    def grow(state):
        def round_fn(st, inp, W):
            {body}
            return st
        return round_runner(round_fn, state)
"""

# a host round loop: a loop that replays a captured round (graphs.run)
_ROUND_LOOP = """
    import math
    import numpy as np
    import torch
    from . import collectives as C

    def drive(graphs, x, mesh, n):
        for i in range(n):
            graphs.run(("k",), body)
            {body}
        return x

    def body(b):
        return b
"""

_MESH = """
    DATA_AXIS = "data"
    FEATURE_AXIS = "feature"
    DCN_AXIS = "dcn"
"""


def _hot(body):
    return {"mod.py": _HOT.format(body=body)}


def _round_loop(body):
    return {"mod.py": _ROUND_LOOP.format(body=body), "collectives.py": "def psum(x, m):\n"
            "    return x\n"}


# rule -> (positive sources, negative sources, findings of the positive)
CASES = {
    "R1": (_hot("n = st.sum().item(); torch.cuda.synchronize(); "
                "idx = torch.nonzero(st); v = float(st.max())"),
           _hot("k = int(W); n = st.shape[0]; idx = torch.nonzero_static(st, size=4)"),
           4),
    "R2": ({"mod.py": """
            import torch

            def capture_each_call(body):
                g = torch.cuda.CUDAGraph()
                return g
        """},
           {"mod.py": """
            import functools
            import torch

            class Cache:
                def __init__(self):
                    self.graph = torch.cuda.CUDAGraph()

            @functools.lru_cache(maxsize=None)
            def cached():
                return torch.cuda.CUDAGraph()
        """}, 1),
    "R4": ({"mesh.py": _MESH, "mod.py": """
            from .mesh import DATA_AXIS

            def build(group, grid):
                m = Mesh(group, "rows")
                return grid.axes["feat"], m
        """},
           {"mesh.py": _MESH, "mod.py": """
            from .mesh import DATA_AXIS, FEATURE_AXIS

            def build(group, grid, axis):
                m = Mesh(group, DATA_AXIS)
                return grid.axes[FEATURE_AXIS], Mesh(group, axis), m
        """}, 2),
    "R5": (_hot("t = time.perf_counter(); r = random.random(); "
                "u = np.random.rand(3)\n            global _TOTAL"),
           {"mod.py": """
            import random
            import time

            def host_setup():
                global _SEED
                return time.perf_counter(), random.random()
        """}, 4),
    "R6": ({"mod.py": """
            def drive(graphs, n):
                for _ in range(n):
                    graphs.run(("a",), phase_a)
                    graphs.run(("b",), phase_b)

            def phase_a(b):
                return b

            def phase_b(b):
                return b
        """},
           {"mod.py": """
            from .san import sync_pull

            def drive(graphs, info, n):
                for _ in range(n):
                    graphs.run(("a",), phase_a)
                    k = sync_pull(info)
                    graphs.run(("b",), phase_b)

            def phase_a(b):
                return b

            def phase_b(b):
                return b
        """}, 1),
    "R7": (_round_loop("if torch.isnan(x).any():\n                break\n"
                   "            bad = math.isnan(x[0])"),
           {"mod.py": """
            import math
            import torch

            def check(x):
                if torch.isnan(x).any():
                    raise ValueError
                return math.isnan(float(x[0]))
        """}, 2),
    "R8": ({"mod.py": """
            def serve(gbdt, X, n):
                for _ in range(n):
                    active = X[:, 0] > 0
                    out = predict_raw(X[active])
                return out
        """},
           {"mod.py": """
            def serve(gbdt, X, n):
                for _ in range(n):
                    active = X[:, 0] > 0
                    out = predict_raw(X, active=active)
                return out
        """}, 1),
    "R9": ({"mod.py": """
            import time

            def bench(bins, g, h):
                t0 = time.perf_counter()
                histogram_multi(bins, g, h)
                return time.perf_counter() - t0
        """},
           {"mod.py": """
            import time
            import torch

            def bench(bins, g, h):
                t0 = time.perf_counter()
                histogram_multi(bins, g, h)
                torch.cuda.synchronize()
                return time.perf_counter() - t0
        """}, 1),
    "R10": ({"mod.py": """
            class Span:
                def __exit__(self, *exc):
                    self.elapsed = self.value.item()
                    return False
        """},
            {"mod.py": """
            from .san import sync_pull

            class Span:
                def __exit__(self, *exc):
                    self.elapsed = sync_pull(self.value)
                    return False
        """}, 1),
    "R12": ({"mod.py": """
            def save(model_path, text):
                with open(model_path, "w") as fh:
                    fh.write(text)
        """},
            {"mod.py": """
            def log(log_path, text):
                with open(log_path, "w") as fh:
                    fh.write(text)
        """}, 1),
    "R13": (_round_loop("y = C.psum(x, mesh)"),
            {"mod.py": """
            from . import collectives as C

            def round_runner(fn, state):
                return fn

            def grow(state, mesh):
                def round_fn(st, inp, W):
                    return C.psum(st, mesh)
                return round_runner(round_fn, state)
        """, "collectives.py": "def psum(x, m):\n    return x\n"}, 1),
    "R14": ({"mod.py": """
            import numpy as np

            def meta(x, t):
                return np.asarray(x).shape, t.cpu().shape, len(t.tolist())
        """},
            {"mod.py": """
            import numpy as np

            def meta(x, t):
                return np.shape(x), t.shape, len(t)
        """}, 3),
    "R15": ({"mod.py": """
            import numpy as np
            import torch

            def serve_loop(q, gbdt):
                while True:
                    req = q.get()
                    buf = np.zeros((req.n, 8), np.float32)
                    pin = torch.empty((req.n, 8), pin_memory=True)
                    gbdt.predict(buf, pin)
        """},
            {"mod.py": """
            import numpy as np
            import torch

            def serve_loop(q, gbdt):
                buf = np.zeros((1024, 8), np.float32)
                pin = torch.empty((1024, 8), pin_memory=True)
                while True:
                    req = q.get()
                    gbdt.predict(buf, pin)
        """}, 2),
    "R16": ({"serve/mod.py": """
            def add_tree(gbdt, tree):
                gbdt.models.append(tree)
        """},
            {"serve/mod.py": """
            def add_tree(gbdt, tree):
                gbdt.models.append(tree)
                gbdt._invalidate_pred_cache("add")
        """}, 1),
    "R17": ({"mod.py": """
            from . import collectives as C

            def merge(hist, sharding):
                return C.psum(hist, sharding.dcn_mesh)
        """},
            {"mod.py": """
            from . import collectives as C

            def merge(hist, sharding, idx):
                top_hist = take_along_axis(hist, idx)
                return C.psum(hist, sharding.ici_mesh), C.psum(top_hist, sharding.dcn_mesh)
        """}, 1),
    "R18": ({"mod.py": """
            def train_all(boosters):
                for b in boosters:
                    b.train_one_iter()
        """},
            {"mod.py": """
            def warm_chain(params, data, n):
                bst = None
                for i in range(n):
                    bst = train(params, data, init_model=bst)
                return bst
        """}, 1),
    "R19": ({"mod.py": """
            def pump(sock, msg):
                while True:
                    try:
                        sock.send(msg)
                    except Exception:
                        pass
        """},
            {"mod.py": """
            import time

            def pump(sock, msg):
                while True:
                    try:
                        sock.send(msg)
                    except Exception:
                        time.sleep(0.1)
        """}, 1),
    "R20": ({"mod.py": """
            from . import collectives as C

            def merge(hist, sharding):
                return C.psum(hist, sharding.feature_mesh)
        """},
            {"mod.py": """
            from . import collectives as C

            def decide(go_left, hist, sharding):
                return C.psum(go_left, sharding.feature_mesh), C.psum(hist, sharding.mesh)
        """}, 1),
    "R21": ({"serve/mod.py": """
            import threading

            def start(self):
                self._t = threading.Thread(target=self._loop)

            def stop(self):
                self._t.join()

            def _loop(self):
                with span("dispatch"):
                    pass
        """},
            {"serve/mod.py": """
            import threading

            def start(self):
                self._t = threading.Thread(target=self._loop)

            def stop(self):
                self._t.join()

            def _loop(self, ctx=None):
                with span("dispatch", parent=ctx):
                    pass
        """}, 1),
    "L1": ({"mod.py": """
            import threading

            _a = threading.Lock()
            _b = threading.Lock()

            def f():
                with _a:
                    with _b:
                        pass

            def g():
                with _b:
                    with _a:
                        pass
        """},
           {"mod.py": """
            import threading

            _a = threading.Lock()
            _b = threading.Lock()

            def f():
                with _a:
                    with _b:
                        pass

            def g():
                with _a:
                    with _b:
                        pass
        """}, 1),
    "L2": ({"mod.py": """
            import threading

            _lock = threading.Lock()

            def dump(payload):
                with _lock:
                    with open("/tmp/x", "w") as fh:
                        fh.write(payload)
        """},
           {"mod.py": """
            import threading

            _lock = threading.Lock()

            def dump(payload):
                with _lock:
                    text = str(payload)
                with open("/tmp/x", "w") as fh:
                    fh.write(text)
        """}, 2),
    "L3": ({"mod.py": """
            import threading

            class C:
                def __init__(self):
                    self._lk = threading.Lock()
                    self.n = 0

                def inc(self):
                    with self._lk:
                        self.n += 1

                def inc2(self):
                    with self._lk:
                        self.n += 2

                def racy(self):
                    self.n = 0
        """},
           {"mod.py": """
            import threading

            class C:
                def __init__(self):
                    self._lk = threading.Lock()
                    self.n = 0

                def inc(self):
                    with self._lk:
                        self.n += 1

                def reset(self):
                    with self._lk:
                        self.n = 0
        """}, 1),
    "L4": ({"mod.py": """
            import threading

            class C:
                def __init__(self):
                    self._cv = threading.Condition()
                    self.ready = False

                def block(self):
                    with self._cv:
                        self._cv.wait()
        """},
           {"mod.py": """
            import threading

            class C:
                def __init__(self):
                    self._cv = threading.Condition()
                    self.ready = False

                def block(self):
                    with self._cv:
                        while not self.ready:
                            self._cv.wait()
        """}, 1),
    "L5": ({"mod.py": """
            import threading

            def fire_and_forget(fn):
                t = threading.Thread(target=fn)
                t.start()
        """},
           {"mod.py": """
            import threading

            def run_and_wait(fn):
                t = threading.Thread(target=fn)
                t.start()
                t.join()
        """}, 1),
}

# rules whose meaning is the JAX package's, checked against its analyzer
PARITY = ("L1", "L2", "L3", "L4", "L5", "R12", "R16", "R18", "R19", "R21")


def _write(root: Path, sources: dict) -> Path:
    for name, code in sources.items():
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(code))
    for d in [root] + [p for p in root.rglob("*") if p.is_dir()]:
        (d / "__init__.py").touch()
    return root


def _scan(tmp_path, sources, rules=None, name="fixture_pkg"):
    root = _write(tmp_path / name, sources)
    return run([root], rules)


@pytest.mark.parametrize("rule", sorted(CASES, key=lambda r: (r[0], int(r[1:]))))
@pytest.mark.parametrize("side", ["positive", "negative"])
def test_rule_fixture(tmp_path, rule, side):
    pos, neg, n = CASES[rule]
    rep = _scan(tmp_path, pos if side == "positive" else neg, [rule])
    if side == "positive":
        assert len(rep.findings) == n, [f.format() for f in rep.findings]
        assert {f.rule for f in rep.findings} == {rule}
    else:
        assert not rep.findings, [f.format() for f in rep.findings]
    # the fixture fails under its own ID alone: no other rule fires on it
    others = _scan(tmp_path, pos, None, name="all_rules").findings
    assert {f.rule for f in others} == {rule}, [f.format() for f in others]


def test_every_rule_with_a_torch_meaning_has_a_fixture():
    from lightgbm_tpu_torch.analysis import RULES
    assert set(CASES) == {r for r, v in RULES.items() if v.layer != "scoped"}


@pytest.mark.parametrize("rule", ["R3", "R11"])
def test_scoped_out_rules_find_nothing_and_their_pragmas_are_stale(tmp_path, rule):
    rep = _scan(tmp_path, {"mod.py": f"""
        import jax

        def f(x):
            y = x + 1  # jaxlint: disable={rule} (no torch meaning)
            return y
    """}, [rule])
    assert not rep.findings
    strict = run([tmp_path / "fixture_pkg"], [rule], strict_pragmas=True)
    assert [f.rule for f in strict.findings] == ["P1"]


def test_pragma_with_reason_suppresses_and_without_reason_is_p0(tmp_path):
    src = _HOT.format(body="n = st.sum().item()  # jaxlint: disable=R1 (the one read)")
    rep = _scan(tmp_path, {"mod.py": src}, ["R1"])
    assert rep.ok and len(rep.suppressed) == 1
    bad = _HOT.format(body="n = st.sum().item()  # jaxlint: disable=R1")
    rep = _scan(tmp_path, {"mod.py": bad}, ["R1"], name="bad")
    assert sorted(f.rule for f in rep.findings) == ["P0", "R1"]


def test_a_captured_bodys_callees_are_hot_and_nested_defs_indexed(tmp_path):
    """The hot set follows graphs.run's body, a factory's closure and the
    round function handed to round_body, defs nested under a ``with``."""
    rep = _scan(tmp_path, {"mod.py": """
        def round_body(fn, W):
            def body(b):
                fn(b, W)
            return body

        def grow(graphs, counter):
            with counter:
                def round_fn(b, W):
                    return helper(b)
            graphs.run(("k",), round_body(round_fn, 8))

        def helper(b):
            return b.cpu()
    """}, ["R1"])
    assert [f.line for f in rep.findings] == [14]


@pytest.mark.parametrize("rule", PARITY)
def test_parity_with_the_jax_analyzer(tmp_path, rule):
    """The same fixture sources through both analyzers give the same
    (file, line, rule) findings, positive and negative."""
    from lightgbm_tpu.analysis import run as jax_run

    for i, sources in enumerate(CASES[rule][:2]):
        root = _write(tmp_path / f"p{i}", sources)
        ours = {(Path(f.file).relative_to(root).as_posix(), f.line, f.rule)
                for f in run([root], [rule]).findings}
        theirs = {(Path(f.file).relative_to(root).as_posix(), f.line, f.rule)
                  for f in jax_run([root], [rule]).findings}
        assert ours == theirs, (ours, theirs)
        assert bool(ours) == (i == 0)
