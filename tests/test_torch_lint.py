"""Tier-1 gate of the port's analyzer (as tests/test_jaxlint_gate.py gates
the JAX package): the AST rules R1-R21 and the lock rules L1-L5 over the
whole of lightgbm_tpu_torch/ report ZERO unsuppressed findings, every
suppression carries a reason, no pragma is stale, and every rule ID of
the JAX package's catalogue is registered (R3 and R11 as scoped out)."""

import functools
from pathlib import Path

import lightgbm_tpu_torch
from lightgbm_tpu_torch.analysis import RULES, run
from lightgbm_tpu_torch.analysis.__main__ import main as lint_main

PKG_DIR = Path(lightgbm_tpu_torch.__file__).resolve().parent
ALL_IDS = {f"R{i}" for i in range(1, 22)} | {f"L{i}" for i in range(1, 6)}


@functools.lru_cache(maxsize=2)
def _package_report(strict_pragmas=False):
    # the source tree cannot change mid-session: one Report a pragma mode
    return run([PKG_DIR], strict_pragmas=strict_pragmas)


def test_package_has_zero_unsuppressed_findings():
    report = _package_report()
    assert report.ok, "new findings (fix or pragma with a reason):\n" \
        + "\n".join(f.format() for f in report.findings)


def test_every_suppression_carries_a_reason():
    report = _package_report()
    assert report.suppressed
    for finding, pragma in report.suppressed:
        assert pragma.reason.strip(), f"reasonless pragma hides {finding.format()}"


def test_package_has_zero_stale_pragmas():
    report = _package_report(strict_pragmas=True)
    stale = [f for f in report.findings if f.rule == "P1"]
    assert not stale, "stale pragmas (delete the retired suppressions):\n" \
        + "\n".join(f.format() for f in stale)
    assert report.ok


def test_all_rules_are_registered_and_r3_r11_scoped_out():
    assert ALL_IDS <= set(RULES)
    scoped = {rid for rid, r in RULES.items() if r.layer == "scoped"}
    assert scoped == {"R3", "R11"}
    for rid in scoped:
        assert "Scoped out" in RULES[rid].doc
    assert {rid for rid, r in RULES.items() if r.layer == "locks"} == {
        f"L{i}" for i in range(1, 6)}


def test_the_reasoned_suppressions_the_port_needs():
    """The sites this gate's findings were repaired at: the L3 pair at the
    model list's version-bump protocol (the JAX package's pragma at the
    same protocol), the g++ build's L2 pair, the C++ source write (R12),
    the strict grower's sharded go-left psum (R13, C17/A27)."""
    report = _package_report()
    got = {(Path(f.file).name, f.rule) for f, _ in report.suppressed}
    assert {("gbdt.py", "L3"), ("native.py", "L2"), ("cli.py", "R12"),
            ("treegrow.py", "R13")} <= got
    r13 = [p.reason for f, p in report.suppressed if f.rule == "R13"]
    assert r13 and all("C17/A27" in r for r in r13)


def test_cli_exit_codes(capsys):
    assert lint_main([str(PKG_DIR), "--strict-pragmas"]) == 0
    assert lint_main(["--list-rules"]) == 0
    assert "scoped out" in capsys.readouterr().out
    assert lint_main(["/no/such/path"]) == 2
    assert lint_main([str(PKG_DIR), "--rules", "R99"]) == 2
    assert lint_main(["--locks", "--rules", "R1"]) == 2
    assert lint_main(["--trace", str(PKG_DIR)]) == 2


def test_cli_flags_a_dirty_tree(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "def round_runner(fn, *a):\n    return fn\n\n"
        "def grow(state):\n"
        "    def round_fn(st, inp, W):\n        return st.sum().item()\n"
        "    return round_runner(round_fn, state)\n")
    assert lint_main([str(bad)]) == 1
    assert lint_main([str(bad), "--rules", "R12"]) == 0
