"""The port's trace audit (lightgbm_tpu_torch/analysis/trace_audit.py),
the counterpart of tests/test_jaxpr_audit.py: the nineteen contracts of
the JAX package under the same names, every one clean on the CPU (the
sharded ones on 4 gloo ranks, one launch for all of them), the structural
pins the JAX tests hold (one merge a sharded round, the 2-D histogram
phase off the feature axis, collective-free single-device bodies, the
megakernel's one sweep against the three-pass round's, the sharded
megakernel's protocol, the hierarchical ici sequence, the dcn bill, the
ledger), and one negative fixture per J rule, each failing under its own
ID."""

import dataclasses
import time

import pytest
import torch

from lightgbm_tpu_torch.analysis import trace_audit as ta
from lightgbm_tpu_torch.analysis.__main__ import main as cli
from lightgbm_tpu_torch.analysis.contracts import CONTRACTS, Target
from lightgbm_tpu_torch.parallel import collectives as C


def _jax_contracts():
    """The JAX package's catalogue (its contracts module, not its audit)."""
    from lightgbm_tpu.analysis.contracts import CONTRACTS as J
    return J


@pytest.fixture(scope="module")
def report():
    t0 = time.perf_counter()
    rep = ta.run_trace_audit()
    rep.seconds = time.perf_counter() - t0
    return rep


@pytest.fixture(scope="module")
def by_name(report):
    return {r.name: r for r in report.results}


def test_catalogue_has_the_jax_contracts_and_lists_its_departures():
    jc = _jax_contracts()
    assert set(CONTRACTS) == set(jc) and len(CONTRACTS) == 19
    for name, c in CONTRACTS.items():
        j = jc[name]
        assert (c.collectives == ()) == (j.collectives == ()), name
        jaxes = {a for t in j.collectives for a in t.split("@", 1)[1].split(",")}
        axes = {t.split("@", 1)[1] for t in c.collectives}
        assert jaxes <= axes | {"data"} if c.sharded else not axes, name
        if c.collectives != j.collectives:
            assert c.sharded and c.departure, name  # C16/C17, said where
        assert c.sharded == bool(j.collectives), name
        if j.dcn_max_bytes is not None:
            assert c.dcn_max_bytes is not None, name
        if j.feature_max_bytes is not None:
            assert c.feature_max_bytes is not None, name
        if j.max_bin_sweeps is not None:
            assert c.bin_sweeps is not None, name


def test_all_contracts_verify_clean_in_one_gloo_launch(report, by_name):
    assert report.ok, "\n".join(f.format() for f in report.findings)
    assert set(CONTRACTS) <= set(by_name)
    assert report.seconds < 90


def test_live_budgets_hold_the_fixture_readings_within_twice(by_name):
    """J6's budgets are fitted to readings (contracts.py): at each
    fixture the body's live bytes fit its budget, and the budget is no
    more than twice them, so a doubling of a body's memory fails J6."""
    for name in CONTRACTS:
        d = by_name[name].detail
        assert d["peak_live_bytes"] <= d["live_budget"] <= 2 * d["peak_live_bytes"], \
            (name, d["peak_live_bytes"], d["live_budget"])


def test_sharded_rounds_have_exactly_one_large_merge(by_name):
    """The only large collectives of a sharded round are its one merge
    of the window sums (two tensors: the int64 sums and the int32 counts,
    C16)."""
    for name in ("windowed_round_sharded_psum", "windowed_round_sharded_scatter",
                 "windowed_round_sharded_megakernel_psum"):
        d = by_name[name].detail
        assert d["large_collectives"] == 2, (name, d["collectives"])
        merge = [t for t in d["collectives"] if t.startswith("psum_scatter")]
        assert len(merge) == (2 if "scatter" in name else 0)


def test_2d_round_histogram_phase_never_crosses_the_feature_axis(by_name):
    for name in ("windowed_round_2d_float", "windowed_round_2d_quantized"):
        d = by_name[name].detail
        c = CONTRACTS[name]
        assert d["feature_bytes"] <= c.feature_max_bytes
        assert d["axis_bytes"]["data"] > d["axis_bytes"]["feature"]
        assert "psum_scatter@feature" not in d["collectives"]
        # the merge sits between the window check and the election, on data
        merge = d["collectives"][4:-5]
        assert merge and all(t.endswith("@data") for t in merge)


def test_single_device_bodies_are_collective_free(by_name):
    single = [n for n, c in CONTRACTS.items() if not c.sharded]
    assert len(single) == 12
    for name in single:
        assert by_name[name].detail["collectives"] == []


def test_continual_refit_is_one_collective_free_dispatch(by_name):
    d = by_name["continual_refit_leaves"].detail
    assert d["collectives"] == [] and d["ledger"]["dispatches"] == 1
    assert d["wrappers"] == {"histogram_multi": 2}  # one a tree of the two


def test_megakernel_against_three_pass_sweep_pins(by_name):
    mk = by_name["windowed_round_megakernel"].detail["bin_sweeps"]
    tp = by_name["windowed_round_three_pass_sweeps"].detail["bin_sweeps"]
    assert 1.0 <= mk <= CONTRACTS["windowed_round_megakernel"].bin_sweeps
    # B1's window mode reads the window through the order: one sweep, as
    # the megakernel's, where the gathered copy made it two
    assert 1.0 <= tp <= CONTRACTS["windowed_round_three_pass_sweeps"].bin_sweeps
    assert abs(tp - mk) <= 0.1


def test_sharded_megakernel_keeps_the_merge_protocol(by_name):
    a = by_name["windowed_round_sharded_megakernel_psum"].detail
    b = by_name["windowed_round_sharded_psum"].detail
    assert a["collectives"] == b["collectives"]
    assert a["wrappers"] == {"round_partition_window": 1, "carry_convert": 1}


def test_hierarchical_ici_sequence_equals_the_flat_sharded_one(by_name):
    for hier, flat in (("windowed_round_hierarchical_psum",
                        "windowed_round_sharded_psum"),
                       ("windowed_round_hierarchical_voting",
                        "windowed_round_sharded_scatter")):
        h = [t.replace("@ici", "@data").replace("@world", "@data")
             for t in by_name[hier].detail["collectives"] if not t.endswith("@dcn")]
        assert h == by_name[flat].detail["collectives"], hier


def test_hierarchical_dcn_bytes_pinned(by_name):
    for name in ("windowed_round_hierarchical_psum",
                 "windowed_round_hierarchical_voting"):
        d = by_name[name].detail
        assert 0 < d["dcn_bytes"] <= CONTRACTS[name].dcn_max_bytes
        # a full histogram state over dcn would not fit the bill
        assert d["axis_bytes"]["ici"] + d["dcn_bytes"] > CONTRACTS[name].dcn_max_bytes


def test_ledger_crosscheck_agrees(report):
    led = report.ledger
    assert set(led) == {"graphs", "psum", "scatter"}
    assert led["graphs"]["dispatches"] == led["graphs"]["rounds"] >= 2
    for merge in ("psum", "scatter"):
        n = len(CONTRACTS[f"windowed_round_sharded_{merge}"].collectives)
        assert led[merge]["mesh_collectives"] == led[merge]["rounds"] * n


# ---------------------------------------------------------------------------
# negative fixtures: one per J rule, each failing under its own ID
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A one-rank gloo group in this process, for the collective fixtures."""
    import torch.distributed as dist

    store = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    from lightgbm_tpu_torch.parallel.mesh import make_mesh
    yield make_mesh()
    dist.destroy_process_group()


def _contract(build, **kw):
    base = CONTRACTS["predict_warm_single"]
    kw.setdefault("launches", {})
    return dataclasses.replace(base, name="fixture", build=build, **kw)


def _rules(c):
    res = ta.audit_contract(c)
    return sorted({f.rule for f in res.findings}), res


def test_j1_a_second_collective_fails(group):
    def build(device="cpu", fixture=None):
        def body(b):
            b[0].copy_(C.psum(C.psum(b[0], group), group))
        return Target(body, (torch.ones(4),), meshes=(group,))

    ok = _contract(build, collectives=("psum@data", "psum@data"), sharded=True)
    assert ta.audit_contract(ok).ok
    rules, res = _rules(_contract(build, collectives=("psum@data",), sharded=True))
    assert rules == ["J1"], res.findings


def test_j1_an_undeclared_axis_and_a_stray_c10d_op_fail(group):
    import torch.distributed as dist
    from lightgbm_tpu_torch.parallel.mesh import Mesh

    feat = Mesh(None, "feature")

    def build(device="cpu", fixture=None):
        def body(b):
            b[0].copy_(C.psum(b[0], feat))
        return Target(body, (torch.ones(4),), meshes=(feat,))

    rules, res = _rules(_contract(build, collectives=("psum@data",), sharded=True))
    assert rules == ["J1"] and any("undeclared axis" in f.message
                                   for f in res.findings)

    def stray(device="cpu", fixture=None):
        def body(b):
            dist.all_reduce(b[0])
        return Target(body, (torch.ones(4),))

    rules, res = _rules(_contract(stray, sharded=True))
    assert rules == ["J1"] and "outside parallel/collectives.py" in \
        res.findings[0].message


def test_j2_a_rebound_buffer_fails():
    def build(device="cpu", fixture=None):
        def body(b):
            b[0].data = b[0].data + 1
        return Target(body, (torch.ones(4),))

    assert _rules(_contract(build))[0] == ["J2"]


def test_j3_an_f64_leak_fails():
    def build(device="cpu", fixture=None):
        def body(b):
            b[0].copy_((b[0].double() * 2).float())
        return Target(body, (torch.ones(4),))

    assert _rules(_contract(build))[0] == ["J3"]
    assert ta.audit_contract(_contract(build, max_f64_ops=2)).ok


def test_j4_an_item_in_the_body_fails():
    def build(device="cpu", fixture=None):
        def body(b):
            if b[0].sum().item() > 0:
                b[0].mul_(2)
        return Target(body, (torch.ones(4),))

    rules, res = _rules(_contract(build))
    assert rules == ["J4"] and "_local_scalar_dense" in res.findings[0].message


def test_j5_a_large_host_tensor_in_the_body_fails():
    def build(device="cpu", fixture=None):
        def body(b):
            b[0].add_(torch.tensor(list(range(8192)), dtype=torch.float32)[:4])
        return Target(body, (torch.ones(4),))

    assert _rules(_contract(build))[0] == ["J5"]


def test_j6_a_blow_up_fails():
    def build(device="cpu", fixture=None):
        def body(b):
            big = torch.zeros((1 << 20,))
            b[0].add_(big[:4])
        return Target(body, (torch.ones(4),))

    assert _rules(_contract(build, live={"floor": 1 << 16}))[0] == ["J6"]


def test_j7_an_extra_sweep_fails():
    bins = torch.randint(0, 32, (256, 8), dtype=torch.int16)

    def build(device="cpu", fixture=None):
        def body(b):
            b[0].add_(bins.sum(0).float())  # one sweep
            b[0].add_(bins.float().sum(0))  # a second: the cast reads them all
        return Target(body, (torch.zeros(8),), fixed=(bins,), bins=bins)

    assert ta.audit_contract(_contract(build, bin_sweeps=2.1)).ok
    rules, res = _rules(_contract(build, bin_sweeps=1.1))
    assert rules == ["J7"], res.findings


def test_waivers_with_and_without_a_reason():
    def build(device="cpu", fixture=None):
        def body(b):
            b[0].fill_(b[0].sum().item())
        return Target(body, (torch.ones(4),))

    res = ta.audit_contract(_contract(build, waivers={"J4": "the fixture's one read"}))
    assert res.ok and [f.rule for f, _ in res.waived] == ["J4"]
    res = ta.audit_contract(_contract(build, waivers={"J4": " "}))
    assert sorted(f.rule for f in res.findings) == ["J4", "P0"]
    res = ta.audit_contract(_contract(build, waivers={"J9": "no such rule"}))
    assert sorted(f.rule for f in res.findings) == ["J4", "P0"]


def test_cli_trace_selection_and_exit_codes(capsys):
    assert cli(["--list-contracts"]) == 0
    out = capsys.readouterr().out
    assert all(n in out for n in CONTRACTS) and "J7" in out
    assert cli(["--trace", "--contract", "no_such_contract"]) == 2
    capsys.readouterr()
    assert cli(["--trace", "--contract", "predict_warm_single",
                "--contract", "windowed_round_megakernel", "--no-runtime"]) == 0
    err = capsys.readouterr().err
    assert "predict_warm_single: ok" in err and "0 finding(s)" in err
    assert "windowed_round_float" not in err
