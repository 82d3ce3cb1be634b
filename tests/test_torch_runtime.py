"""Port parity: the quickstart server — ``ArcusRuntime.register``
(admission over a profiled ProfileTable) plus ``run_managed`` (Algorithm 1
between windows) — in ``repro_torch`` against the JAX package, at cut tick
counts: admission decisions, every WindowReport, the registers the control
loop wrote and the final counters must be equal."""
import copy
import json

import numpy as np
import pytest
import torch

from _torch_parity import assert_results_equal, one_torch_thread, port_spec
from repro.core import SLO, FlowSpec, Path, TrafficPattern
from repro.core.accelerator import CATALOG
from repro.core.profiler import ProfileTable
from repro.core.runtime import ArcusRuntime
from repro_torch.core import accelerator as tacc, profiler as tprof
from repro_torch.core import engine as te, runtime as trt, sim as tsim


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: beside the other test processes a pool of
    threads spin-waits (``_torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


PROFILE_TICKS = 600
TOTAL, WINDOW = 800, 200
LOAD_REF = {0: 32.0, 1: 32.0}


def _specs():
    return [FlowSpec(i, vm_id=i, path=Path.FUNCTION_CALL, accel_id=0,
                     pattern=TrafficPattern(1500, load=0.9),
                     slo=SLO.gbps(slo))
            for i, slo in enumerate((10.0, 20.0, 10.0))]


def _drive(rt, specs, **kw):
    admitted = [rt.register(s) for s in specs]
    res, reports = rt.run_managed(load_ref_gbps=LOAD_REF, **kw)
    return admitted, res, reports


@pytest.fixture(scope="module")
def runs():
    j_rt = ArcusRuntime([CATALOG["ipsec32"]],
                        profile_table=ProfileTable(n_ticks=PROFILE_TICKS))
    t_rt = trt.ArcusRuntime([tacc.CATALOG["ipsec32"]],
                            profile_table=tprof.ProfileTable(
                                n_ticks=PROFILE_TICKS, device="cpu"),
                            device="cpu")
    j = _drive(j_rt, _specs(), total_ticks=TOTAL, window_ticks=WINDOW)
    t = _drive(t_rt, [port_spec(s) for s in _specs()], total_ticks=TOTAL,
               window_ticks=WINDOW)
    return (j_rt, j), (t_rt, t)


def _report_json(r) -> str:
    return json.dumps(r.to_json(), sort_keys=True)


def test_admission_decisions_match(runs):
    (_, j), (_, t) = runs
    assert j[0] == t[0] == [True, True, False]


def test_profile_entries_match(runs):
    (j_rt, _), (t_rt, _) = runs
    assert list(j_rt.profile.entries) == list(t_rt.profile.entries)
    for k, e in j_rt.profile.entries.items():
        f = t_rt.profile.entries[k]
        assert (e.capacity, e.per_flow, e.fairness, e.ctx, e.res_names) == \
            (f.capacity, f.per_flow, f.fairness, f.ctx, f.res_names)


def test_window_reports_match(runs):
    (_, j), (_, t) = runs
    assert len(j[2]) == len(t[2]) == TOTAL // WINDOW
    for a, b in zip(j[2], t[2]):
        assert _report_json(a) == _report_json(b)


def test_final_counters_and_ring_match(runs):
    (_, j), (_, t) = runs
    assert_results_equal(j[1], t[1])


def test_control_state_matches(runs):
    """The registers Algorithm 1 wrote, and its per-flow bookkeeping."""
    (j_rt, _), (t_rt, _) = runs
    assert sorted(j_rt.table) == sorted(t_rt.table)
    for fid, js in j_rt.table.items():
        ts = t_rt.table[fid]
        assert js.params.__dict__ == ts.params.__dict__
        assert (js.headroom, js.violations, js.reconfigs, js.streak) == \
            (ts.headroom, ts.violations, ts.reconfigs, ts.streak)
        assert js.measured == ts.measured or (np.isnan(js.measured)
                                              and np.isnan(ts.measured))


def test_trailing_partial_window_matches(runs):
    """total_ticks % window_ticks != 0 runs one short final window; the
    runtimes reuse the profiled tables, so nothing is profiled again."""
    (j_rt, _), (t_rt, _) = runs
    j2 = ArcusRuntime([CATALOG["ipsec32"]],
                      profile_table=copy.deepcopy(j_rt.profile))
    t2 = trt.ArcusRuntime([tacc.CATALOG["ipsec32"]],
                          profile_table=copy.deepcopy(t_rt.profile),
                          device="cpu")
    j = _drive(j2, _specs()[:2], total_ticks=500, window_ticks=200)
    t = _drive(t2, [port_spec(s) for s in _specs()[:2]], total_ticks=500,
               window_ticks=200)
    assert [r.t_end_s for r in t[2]] == [r.t_end_s for r in j[2]]
    assert len(t[2]) == 3
    for a, b in zip(j[2], t[2]):
        assert _report_json(a) == _report_json(b)
    assert_results_equal(j[1], t[1])


def test_profile_table_json_from_reference(runs, tmp_path, monkeypatch):
    """A ProfileTable the JAX package wrote loads in the port, and the
    port's admission decides from it without profiling again."""
    (j_rt, _), _ = runs
    path = tmp_path / "profile.json"
    j_rt.profile.to_json(str(path))
    table = tprof.ProfileTable.from_json(str(path), device="cpu")
    assert list(table.entries) == list(j_rt.profile.entries)
    for k, e in j_rt.profile.entries.items():
        f = table.entries[k]
        assert (e.capacity, e.per_flow, e.fairness, e.res_names) == \
            (f.capacity, f.per_flow, f.fairness, f.res_names)

    def no_sim(*a, **k):
        raise AssertionError("admission profiled despite a full table")
    monkeypatch.setattr(tprof, "simulate", no_sim)
    rt = trt.ArcusRuntime([tacc.CATALOG["ipsec32"]], profile_table=table,
                          device="cpu")
    assert [rt.register(port_spec(s)) for s in _specs()] == \
        [True, True, False]
    # and the port's own table round-trips through JSON
    out = tmp_path / "port.json"
    table.to_json(str(out))
    assert json.loads(out.read_text()) == json.loads(path.read_text())


def test_deregister_and_lifecycle_version():
    table = tprof.ProfileTable(device="cpu")
    rt = trt.ArcusRuntime([tacc.CATALOG["ipsec32"]], profile_table=table,
                          device="cpu")
    key = tprof.context_key("ipsec32", [(Path.FUNCTION_CALL, 1500, 0.9)])
    table.entries[key] = tprof.CapacityEntry([28.0], [[28.0]], 1.0, key)
    v0 = rt.lifecycle_version
    assert rt.register(port_spec(_specs()[0]))
    assert rt.lifecycle_version == v0 + 1
    st = rt.deregister(0)
    assert st.spec.flow_id == 0 and rt.lifecycle_version == v0 + 2
    with pytest.raises(KeyError):
        rt.deregister(0)


def test_window_report_json_round_trip(runs):
    _, (_, t) = runs
    for r in t[2]:
        back = trt.WindowReport.from_json(json.loads(_report_json(r)))
        assert _report_json(back) == _report_json(r)


def test_runtime_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trt.ArcusRuntime([tacc.CATALOG["ipsec32"]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprof.ProfileTable()
    assert tsim.SHAPING_HW == 1


@pytest.mark.parametrize("kw", [
    dict(capacity_gbps=28.0, per_flow_gbps=[12.0, 16.0]),
    dict(capacity_gbps=28.0),
    dict(per_flow_gbps=[12.0, 16.0], capacity=[30.0, 5.0]),
    dict(capacity=[30.0], per_flow=[[14.0, 16.0]], capacity_gbps=1.0,
         per_flow_gbps=[1.0, 1.0]),
    dict(capacity=25.0, per_flow=[10.0, 15.0])])
def test_capacity_entry_compat_surface(kw):
    """The pre-vector keyword names construct entries through the same
    DeprecationWarning as the reference's, with the same precedence (the
    vector fields win), and read back as properties."""
    import warnings

    from repro.core.profiler import CapacityEntry as JEntry
    entries = []
    for cls in (JEntry, tprof.CapacityEntry):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            e = cls(fairness=0.5, ctx="c", **kw)
        entries.append((e, [(w.category, str(w.message)) for w in caught]))
    (j, j_warn), (t, t_warn) = entries
    assert t_warn == j_warn
    assert bool(t_warn) == any(k.endswith("_gbps") for k in kw)
    assert (t.capacity, t.per_flow, t.res_names) == \
        (j.capacity, j.per_flow, j.res_names)
    assert t.capacity_gbps == j.capacity_gbps
    assert t.per_flow_gbps == j.per_flow_gbps
    with pytest.raises(AttributeError):
        t.capacity_gbps = 1.0
    with pytest.raises(TypeError, match="requires capacity"):
        tprof.CapacityEntry()
    with pytest.raises(TypeError, match="requires capacity"), \
            pytest.warns(DeprecationWarning):
        tprof.CapacityEntry(per_flow_gbps=[1.0])


def test_managed_windows_reuse_one_cache_entry(runs, monkeypatch):
    """After ``cache_clear()``, every window of ``run_managed`` on the CPU
    leaves ``cache_info()`` at one entry and one trace, and so does a
    second managed run: its windows reuse the entry, never capturing again
    (the port's analogue of the reference's ``test_runtime`` and
    ``test_engine`` cache tests)."""
    (_, _), (t_rt, _) = runs
    rt = trt.ArcusRuntime([tacc.CATALOG["ipsec32"]],
                          profile_table=copy.deepcopy(t_rt.profile),
                          device="cpu")
    for s in _specs()[:2]:
        rt.register(port_spec(s))
    seen = []
    simulate = trt.simulate

    def counted(*a, **k):
        out = simulate(*a, **k)
        seen.append(te.cache_info())
        return out
    monkeypatch.setattr(trt, "simulate", counted)
    te.cache_clear()
    for _ in range(2):
        _, reports = rt.run_managed(total_ticks=300, window_ticks=100,
                                    load_ref_gbps=LOAD_REF)
        assert len(reports) == 3
    assert seen == [{"entries": 1, "traces": 1}] * 6
