"""Port parity of the tenant-lifecycle controller
(``repro_torch.core.controller.FleetController``) against the JAX
package's, on the same specs, seeds and timelines: a static run against
serial ``run_managed``, depart and readmit, a churn timeline on one cache
entry, lane recycling with its baseline reset, rebalancing, and the
runtime's deprecated fleet shims.  Counters, completion rings, every
``WindowReport.to_json()``, placements, ``stats``, lane maps, control
state and rebalance moves are compared exactly.  Profiles and windows are
a few hundred ticks (the port's CPU tick costs milliseconds)."""
import warnings

import numpy as np
import pytest
import torch

from _fleet_parity import (JAX, PORT, assert_fleet_runs_equal,
                           control_state, placements, report_json)
from _torch_parity import assert_results_equal
from repro_torch.core import controller as tctl, engine as te

PROFILE_TICKS = 200
WINDOW = 100
COMPLEMENTS = (["synthetic50"], ["synthetic50", "aes256"])


def _spec(ns, fid, slo, *, msg=1024, load=0.4, accel_id=0):
    return ns.FlowSpec(fid, fid, ns.Path.FUNCTION_CALL, accel_id,
                       ns.TrafficPattern(msg, load=load, process="poisson"),
                       ns.SLO.gbps(slo))


def _fleet(ns, profile, complements=COMPLEMENTS):
    return [ns.ArcusRuntime([ns.CATALOG[n] for n in names],
                            profile_table=profile)
            for names in complements]


@pytest.fixture(scope="module")
def profiles():
    """One ProfileTable per package, shared by the module's fleets (as the
    benchmarks share theirs): a context profiled once is a cache hit
    after."""
    return {id(ns): ns.ProfileTable(n_ticks=PROFILE_TICKS)
            for ns in (JAX, PORT)}


# --- static fleet ------------------------------------------------------------


def _ref_spec(ns, b):
    """Server b's long-lived reference tenant."""
    return ns.FlowSpec(1000 + b, 1000 + b, ns.Path.FUNCTION_CALL, 0,
                       ns.TrafficPattern(1024, load=0.35, process="poisson"),
                       ns.SLO.gbps(8.0))


def _static(ns, profile):
    rts = _fleet(ns, profile)
    assert rts[0].register(_ref_spec(ns, 0))
    assert rts[0].register(_spec(ns, 0, 6.0))
    assert rts[1].register(_ref_spec(ns, 1))
    return rts


STATIC = dict(total_ticks=3 * WINDOW + 70, window_ticks=WINDOW, seeds=[1, 2],
              load_ref_gbps=[{0: 32.0, 1: 32.0}, {0: 32.0}])


def test_static_run_matches_serial_and_reference(profiles):
    """A static fleet (a trailing partial window included) equals B serial
    ``run_managed`` calls of the port — counters, ring, reports, control
    state — and the reference controller's run."""
    runs = {}
    for ns in (JAX, PORT):
        rts = _static(ns, profiles[id(ns)])
        runs[id(ns)] = (ns.FleetController(rts).run(**STATIC),
                        control_state(rts))
    rts = _static(PORT, profiles[id(PORT)])
    serial = [rt.run_managed(total_ticks=STATIC["total_ticks"],
                             window_ticks=WINDOW, seed=STATIC["seeds"][b],
                             load_ref_gbps=STATIC["load_ref_gbps"][b])
              for b, rt in enumerate(rts)]
    (res, reps), state = runs[id(PORT)]
    for b, (r_s, rep_s) in enumerate(serial):
        assert_results_equal(r_s, res[b])
        assert report_json([rep_s]) == report_json([reps[b]])
    assert control_state(rts) == state
    assert_fleet_runs_equal(runs[id(JAX)][0], runs[id(PORT)][0])
    assert runs[id(JAX)][1] == state


# --- depart and readmit --------------------------------------------------------


def _depart_readmit(ns, profile):
    """Admit three tenants (two on server 0), run, depart one, run (its
    lane a hole), readmit the same spec on its server, run again."""
    rts = _fleet(ns, profile, (["synthetic50"], ["synthetic50"]))
    ctrl = ns.FleetController(rts)
    specs = [_spec(ns, i, 6.0) for i in range(3)]
    out = [placements(ctrl.place(specs, pinned=[0, 0, 1]))]
    kw = dict(total_ticks=2 * WINDOW, window_ticks=WINDOW, seeds=[3, 4],
              load_ref_gbps=[{0: 32.0, 1: 32.0}] * 2)
    runs = [ctrl.run(**kw)]
    home = ctrl.depart(1)
    out.append((home, [ctrl.lane_map(b) for b in range(2)]))
    runs.append(ctrl.run(**kw))
    out.append(placements([ctrl.admit(specs[1], server=0)]))
    out.append([ctrl.lane_map(b) for b in range(2)])
    runs.append(ctrl.run(**kw))
    out.append(dict(ctrl.stats))
    out.append(control_state(rts))
    return out, runs


def test_depart_and_readmit_match_reference(profiles):
    """The departed tenant's lane is a hole for the next run (same width),
    readmission refills it, and every run, decision and lane map equals the
    reference's."""
    ref = _depart_readmit(JAX, profiles[id(JAX)])
    port = _depart_readmit(PORT, profiles[id(PORT)])
    assert ref[0] == port[0]
    for a, b in zip(ref[1], port[1]):
        assert_fleet_runs_equal(a, b)
    (home, lanes), readmit, lanes_after = port[0][1:4]
    assert home == 0 and lanes[0] == [0, None]
    assert readmit[0][0] and lanes_after[0] == [0, 1]


# --- churn ---------------------------------------------------------------------


def _timeline(ns):
    ten = lambda i: _spec(ns, i, 6.0)  # noqa: E731
    return [ns.TenantEvent.arrive(1, ten(0), accel_name="synthetic50"),
            ns.TenantEvent.arrive(1, ten(1), accel_name="synthetic50"),
            ns.TenantEvent.depart(2, tenant_id=0),
            ns.TenantEvent.arrive(2, ten(2), accel_name="synthetic50"),
            ns.TenantEvent.depart(3, tenant_id=1),
            ns.TenantEvent.arrive(3, ten(3), accel_name="synthetic50")]


def _churn(ns, profile, *, reuse_lanes=False, rebalance=False):
    rts = _fleet(ns, profile)
    ctrl = ns.FleetController(rts, reuse_lanes=reuse_lanes)
    ref = [[_ref_spec(ns, b)] for b in range(2)]
    assert ctrl.admit_fleet(ref) == [[True], [True]]
    run = ctrl.run(total_ticks=4 * WINDOW, window_ticks=WINDOW,
                   seeds=[0, 1], load_ref_gbps=[{0: 32.0}] * 2,
                   events=_timeline(ns))
    out = dict(events=ctrl.last_events,
               lanes=[ctrl.lane_map(b) for b in range(2)])
    if rebalance:
        out["burst"] = placements(ctrl.place(
            [_spec(ns, 900 + i, 6.0) for i in range(2)], pinned=[0, 0],
            accel_names=["synthetic50"] * 2))
        out["moves"] = ctrl.rebalance()
        out["lanes_after"] = [ctrl.lane_map(b) for b in range(2)]
    out.update(stats=dict(ctrl.stats), state=control_state(rts))
    return out, run


@pytest.fixture(scope="module")
def churn_runs(profiles):
    return {(id(ns), reuse): _churn(ns, profiles[id(ns)], reuse_lanes=reuse,
                                    rebalance=not reuse)
            for ns in (JAX, PORT) for reuse in (False, True)}


def test_churn_timeline_matches_reference(churn_runs):
    """Arrivals placed fleet-wide, departures masked, every report,
    decision and final counter equal to the reference's."""
    ref, port = churn_runs[(id(JAX), False)], churn_runs[(id(PORT), False)]
    assert_fleet_runs_equal(ref[1], port[1])
    for k in ("events", "lanes", "stats", "state"):
        assert ref[0][k] == port[0][k], k
    assert all(e["server"] is not None for e in port[0]["events"])


def test_churn_timeline_stays_one_entry(churn_runs, profiles):
    """With its admission contexts warm, the whole churn timeline —
    arrivals, departures, lane holes — runs as one cache entry with one
    capture, and profiles nothing."""
    del churn_runs                       # the warm run, on the same table
    before = PORT.profiler.profiling_stats()
    te.cache_clear()
    _, run = _churn(PORT, profiles[id(PORT)])
    assert te.cache_info() == {"entries": 1, "traces": 1}
    assert PORT.profiler.profiling_stats()["contexts"] == before["contexts"]
    assert len(run[1][0]) == 4


def test_reuse_lanes_resets_the_baseline(churn_runs):
    """With ``reuse_lanes`` an arrival refills a departed tenant's lane;
    the lane's counters and the host's previous snapshot restart at zero,
    so the newcomer's first measured rate is its own — as the
    reference's."""
    ref, port = churn_runs[(id(JAX), True)], churn_runs[(id(PORT), True)]
    assert_fleet_runs_equal(ref[1], port[1])
    assert ref[0] == port[0]
    events = port[0]["events"]
    arrive = [e for e in events if e["kind"] == "arrive" and e["window"] > 1]
    departed = {(e["server"], e["lane"]) for e in events
                if e["kind"] == "depart"}
    assert any((e["server"], e["lane"]) in departed for e in arrive)
    reports = port[1][1]
    for e in arrive:
        m = reports[e["server"]][e["window"]].measured[e["tenant"]]
        assert 0.0 <= m < 40.0


def test_rebalance_matches_reference(churn_runs):
    """A pinned burst piles onto server 0; ``rebalance`` migrates onto the
    capacity freed elsewhere, with the reference's moves and margins."""
    ref, port = churn_runs[(id(JAX), False)], churn_runs[(id(PORT), False)]
    for k in ("burst", "moves", "lanes_after"):
        assert ref[0][k] == port[0][k], k
    assert port[0]["moves"] and all(m["src"] == 0
                                    for m in port[0]["moves"])


def test_windows_without_events_copy_no_trace(monkeypatch, profiles):
    """Event splices write the committed traces in place; a window after
    which no event touched them loads no trace into the entry's buffers
    (the first window loads them, each event window once more)."""
    copies = []
    real = te._Run._load_shared

    def counting(self, args):
        before = self._shared
        real(self, args)
        if self._shared is not before:
            copies.append(tuple(args["arr_t"].shape))
    rts = _fleet(PORT, profiles[id(PORT)])
    ctrl = PORT.FleetController(rts)
    assert ctrl.admit_fleet([[_ref_spec(PORT, 0)],
                             [_ref_spec(PORT, 1)]]) == [[True], [True]]
    monkeypatch.setattr(te._Run, "_load_shared", counting)
    ctrl.run(total_ticks=4 * WINDOW, window_ticks=WINDOW, seeds=[0, 1],
             events=[PORT.TenantEvent.depart(2, tenant_id=1000)])
    assert len(copies) == 2 and len(set(copies)) == 1


def test_poll_is_one_host_copy_of_the_counters():
    """``_poll`` returns every ``FLEET_POLL_KEYS`` counter as the carry
    holds it (the float latency sum by its bits) from one stacked copy."""
    rng = np.random.default_rng(0)
    carry = {k: torch.as_tensor(rng.integers(-5, 1 << 30, (3, 5)),
                                dtype=torch.int32)
             for k in PORT.telemetry.FLEET_POLL_KEYS}
    carry["c_lat_sum"] = torch.as_tensor(rng.random((3, 5)) * 1e6,
                                         dtype=torch.float32)
    host = tctl._poll(carry)
    for k, v in carry.items():
        assert host[k].dtype == v.numpy().dtype
        np.testing.assert_array_equal(host[k], v.numpy())


# --- the runtime's deprecated shims ---------------------------------------------


def test_fleet_shims_warn_and_match_the_controller(profiles):
    """``register_fleet``, ``place_fleet`` and ``run_managed_batch`` warn
    and give what ``FleetController`` gives; pinned first-fit placement
    reproduces ``register_fleet``'s decisions."""
    ns = PORT
    fleet_specs = [[_ref_spec(ns, 0), _spec(ns, 1, 60.0)],
                   [_ref_spec(ns, 1)]]
    rts_a = _fleet(ns, profiles[id(ns)])
    with pytest.warns(DeprecationWarning, match="register_fleet"):
        got = ns.runtime.register_fleet(rts_a, fleet_specs)
    rts_b = _fleet(ns, profiles[id(ns)])
    assert ns.FleetController(rts_b).admit_fleet(fleet_specs) == got
    rts_c = _fleet(ns, profiles[id(ns)])
    flat = [(b, s) for b, specs in enumerate(fleet_specs) for s in specs]
    with pytest.warns(DeprecationWarning, match="place_fleet"):
        placed = ns.runtime.place_fleet(
            rts_c, [s for _, s in flat], pinned=[b for b, _ in flat])
    assert [p.accepted for p in placed] == [a for row in got for a in row]
    kw = dict(total_ticks=2 * WINDOW, window_ticks=WINDOW, seeds=[5, 6],
              load_ref_gbps=[{0: 32.0}, {0: 32.0}])
    with pytest.warns(DeprecationWarning, match="run_managed_batch"):
        shim = ns.runtime.run_managed_batch(rts_a, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        direct = ns.FleetController(rts_b).run(**kw)
    assert_fleet_runs_equal(shim, direct)
    assert control_state(rts_a) == control_state(rts_b)
