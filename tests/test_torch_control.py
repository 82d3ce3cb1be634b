"""Port parity of the closed-loop control policies
(``repro_torch.core.control``, ``repro_torch.core.policies``) against the
JAX package: ``StaticHold`` / ``SlackAIMD`` / ``GlobalRetarget`` decisions
on the same window views, capacity envelopes of a profiled server,
``plan_params`` / ``actuate``, the telemetry JSON schema, and adaptive
``FleetController`` runs (the adaptive benchmark's churn arm, small)
against the reference's run: reports, control state, violations and
reconfigurations exactly."""
import dataclasses
import json
import math
import types

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from _fleet_parity import JAX, PORT, control_state, report_json

PROFILE_TICKS = 200
WINDOW = 100


def _metric(ns, fid, kind, rng):
    target = 2e-6 if kind == int(ns.SLOKind.LATENCY) else float(
        rng.choice([4.0, 8.0]))
    violated = bool(rng.random() < 0.3)
    slack = float(rng.choice([np.nan, -0.4, 0.05, 0.3]))
    return ns.telemetry.WindowMetrics(
        flow_id=fid, lane=fid, kind=kind, target=target,
        measured=float(rng.random() * 10), slack=slack, violated=violated,
        streak=int(rng.integers(0, 4)) if violated else 0,
        lat_avg_s=float(rng.choice([np.nan, 1e-6, 3e-6])), util=(0.5,))


def _views(ns, seed: int, window: int):
    """Window ``window``'s random views of three servers: 1-4 tenants
    each, of fixed kinds and envelopes (latency tenants have none), with
    this window's metrics and a placement margin or none."""
    layout = np.random.default_rng(seed)
    rng = np.random.default_rng(1000 * seed + window)
    kinds = [int(ns.SLOKind.GBPS), int(ns.SLOKind.IOPS),
             int(ns.SLOKind.LATENCY)]
    views = []
    for b in range(3):
        fids = list(range(10 * b, 10 * b + int(layout.integers(1, 5))))
        kind = {f: kinds[int(layout.choice(3, p=[0.6, 0.2, 0.2]))]
                for f in fids}
        envs = {f: ns.control.Envelope(floor, floor + span)
                for f in fids
                for floor, span in [(float(layout.choice([4.0, 8.0])),
                                     float(layout.choice([0.0, 3.5, 16.0])))]
                if kind[f] != int(ns.SLOKind.LATENCY)}
        metrics = {f: _metric(ns, f, kind[f], rng) for f in fids}
        margin = (None if rng.random() < 0.3
                  else float(rng.choice([-0.1, 0.01, 0.04, 0.5])))
        views.append(ns.control.ServerView(server=b, window_s=1e-3,
                                           metrics=metrics, envelopes=envs,
                                           margin=margin))
    return views


POLICIES = {
    "static": lambda ns: ns.control.StaticHold(),
    "aimd": lambda ns: ns.control.SlackAIMD(ai=0.3, md=0.6, start_frac=0.2),
    "retarget": lambda ns: ns.control.GlobalRetarget(ns.control.SlackAIMD(),
                                                     period=3)}


def _plans(out):
    return [None if p is None else {f: dataclasses.astuple(r)
                                    for f, r in p.items()} for p in out]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_policy_decisions_match_reference(policy, seed):
    """Twelve windows of random views: every server's plans (rate and
    burst scale per tenant, or hold) equal the reference policy's, bit
    for bit, and stay inside each tenant's envelope."""
    pols = {id(ns): POLICIES[policy](ns) for ns in (JAX, PORT)}
    for w in range(12):
        outs = {id(ns): pols[id(ns)].decide(w, _views(ns, seed, w))
                for ns in (JAX, PORT)}
        assert _plans(outs[id(JAX)]) == _plans(outs[id(PORT)])
        for sv, plan in zip(_views(PORT, seed, w), outs[id(PORT)]):
            for fid, p in (plan or {}).items():
                env = sv.envelopes[fid]
                assert env.floor - 1e-9 <= p.rate <= env.ceil + 1e-9


@settings(max_examples=25, deadline=None)
@given(seq=st.lists(st.sampled_from(["clear", "guard", "violated"]),
                    min_size=1, max_size=12),
       floor=st.floats(1.0, 50.0), span=st.floats(0.0, 40.0),
       ai=st.floats(0.05, 1.0), md=st.floats(0.1, 1.0))
def test_aimd_trajectory_matches_reference_property(seq, floor, span, ai,
                                                    md):
    """On any clear / guard-band / violated sequence the port's AIMD
    walks the reference's trajectory and never leaves the envelope."""
    rates = []
    for ns in (JAX, PORT):
        pol = ns.control.SlackAIMD(ai=ai, md=md)
        env = {0: ns.control.Envelope(floor, floor + span)}
        out = []
        for w, kind in enumerate(seq):
            slack = {"clear": 0.5, "guard": 0.05, "violated": -0.5}[kind]
            m = ns.telemetry.WindowMetrics(
                flow_id=0, lane=0, kind=int(ns.SLOKind.GBPS), target=floor,
                measured=floor * (1 + slack), slack=slack,
                violated=kind == "violated", streak=0,
                lat_avg_s=float("nan"), util=())
            plan = pol.decide(w, [ns.control.ServerView(
                0, 1e-3, {0: m}, env)])[0][0]
            assert floor - 1e-9 <= plan.rate <= floor + span + 1e-9
            out.append(dataclasses.astuple(plan))
        rates.append(out)
    assert rates[0] == rates[1]


def _fake_rt(ns, specs):
    """A runtime stand-in for ``plan_params`` / ``actuate``: the real
    catalogue and planner, no profiling."""
    table = {}
    for s in specs:
        params = ns.runtime.reshape_decision(
            ns.CATALOG["synthetic50"], s.slo, s.pattern.msg_bytes,
            clock_hz=250e6).params
        table[s.flow_id] = types.SimpleNamespace(spec=s, params=params,
                                                 reconfigs=0)
    return types.SimpleNamespace(accel_specs=[ns.CATALOG["synthetic50"]],
                                 clock_hz=250e6, table=table)


def test_plan_params_and_actuate_match_reference():
    """Registers realising a plan (rates around the SLO, bucket scales,
    an IOPS tenant, a message the planner splits) and what ``actuate``
    commits and reports equal the reference's."""
    out = []
    for ns in (JAX, PORT):
        specs = [ns.FlowSpec(0, 0, ns.Path.FUNCTION_CALL, 0,
                             ns.TrafficPattern(1024, load=0.3),
                             ns.SLO.gbps(8.0)),
                 ns.FlowSpec(1, 1, ns.Path.FUNCTION_CALL, 0,
                             ns.TrafficPattern(512, load=0.3),
                             ns.SLO.iops(2e5)),
                 ns.FlowSpec(2, 2, ns.Path.FUNCTION_CALL, 0,
                             ns.TrafficPattern(1 << 20, load=0.3),
                             ns.SLO.gbps(12.0)),
                 ns.FlowSpec(3, 3, ns.Path.FUNCTION_CALL, 0,
                             ns.TrafficPattern(64, rate_mps=1e6),
                             ns.SLO.latency(2e-6))]
        rt = _fake_rt(ns, specs)
        rows = []
        for rate, scale in ((8.0, 1.0), (13.7, 0.5), (2e5, 1e-6),
                            (31.3, 0.25), (8.0, 1.0)):
            plans = {f: ns.control.RatePlan(rate=rate, burst_scale=scale)
                     for f in (0, 1, 2, 3, 42)}
            rows.append([dataclasses.astuple(ns.control.plan_params(
                rt, rt.table[f], plans[f])) for f in (0, 1, 2)])
            rows.append(ns.control.actuate(rt, plans))
            rows.append({f: (dataclasses.astuple(s.params), s.reconfigs)
                         for f, s in rt.table.items()})
        out.append(rows)
    assert out[0] == out[1]


def test_policy_plans_match_reference():
    """The user-facing SLO policies' register plans (reserved, on demand,
    managed burst, opportunistic) equal the reference's."""
    rows = []
    for ns in (JAX, PORT):
        import importlib
        pol = importlib.import_module(
            ns.engine.__name__.replace("engine", "policies"))
        plans = [pol.plan_reserved(ns.SLO.gbps(8.0)),
                 pol.plan_on_demand(ns.SLO.iops(3e5), 512),
                 pol.plan_managed_burst(ns.SLO.gbps(5.0), burst_x=4.0),
                 pol.plan_managed_burst(ns.SLO.iops(1e5)),
                 pol.plan_opportunistic()]
        rows.append([(dataclasses.astuple(p.params),
                      p.admission_guaranteed, p.capacity_debit_gbps,
                      p.weight, p.priority) for p in plans])
    assert rows[0] == rows[1]


def test_capacity_envelopes_match_reference():
    """A profiled server on a two-axis link (a hinted tenant, an IOPS
    tenant, a latency tenant, two accelerators): its envelopes — floor
    and profiled ceiling per rate tenant — equal the reference's."""
    out = []
    for ns in (JAX, PORT):
        link = ns.LinkSpec(resources=(ns.mem_bw(30.0), ns.host_dma(60.0)))
        rt = ns.ArcusRuntime([ns.CATALOG["synthetic50"],
                              ns.CATALOG["aes256"]], link=link,
                             profile_table=ns.ProfileTable(
                                 link, n_ticks=PROFILE_TICKS))
        specs = [
            ns.FlowSpec(0, 0, ns.Path.FUNCTION_CALL, 0,
                        ns.TrafficPattern(1024, load=0.4), ns.SLO.gbps(5.0),
                        res_demand=((ns.RES_MEM_BW, 0.05, 0.05),)),
            ns.FlowSpec(1, 1, ns.Path.FUNCTION_CALL, 0,
                        ns.TrafficPattern(1024, load=0.4), ns.SLO.gbps(4.0)),
            ns.FlowSpec(2, 2, ns.Path.FUNCTION_CALL, 1,
                        ns.TrafficPattern(512, load=0.3), ns.SLO.iops(1e5)),
            ns.FlowSpec(3, 3, ns.Path.FUNCTION_CALL, 1,
                        ns.TrafficPattern(64, rate_mps=1e5),
                        ns.SLO.latency(5e-6))]
        accepted = [rt.register(s) for s in specs]
        envs = ns.control.capacity_envelopes(rt)
        out.append((accepted, {f: dataclasses.astuple(e)
                               for f, e in envs.items()}))
    assert out[0] == out[1]
    assert set(out[1][1]) == {f for f, ok in zip(range(3), out[1][0]) if ok}


def test_window_metrics_and_report_json_match_reference():
    """The telemetry schema round-trips through JSON (NaN latency
    included) and the port writes the reference's JSON for equal
    values."""
    texts = []
    for ns in (JAX, PORT):
        m = dataclasses.replace(
            _metric(ns, 3, int(ns.SLOKind.GBPS), np.random.default_rng(2)),
            util=(0.5, 0.125, 1.5))
        rep = ns.runtime.WindowReport(
            t_end_s=1.5e-3, measured={0: 7.5, 3: 12.0}, violated=[3],
            reconfigured=[3], path_changes=[(3, 1, 2)],
            metrics={3: m, 0: dataclasses.replace(m, flow_id=0,
                                                  lat_avg_s=float("nan"))})
        back = ns.runtime.WindowReport.from_json(
            json.loads(json.dumps(rep.to_json())))
        assert json.dumps(back.to_json()) == json.dumps(rep.to_json())
        assert math.isnan(back.metrics[0].lat_avg_s)
        texts.append(json.dumps(rep.to_json(), sort_keys=True))
    assert texts[0] == texts[1]


# --- adaptive fleet runs ------------------------------------------------------


def _adaptive_churn(ns, profile, adaptive: bool):
    """``benchmarks/adaptive.py``'s churn arm, small: two servers, each a
    latency-critical 128 B tenant beside an 8 Gbps reference, bursty on /
    off tenants arriving at windows 1 and 2 and the first wave departing
    at 4; six windows."""
    rts = [ns.ArcusRuntime([ns.CATALOG["synthetic50"]], profile_table=profile)
           for _ in range(2)]
    pol = (ns.control.GlobalRetarget(ns.control.SlackAIMD(), period=3)
           if adaptive else ns.control.StaticHold())
    ctrl = ns.FleetController(rts, control=pol)
    assert ctrl.admit_fleet([[
        ns.FlowSpec(2000 + b, 2000 + b, ns.Path.FUNCTION_CALL, 0,
                    ns.TrafficPattern(128, rate_mps=1.0e6,
                                      process="poisson"),
                    ns.SLO.latency(4e-6)),
        ns.FlowSpec(1000 + b, 1000 + b, ns.Path.FUNCTION_CALL, 0,
                    ns.TrafficPattern(1024, load=0.3, process="poisson"),
                    ns.SLO.gbps(8.0))] for b in range(2)]) == [[True] * 2] * 2

    def burster(i):
        return ns.FlowSpec(i, i, ns.Path.FUNCTION_CALL, 0,
                           ns.TrafficPattern(1500, load=0.5, process="onoff",
                                             burst_len=64, duty=0.3),
                           ns.SLO.gbps(6.0))
    events = []
    for i in range(2):
        events += [ns.TenantEvent.arrive(1, burster(i), server=i),
                   ns.TenantEvent.depart(4, tenant_id=i),
                   ns.TenantEvent.arrive(2, burster(100 + i), server=i)]
    run = ctrl.run(total_ticks=6 * WINDOW, window_ticks=WINDOW, seeds=[0, 1],
                   load_ref_gbps=[{1: 32.0}] * 2, events=events)
    viol = sum(m.violated for rep in run[1] for w in rep
               for m in w.metrics.values())
    reconf = sum(rt.table[f].reconfigs for rt in rts for f in rt.table)
    return run, control_state(rts), viol, reconf


@pytest.fixture(scope="module")
def adaptive_runs():
    out = {}
    for ns in (JAX, PORT):
        profile = ns.ProfileTable(n_ticks=PROFILE_TICKS)
        for adaptive in (False, True):
            out[(id(ns), adaptive)] = _adaptive_churn(ns, profile, adaptive)
    return out


@pytest.mark.parametrize("adaptive", [False, True])
def test_adaptive_churn_arm_matches_reference(adaptive, adaptive_runs):
    """Static registers and the bi-level adaptive loop over a churn
    timeline: every report, final counter, register, violation count and
    reconfiguration count equal to the reference's."""
    (run_r, state_r, *n_r) = adaptive_runs[(id(JAX), adaptive)]
    (run_p, state_p, *n_p) = adaptive_runs[(id(PORT), adaptive)]
    assert report_json(run_r[1]) == report_json(run_p[1])
    for a, b in zip(run_r[0], run_p[0]):
        np.testing.assert_array_equal(a.counters["c_adm_bytes"],
                                      b.counters["c_adm_bytes"])
    assert state_r == state_p and n_r == n_p


def test_adaptive_loop_reconfigures_more_than_static(adaptive_runs):
    static = adaptive_runs[(id(PORT), False)][3]
    adaptive = adaptive_runs[(id(PORT), True)][3]
    assert adaptive > static


def test_adaptive_run_one_entry_and_hold_steady_packs(monkeypatch):
    """An adaptive timeline (contexts warmed on a throwaway clone) is one
    cache entry with one capture, and once the AIMD ramp converges the
    windows resume without a register rewrite: one pack for the first
    window and one per committed change."""
    profile = PORT.ProfileTable(n_ticks=PROFILE_TICKS)

    def ctrl():
        rts = [PORT.ArcusRuntime([PORT.CATALOG["synthetic50"]],
                                 profile_table=profile)]
        c = PORT.FleetController(rts, control=PORT.control.SlackAIMD(ai=0.5))
        assert c.admit_fleet([[PORT.FlowSpec(
            0, 0, PORT.Path.FUNCTION_CALL, 0,
            PORT.TrafficPattern(1024, load=0.3, process="poisson"),
            PORT.SLO.gbps(4.0))]]) == [[True]]
        return c
    kw = dict(total_ticks=6 * WINDOW, window_ticks=WINDOW, seeds=[1],
              load_ref_gbps=[{0: 32.0}])
    ctrl().run(**kw)
    c = ctrl()
    rt = c.runtimes[0]
    env = PORT.control.capacity_envelopes(rt)
    assert env[0].floor == pytest.approx(4.0) and env[0].ceil > env[0].floor
    packs = []
    real = PORT.tb.pack
    monkeypatch.setattr(PORT.tb, "pack",
                        lambda ps: packs.append(1) or real(ps))
    PORT.engine.cache_clear()
    _res, reports = c.run(**kw)
    assert PORT.engine.cache_info() == {"entries": 1, "traces": 1}
    assert len(reports[0]) == 6
    assert len(packs) == 1 + rt.table[0].reconfigs
    assert 1 <= rt.table[0].reconfigs <= 2 and len(packs) < 6
