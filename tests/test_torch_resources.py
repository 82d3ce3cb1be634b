"""Port parity of the shaped resource vector (``LinkSpec.resources``):
resource windows against the JAX engine bitwise (the reference's one-shot
grant path and its sequential loop both), the charge semantics the
reference's ``tests/test_resources.py`` pins (an inert axis is the default
engine, a tight axis throttles to the demand algebra, the burst carries idle
budget, ``fabric_only`` exempts off-fabric bytes), batched against serial,
the per-axis profiler entries and margins, the telemetry of every axis, and
``shaper.reshape_trace``."""
import dataclasses
import re

import jax
import numpy as np
import pytest

from _fleet_parity import JAX, PORT
from _torch_parity import (assert_bitwise, assert_carry_equal,
                           assert_results_equal, one_torch_thread)
from repro.core import shaper as jshaper
from repro_torch.core import engine as te, shaper as tshaper
from repro_torch.kernels.token_bucket import ops as tb_ops


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: beside the other test processes a pool of
    threads spin-waits (``_torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


#: window ticks of the parity runs (the port's CPU tick costs milliseconds)
N_TICKS = 300


def _scenario(ns, *, n_flows=4, n_ticks=N_TICKS, path=None, hint=0.05,
              load=0.9, accel="synthetic50", seed=0, cfg=None):
    """``n_flows`` flows (sizes 1024 + 300 i, a fifth of them 64 B) on one
    accelerator, SLOs 10 + 3 i Gbps; odd flows carry a ``hint`` memory
    demand (ingress and egress), even ones the default 1.0 / 1.0."""
    p = ns.Path.FUNCTION_CALL if path is None else path
    specs = [ns.FlowSpec(
        i, i, p if path is not None or i % 3 else ns.Path.INLINE_NIC_RX, 0,
        ns.TrafficPattern(1024 + 300 * i, load=load / max(n_flows / 2, 1),
                          process="poisson", msg_bytes2=64, p2=0.2),
        ns.SLO.gbps(10.0 + 3 * i),
        res_demand=((ns.RES_MEM_BW, hint, hint),) if i % 2 and hint
        is not None else ())
        for i in range(n_flows)]
    flows = ns.FlowSet.build(specs)
    sim_cfg = ns.sim.SimConfig(n_ticks=n_ticks, shaping=ns.sim.SHAPING_HW,
                               **(cfg or {}))
    arr = ns.sim.gen_arrivals(flows, sim_cfg, seed=seed, load_ref_gbps={
        i: 40.0 for i in range(n_flows)})
    tbs = ns.tb.pack([ns.tb.params_for_gbps(10.0 + 3 * i)
                      for i in range(n_flows)])
    return flows, ns.AccelTable.build([ns.CATALOG[accel]]), sim_cfg, tbs, arr


def _link(ns, mem, dma=None, burst=0):
    res = (ns.mem_bw(mem, burst),)
    if dma is not None:
        res += (ns.host_dma(dma, burst // 3),)
    return ns.LinkSpec(resources=res)


# --- windows against the reference -----------------------------------------

#: (memory Gbps, host-DMA Gbps, burst bytes): an axis starved to budgets of
#: a fraction of a message, a moderate one with a burst, a non-dyadic
#: capacity, and both axes wide
WINDOW_CASES = {"starved": (5.0, 8.5, 0), "burst": (20.0, 34.0, 5000),
                "nondyadic": (37.3, 63.41, 0), "wide": (61.7, 104.9, 5000)}


@pytest.fixture(scope="module")
def port_windows():
    """The port's carry of every ``WINDOW_CASES`` window (shared by both
    reference forms)."""
    out = {}
    for name, (mem, dma, burst) in WINDOW_CASES.items():
        flows, tab, cfg, tbs, arr = _scenario(PORT)
        out[name] = te.carry_to_numpy(te.run_window(
            flows, tab, _link(PORT, mem, dma, burst), cfg, tbs, *arr,
            device="cpu"))
    return out


@pytest.mark.parametrize("grant_fast", [True, False])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_resource_window_matches_reference(case, grant_fast, port_windows):
    """A window on a two-axis link, 0.05 hints on odd flows, equals the
    reference's carry bit for bit — its one-shot grant (``grant_fast`` and
    ``stage_fast``, whose cumulative check is a matrix product) and its
    sequential loop alike; the port runs the loop, charging each grant as
    one fused multiply-add and each egress pop as the reference's
    contracted sum."""
    mem, dma, burst = WINDOW_CASES[case]
    flows, tab, cfg, tbs, arr = _scenario(
        JAX, cfg=dict(grant_fast=grant_fast, stage_fast=grant_fast))
    ref = jax.device_get(JAX.engine.run_window(
        flows, tab, _link(JAX, mem, dma, burst), cfg, tbs, *arr))
    assert ref["c_adm_msgs"].sum() > 0
    assert_carry_equal(ref, port_windows[case])
    if case == "starved":
        assert (ref["res_res"] < 0).any()           # the axis is in debt


@pytest.mark.parametrize("variant", ["huge_cap", "zero_demand"])
def test_inert_axis_bitwise_equal_to_default(variant):
    """An axis that cannot bind — a huge capacity, or a tight one the
    accelerator charges nothing on — reproduces the default (R = 1)
    engine: counters, completion ring and latencies bit for bit."""
    flows, tab, cfg, tbs, arr = _scenario(PORT, hint=None)
    base = PORT.simulate(flows, tab, PORT.LinkSpec(), cfg, tbs, *arr)
    if variant == "huge_cap":
        link = _link(PORT, 1e6, 1e6)
    else:
        spec = dataclasses.replace(PORT.CATALOG["synthetic50"], res_demand=(
            (PORT.RES_MEM_BW, 0.0, 0.0),))
        tab = PORT.AccelTable.build([spec])
        link = _link(PORT, 2.0)
    assert_results_equal(base, PORT.simulate(flows, tab, link, cfg, tbs,
                                             *arr))


def _one_flow(ns, link, path=None, n_ticks=600):
    flows, tab, cfg, tbs, arr = _scenario(ns, n_flows=1, n_ticks=n_ticks,
                                          path=path, load=1.6)
    return ns.simulate(flows, tab, link, cfg, tbs, *arr)


@pytest.fixture(scope="module")
def one_flow_runs():
    """One saturating flow of 1024 B (``synthetic50``: egress = ingress)
    on the free link, on an 8 Gbps memory axis without and with a burst,
    and as an INLINE_NIC_TX flow on a pooled and a fabric-only 8 Gbps
    axis: the port's result, and for the two one-axis runs ``tight`` and
    ``fabric`` the reference's beside it."""
    cases = {
        "free": lambda ns: (ns.LinkSpec(), None),
        "tight": lambda ns: (ns.LinkSpec(resources=(ns.mem_bw(8.0),)), None),
        "burst": lambda ns: (ns.LinkSpec(resources=(
            ns.mem_bw(8.0, burst_bytes=2**20),)), None),
        "pooled": lambda ns: (ns.LinkSpec(resources=(ns.mem_bw(8.0),)),
                              ns.Path.INLINE_NIC_TX),
        "fabric": lambda ns: (ns.LinkSpec(resources=(ns.host_dma(8.0),)),
                              ns.Path.INLINE_NIC_TX)}
    return {k: tuple(_one_flow(ns, *mk(ns)) for ns in (
        (JAX, PORT) if k in ("tight", "fabric") else (PORT,)))
        for k, mk in cases.items()}


def _gbps(res) -> float:
    return float(res.counters["c_done_bytes"][0] * 8 / res.seconds / 1e9)


def test_tight_axis_throttles_to_demand_algebra(one_flow_runs):
    """An 8 Gbps axis charged 1.0 a byte in and 1.0 out: the axis carries
    ingress plus egress bytes, so its bytes over the window (admitted plus
    completed: equal sizes) stay within the axis' budget and fill most of
    it, and goodput falls to about half the axis (the free link carries
    the 10 Gbps SLO); bitwise the reference's result."""
    for k in ("tight", "fabric"):
        assert_results_equal(*one_flow_runs[k])
    tight, free = one_flow_runs["tight"][1], one_flow_runs["free"][0]
    cap = 8.0e9 / 8 * tight.seconds                  # axis bytes available
    charged = (tight.counters["c_adm_bytes"][0]
               + tight.counters["c_done_bytes"][0])
    assert 0.85 * cap < charged <= cap + 2 * 1024
    # half the axis, within one message of the window's dozen
    assert _gbps(tight) < 4.5 and _gbps(free) > 9.0


def test_burst_carries_idle_budget(one_flow_runs):
    """A burst depth lets idle ticks' budget accumulate; burst 0 loses it
    as the link does."""
    assert _gbps(one_flow_runs["burst"][0]) >= \
        _gbps(one_flow_runs["tight"][1])


def test_fabric_only_axis_exempts_off_fabric_bytes(one_flow_runs):
    """INLINE_NIC_TX egresses to the wire: a fabric-only host-DMA axis
    charges its ingress bytes only (the engine's egress coefficient is 0),
    so the same capacity carries more goodput than a pooled axis."""
    flows, tab, *_ = _scenario(PORT, n_flows=1, path=PORT.Path.INLINE_NIC_TX)
    link = PORT.LinkSpec(resources=(PORT.mem_bw(8.0), PORT.host_dma(8.0)))
    w_in, w_eg = te._resource_tables(flows, tab, link, 1)
    np.testing.assert_array_equal(w_in, [[1.0], [1.0]])
    np.testing.assert_array_equal(w_eg, [[1.0], [0.0]])
    assert _gbps(one_flow_runs["fabric"][1]) > \
        1.5 * _gbps(one_flow_runs["pooled"][0])


def test_resource_batch_matches_serial_and_reference():
    """A ragged batch on a two-axis link (three and two flows, different
    paths and seeds) equals the reference's batch and each element's
    serial run, and is one cache entry."""
    def run(ns):
        els = [_scenario(ns, n_flows=n, path=p, seed=n, n_ticks=200)
               for n, p in ((3, ns.Path.FUNCTION_CALL),
                            (2, ns.Path.INLINE_NIC_TX))]
        link = _link(ns, 12.0, 20.0)
        serial = [ns.simulate(f, a, link, c, t, *arr)
                  for f, a, c, t, arr in els] if ns is PORT else None
        ns.engine.cache_clear()
        batch = ns.simulate_batch(
            [e[0] for e in els], els[0][1], link, els[0][2],
            [e[3] for e in els], *ns.sim.stack_arrivals([e[4] for e in els]))
        assert ns.engine.cache_info() == {"entries": 1, "traces": 1}
        return serial, batch
    (_, b_ref), (s_port, b_port) = run(JAX), run(PORT)
    for a, b, c in zip(b_ref, b_port, s_port):
        assert_results_equal(a, b)
        assert_results_equal(c, b)


def test_batch_rejects_mismatched_axis_counts():
    flows, tab, cfg, tbs, arr = _scenario(PORT, n_flows=1, n_ticks=10)
    links = [PORT.LinkSpec(), _link(PORT, 10.0)]
    with pytest.raises(ValueError, match="resource"):
        PORT.simulate_batch(flows, tab, links, cfg, [tbs, tbs],
                            *PORT.sim.stack_arrivals([arr, arr]))


def test_grant_tick_holds_at_most_max_res_axes():
    """The kernel's argument block takes 1..``MAX_RES_AXES`` axes (the
    kernel's ``MAX_RES``) and refuses more before any launch."""
    src = tb_ops._SRC.read_text()
    assert int(re.search(r"constexpr int MAX_RES = (\d+);", src).group(1)) \
        == tb_ops.MAX_RES_AXES
    from repro_torch.kernels.token_bucket import rehearse
    for R, ok in ((tb_ops.MAX_RES_AXES, True),
                  (tb_ops.MAX_RES_AXES + 1, False)):
        cfg, args, carry, budget, t_idx = rehearse.random_batch_inputs(
            [3, 2], 0, "cpu", shapings=[1, 1], arbiters=[0, 0], k_grant=4)
        res = rehearse.random_resource_axes(args, R, 0, "cpu")
        if ok:
            assert tb_ops._grant_struct(cfg, args, carry, budget, t_idx,
                                        res).n_res == R
        else:
            with pytest.raises(ValueError, match="resource axes"):
                tb_ops._grant_struct(cfg, args, carry, budget, t_idx, res)


# --- profiler, margins, telemetry, shaper ------------------------------------


def test_profiled_axis_entries_match_reference(tmp_path):
    """A profiled context on a two-axis link (a hinted and an unhinted
    flow, one off-fabric) has the reference's entry: the measured link
    axis and each axis' capacity and demand coefficients; a table the
    reference writes loads in the port and compares equal."""
    def profile(ns):
        table = ns.ProfileTable(_link(ns, 24.0, 48.0), n_ticks=300)
        ctx = [(ns.Path.FUNCTION_CALL, 1024, 0.5),
               (ns.Path.INLINE_NIC_TX, 2048, 0.4,
                ((ns.RES_MEM_BW, 0.05, 0.05),))]
        table.profile_context(ns.CATALOG["aes256"], ctx)
        return table
    ref, port = profile(JAX), profile(PORT)
    as_dict = lambda t: {k: dataclasses.asdict(v)  # noqa: E731
                         for k, v in t.entries.items()}
    assert as_dict(ref) == as_dict(port)
    (entry,) = port.entries.values()
    assert entry.res_names == ["link", "mem_bw", "host_dma"]
    path = tmp_path / "ref.json"
    ref.to_json(str(path))
    loaded = PORT.profiler.ProfileTable.from_json(
        str(path), _link(PORT, 24.0, 48.0), device="cpu")
    assert as_dict(loaded) == as_dict(ref)


def test_vector_margin_is_min_over_axes():
    """The margin is the minimum over the axes; a binding extra axis makes
    the entry SLO-violating; one axis keeps the scalar semantics."""
    for ns in (JAX, PORT):
        e = ns.profiler.CapacityEntry([50.0, 20.0], [[25.0, 25.0],
                                                     [2.0, 2.0]], 1.0,
                                      res_names=["link", ns.RES_MEM_BW])
        m = e.slo_margins([10.0, 10.0])
        assert e.slo_margin([10.0, 10.0]) == min(m) and m[1] < 0 < m[0]
        assert not e.slo_tag([10.0, 10.0])
        assert e.residual_gbps([10.0, 10.0]) == 20.0 * 0.98 - 40.0
        e1 = ns.profiler.CapacityEntry(50.0, [25.0, 25.0], 1.0)
        assert e1.slo_margins([10.0, 10.0]) == [e1.slo_margin([10.0, 10.0])]
    pairs = [(ns.profiler.CapacityEntry([40.0, 24.0, 48.0],
                                        [[20.0, 12.0], [2.0, 0.1],
                                         [1.0, 1.0]], 0.9,
                                        res_names=["link", "a", "b"]))
             for ns in (JAX, PORT)]
    for slo in ([5.0, 5.0], [5.0], [30.0, 1.0]):
        assert pairs[0].slo_margins(slo) == pairs[1].slo_margins(slo)
        assert pairs[0].residual_gbps(slo) == pairs[1].residual_gbps(slo)


def test_axis_utilization_and_fleet_counters_match_reference():
    """``flow_axis_util`` charges every axis through the flow's demand
    coefficients (hint, accelerator, default; fabric-only exemption), and
    ``fleet_counters`` recombines the byte counters, as the reference."""
    rng = np.random.default_rng(0)
    host = {k: rng.integers(0, 1 << 20, (3, 4)).astype(np.int32)
            for k in JAX.telemetry.FLEET_POLL_KEYS}
    host["c_lat_sum"] = rng.random((3, 4)).astype(np.float32)
    assert JAX.telemetry.FLEET_POLL_KEYS == PORT.telemetry.FLEET_POLL_KEYS
    a, b = (ns.telemetry.fleet_counters(host) for ns in (JAX, PORT))
    for k in a:
        assert_bitwise(a[k], b[k], k)
    for ns_path in ("FUNCTION_CALL", "INLINE_NIC_TX", "INLINE_NIC_RX"):
        utils = []
        for ns in (JAX, PORT):
            link = _link(ns, 24.0, 48.0)
            for hint in ((), ((ns.RES_MEM_BW, 0.05, 0.3),)):
                spec = ns.FlowSpec(0, 0, getattr(ns.Path, ns_path), 0,
                                   ns.TrafficPattern(1500), ns.SLO.gbps(5.0),
                                   res_demand=hint)
                for acc in ("sha3_512", "aes256"):
                    utils.append(ns.telemetry.flow_axis_util(
                        spec, ns.CATALOG[acc], link, 7.3))
        half = len(utils) // 2
        assert utils[:half] == utils[half:]
        assert all(len(u) == 3 for u in utils)


def test_reshape_trace_matches_reference():
    """Oversized messages split into ``max_bytes`` chunks (header
    duplicated), in time order, as the reference's host-side helper."""
    rng = np.random.default_rng(1)
    t = np.sort(rng.integers(0, 10_000, (2, 40))).astype(np.int32)
    s = rng.integers(-5, 20_000, (2, 40)).astype(np.int32)
    for mx in (512, 4096, 50_000):
        a, b = jshaper.reshape_trace(t, s, mx), tshaper.reshape_trace(t, s,
                                                                      mx)
        for x, y in zip(a, b):
            assert_bitwise(x, y)
        assert b[1].max() <= mx and b[1].sum() == s[s > 0].sum()
