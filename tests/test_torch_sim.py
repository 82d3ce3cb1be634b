"""Port parity: ``repro_torch.core.sim`` (trace generation, stall masks,
result collection and ``simulate``) against the JAX package."""
import hashlib

import numpy as np
import pytest

from _torch_parity import assert_results_equal, port_cfg, port_flows
from repro.core import sim as jsim, token_bucket as jtb
from repro.core.accelerator import CATALOG, AccelTable
from repro.core.flow import SLO, FlowSet, FlowSpec, Path, TrafficPattern
from repro.core.interconnect import LinkSpec
from repro_torch.core import accelerator as tacc, interconnect as tic
from repro_torch.core import sim as tsim, token_bucket as ttb


def _specs():
    """The pinned-digest flows of tests/test_dataplane_sim.py."""
    return [
        FlowSpec(0, 0, Path.FUNCTION_CALL, 0,
                 TrafficPattern(1024, load=0.4, process="cbr"),
                 SLO.gbps(10)),
        FlowSpec(1, 1, Path.FUNCTION_CALL, 0,
                 TrafficPattern(512, load=0.3, process="poisson"),
                 SLO.gbps(10)),
        FlowSpec(2, 2, Path.INLINE_NIC_RX, 0,
                 TrafficPattern(1500, load=0.5, process="onoff",
                                burst_len=16, duty=0.25), SLO.gbps(10)),
        FlowSpec(3, 3, Path.FUNCTION_CALL, 0,
                 TrafficPattern(64, load=0.2, process="poisson",
                                msg_bytes2=4096, p2=0.1), SLO.gbps(10)),
    ]


def _digest(flows, cfg, seed, ref):
    t, s = tsim.gen_arrivals(flows, cfg, seed=seed, load_ref_gbps=ref)
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(t.astype("<i4")).tobytes())
    h.update(np.ascontiguousarray(s.astype("<i4")).tobytes())
    return t.shape, h.hexdigest()


def test_gen_arrivals_pinned_digests():
    """The port's traces carry the reference's pinned same-seed digests
    (tests/test_dataplane_sim.py), so both packages replay one trace."""
    flows = port_flows(FlowSet.build(_specs()))
    cfg = tsim.SimConfig(n_ticks=20_000)
    ref = {i: 32.0 for i in range(4)}
    assert _digest(flows, cfg, 0, ref) == (
        (4, 8017),
        "6995db131b1979ad07c8b260581ae6f05cd8bfb15dd09cb1d2c4c858607d888f")
    assert _digest(flows, cfg, 7, ref) == (
        (4, 7998),
        "5358b52f722082e07ecdfb6fe5b646702b6cb66139dfcd27dd237de11a6dbe84")
    one = port_flows(FlowSet.build([_specs()[1]]))
    assert _digest(one, cfg, 3, {0: 55.0}) == (
        (1, 2578),
        "f862ebb2590520bc81a7f119a3b3dba8edc7171e70755373f7bf8966a4d40cdd")


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_gen_arrivals_and_stall_mask_match_reference(seed):
    flows = FlowSet.build(_specs())
    cfg = jsim.SimConfig(n_ticks=5_000)
    ref = {i: 20.0 + seed for i in range(4)}
    jt, js = jsim.gen_arrivals(flows, cfg, seed=seed, load_ref_gbps=ref)
    tt, ts = tsim.gen_arrivals(port_flows(flows), port_cfg(cfg), seed=seed,
                               load_ref_gbps=ref)
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_array_equal(js, ts)
    kw = dict(seed=seed, stall_rate_hz=20_000.0, stall_us=(5.0, 50.0))
    np.testing.assert_array_equal(jsim.gen_stall_mask(cfg, **kw),
                                  tsim.gen_stall_mask(port_cfg(cfg), **kw))
    assert tsim.trace_budget(_specs()[2].pattern, 1e6, 1e-3) == \
        jsim.trace_budget(_specs()[2].pattern, 1e6, 1e-3)
    # the registry is process-global: a worker that imported
    # repro_torch.workloads for an earlier file also holds the workload set
    # (its full tuple is held against the reference's in
    # test_torch_workloads.py)
    names = tsim.registered_processes()
    assert names[:3] == ("cbr", "poisson", "onoff")
    assert names[3:] in ((), ("mmpp", "heavytail", "diurnal", "corrburst",
                              "flash", "adversarial")), names


def test_unknown_process_raises():
    spec = FlowSpec(0, 0, Path.FUNCTION_CALL, 0,
                    TrafficPattern(1024, process="nope"), SLO.gbps(1))
    with pytest.raises(ValueError, match="unknown arrival process"):
        tsim.gen_arrivals(port_flows(FlowSet.build([spec])),
                          tsim.SimConfig(n_ticks=100))


def test_simulate_result_matches_reference():
    """``simulate`` (counters recombined from the lo/hi byte split, the
    unrolled completion ring, seconds) equals the reference's, and a
    resumed second window too."""
    specs = [FlowSpec(i, i, Path.FUNCTION_CALL, 0,
                      TrafficPattern(1024, load=0.45, process="poisson"),
                      SLO.gbps(10.0 * (i + 1))) for i in range(2)]
    flows = FlowSet.build(specs)
    cfg = jsim.SimConfig(n_ticks=200)
    full = jsim.SimConfig(n_ticks=400)
    arr = jsim.gen_arrivals(flows, full, load_ref_gbps={0: 50.0, 1: 50.0})
    plans = [jtb.params_for_gbps(10.0), jtb.params_for_gbps(20.0)]
    jtab = AccelTable.build([CATALOG["synthetic50"]])
    ttab = tacc.AccelTable.build([tacc.CATALOG["synthetic50"]])
    r1, c1 = jsim.simulate(flows, jtab, LinkSpec(), cfg, jtb.pack(plans),
                           *arr, return_carry=True)
    t1, tc1 = tsim.simulate(port_flows(flows), ttab, tic.LinkSpec(),
                            port_cfg(cfg), ttb.pack(plans), *arr,
                            return_carry=True, device="cpu")
    assert_results_equal(r1, t1)
    r2 = jsim.simulate(flows, jtab, LinkSpec(), cfg, jtb.pack(plans), *arr,
                       t0_ticks=200, carry=c1)
    t2 = tsim.simulate(port_flows(flows), ttab, tic.LinkSpec(),
                       port_cfg(cfg), ttb.pack(plans), *arr, t0_ticks=200,
                       carry=tc1, device="cpu")
    assert_results_equal(r2, t2)
    assert t2.counters["c_done_msgs"].sum() > t1.counters["c_done_msgs"].sum()
    assert tsim.combine_byte_counters(np.array([3]), np.array([5]))[0] == \
        (3 << 20) + 5
