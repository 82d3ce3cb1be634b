"""Port parity of the production-shaped generators
(``repro_torch.workloads.generators``) against the JAX package's: the
arrival-process registry after import, its errors, every generator's
same-seed traces (bitwise, and the reference's pinned digests), the
budget factors that size the trace matrix, and a mixed flow set through
``gen_arrivals`` (which checks the order in which the handlers draw from
the shared rng)."""
import hashlib

import numpy as np
import pytest

import repro.workloads  # noqa: F401 (registers the reference's processes)
import repro_torch.workloads  # noqa: F401 (registers the port's processes)
from _torch_parity import port_flows
from repro.core import sim as jsim
from repro.core.flow import SLO, FlowSet, FlowSpec, Path, TrafficPattern
from repro.workloads import generators as jgen
from repro_torch.core import flow as tflow, sim as tsim
from repro_torch.workloads import generators as tgen

TICKS = 20_000            # 640 us at the default 8 cycles a tick
HORIZON_S = TICKS * 8 / 250e6
WORKLOAD_PROCESSES = ("mmpp", "heavytail", "diurnal", "corrburst", "flash",
                      "adversarial")


def _patterns(ns) -> list:
    """tests/test_workloads.py's seven digest patterns, built with the
    flow module ``ns`` of either package."""
    TP = ns.TrafficPattern
    return [
        TP(1024, load=0.3, process="mmpp", params=(("states", (0.25, 2.5)),)),
        TP(1024, load=0.3, process="heavytail",
           params=(("dist", "pareto"), ("alpha", 1.5))),
        TP(1024, load=0.3, process="heavytail",
           params=(("dist", "lognormal"), ("sigma", 1.0))),
        TP(1024, load=0.3, process="diurnal", params=(("amp", 0.8),)),
        TP(1024, load=0.3, process="corrburst",
           params=(("group", 3), ("burst_hz", 50_000.0), ("burst_len", 8))),
        TP(1024, load=0.3, process="flash", params=(("at", 0.3),
                                                    ("mult", 6.0))),
        TP(1024, rate_mps=5e5, process="adversarial",
           params=(("bucket_bytes", 32 * 1024), ("period_s", 96e-6))),
    ]


class _Ref:
    TrafficPattern = TrafficPattern


JAX_PATTERNS = _patterns(_Ref)
PORT_PATTERNS = _patterns(tflow)
#: tests/test_workloads.py:111-117
PINNED = {
    0: ((7, 1234), "33ac781cceab741f6556bb9abf959eae"
                   "1e31d1569ef644ffacc6c2b79b39f2fd"),
    7: ((7, 1208), "8dee228bcdd48e4da05bf65add80d9a7"
                   "b9b1923cbf36aa8066d58550248fd4a6")}


def _digest(t, s):
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(t.astype("<i4")).tobytes())
    h.update(np.ascontiguousarray(s.astype("<i4")).tobytes())
    return t.shape, h.hexdigest()


# --- the registry ------------------------------------------------------------


def test_import_registers_the_reference_order():
    """The port's registry after ``import repro_torch.workloads`` is the
    reference's after ``import repro.workloads``: the built-ins, then the
    workload set, in the order ``gen_arrivals`` runs the handlers."""
    names = tsim.registered_processes()
    assert names == ("cbr", "poisson", "onoff") + WORKLOAD_PROCESSES
    # tests/test_workloads.py registers a throwaway process into the
    # reference's registry for good: compare the names both hold
    assert jsim.registered_processes()[:len(names)] == names


def test_register_process_duplicate_raises(monkeypatch):
    """Re-registering a name raises unless ``replace`` is set; the
    throwaway registration lives in a copy of the registry, undone after
    the test (the registry is process-global)."""
    monkeypatch.setattr(tsim, "_PROCESSES", dict(tsim._PROCESSES))

    def gaps(pats, rates, rng, M0, horizon_s):
        return np.full((len(pats), M0), 1.0)
    tsim.register_process("__testproc__", gaps)
    assert tsim.registered_processes()[-1] == "__testproc__"
    with pytest.raises(ValueError, match="already registered"):
        tsim.register_process("__testproc__", gaps)
    with pytest.raises(ValueError, match="already registered"):
        tsim.register_process("mmpp", gaps)
    tsim.register_process("__testproc__", gaps, replace=True)


def test_unknown_process_error_names_the_workload_package():
    spec = tflow.FlowSpec(0, 0, tflow.Path.FUNCTION_CALL, 0,
                          tflow.TrafficPattern(1024, load=0.3,
                                               process="nope"),
                          tflow.SLO.gbps(10))
    with pytest.raises(ValueError, match="unknown arrival process") as e:
        tsim.gen_arrivals(tflow.FlowSet.build([spec]),
                          tsim.SimConfig(n_ticks=1000))
    msg = str(e.value)
    for want in ("mmpp", "adversarial",
                 "repro_torch.core.sim.register_process",
                 "repro_torch.workloads.generators"):
        assert want in msg, msg


# --- the generators ----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_make_trace_pinned_digests(seed):
    """The seven patterns together carry the reference's pinned digests."""
    assert _digest(*tgen.make_trace(PORT_PATTERNS, n_ticks=TICKS,
                                    seed=seed)) == PINNED[seed]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("i", range(len(JAX_PATTERNS)))
def test_make_trace_matches_reference(i, seed):
    """Each pattern alone: the port's trace equals the reference's."""
    jt, js = jgen.make_trace(JAX_PATTERNS[i], n_ticks=TICKS, seed=seed)
    tt, ts = tgen.make_trace(PORT_PATTERNS[i], n_ticks=TICKS, seed=seed)
    assert tt.dtype == np.int32 and ts.dtype == np.int32
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_array_equal(js, ts)


@pytest.mark.parametrize("i", range(len(JAX_PATTERNS)))
def test_budget_factors_match_reference(i):
    """The burst factor each process claims (which sizes the trace
    matrix, and the controller's mid-run reservation) equals the
    reference's, at the pattern's rate and at a slower one."""
    jp, tp = JAX_PATTERNS[i], PORT_PATTERNS[i]
    jproc = jsim._PROCESSES[jp.process]
    tproc = tsim._PROCESSES[tp.process]
    for rate in (jp.rate_msgs_per_sec(32.0), 1e4):
        assert tproc.budget_factor(tp, rate, HORIZON_S) == \
            jproc.budget_factor(jp, rate, HORIZON_S)
        assert tsim.trace_budget(tp, rate, HORIZON_S) == \
            jsim.trace_budget(jp, rate, HORIZON_S)


@pytest.mark.parametrize("dist, knob, match", [
    ("pareto", ("alpha", 1.0), "alpha > 1"),
    ("weibull", ("alpha", 1.5), "unknown heavytail dist")])
def test_heavytail_rejects_like_reference(dist, knob, match):
    for gen, TP in ((jgen, TrafficPattern), (tgen, tflow.TrafficPattern)):
        pat = TP(1024, load=0.3, process="heavytail",
                 params=(("dist", dist), knob))
        with pytest.raises(ValueError, match=match):
            gen.make_trace(pat, n_ticks=2_000)


def _mixed_specs():
    """Built-in and workload processes interleaved (not in registry
    order), a bimodal flow among them, and two corrburst flows of one
    group: the handlers' draws interleave on one rng."""
    pats = [
        TrafficPattern(512, load=0.3, process="flash",
                       params=(("at", 0.5), ("mult", 4.0))),
        TrafficPattern(1024, load=0.2, process="poisson"),
        TrafficPattern(2048, load=0.2, process="heavytail",
                       params=(("dist", "lognormal"), ("sigma", 1.2),
                               ("max_bytes", 128 * 1024))),
        TrafficPattern(1500, load=0.4, process="onoff", burst_len=16,
                       duty=0.25),
        TrafficPattern(1024, load=0.25, process="corrburst",
                       params=(("group", 7), ("burst_hz", 40_000.0),
                               ("burst_len", 16))),
        TrafficPattern(64, load=0.2, process="mmpp", msg_bytes2=4096,
                       p2=0.1, params=(("states", (0.5, 1.0, 3.0)),
                                       ("sojourn_s", 50e-6))),
        TrafficPattern(1024, load=0.2, process="diurnal",
                       params=(("amp", 0.9), ("phase", 0.5))),
        TrafficPattern(1024, load=0.3, process="cbr"),
        TrafficPattern(1024, load=0.25, process="corrburst",
                       params=(("group", 7), ("burst_hz", 40_000.0),
                               ("burst_len", 16))),
        TrafficPattern(1024, rate_mps=4e5, process="adversarial",
                       params=(("bucket_bytes", 16 * 1024),
                               ("period_s", 64e-6), ("phase_s", 3e-6))),
        TrafficPattern(1024, load=0.2, process="heavytail",
                       params=(("dist", "pareto"), ("alpha", 1.4),
                               ("max_bytes", 128 * 1024))),
    ]
    return [FlowSpec(i, i, Path.FUNCTION_CALL, 0, p, SLO.gbps(5.0))
            for i, p in enumerate(pats)]


@pytest.mark.parametrize("seed", [3, 11])
def test_mixed_flow_set_matches_reference(seed):
    flows = FlowSet.build(_mixed_specs())
    cfg = jsim.SimConfig(n_ticks=6_000)
    ref = {i: 20.0 + i for i in range(flows.n)}
    jt, js = jsim.gen_arrivals(flows, cfg, seed=seed, load_ref_gbps=ref)
    tt, ts = tsim.gen_arrivals(port_flows(flows),
                               tsim.SimConfig(n_ticks=6_000), seed=seed,
                               load_ref_gbps=ref)
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_array_equal(js, ts)
    # the heavy-tailed rows drew sizes well past their 1-2 KiB means
    assert int(ts[[2, 10]].max()) > 8 * 1024
