"""Port parity of fleet admission placement
(``repro_torch.core.placement`` through ``FleetController.place``) against
the JAX package: the three policies (first fit, best fit, SLO-aware, and
SLO-aware scoring one axis) on the same fleet and tenant stream, the
contention benchmark's three control planes on a two-axis link at a small
scale, the score cache's reuse, and the policies' selection rules on
hand-built candidates.  Placements, profiling and score-cache counters,
controller ``stats`` and lane maps are compared exactly."""
import dataclasses

import numpy as np
import pytest

from _fleet_parity import JAX, PORT, placements
from _torch_parity import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: beside the other test processes a pool of
    threads spin-waits (``_torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


PROFILE_TICKS = 100
COMPLEMENTS = (["synthetic50"], ["synthetic50", "aes256"], ["aes256"])
POLICIES = {"first_fit": lambda ns: ns.placement.FirstFit(),
            "best_fit": lambda ns: ns.placement.BestFit(),
            "slo_aware": lambda ns: ns.placement.SLOAware()}


def _stream(ns):
    """Six tenants naming their accelerator, SLOs 4-40 Gbps (some fit
    nowhere), message sizes 512-4096 B."""
    names = ("synthetic50", "aes256")
    return [ns.FlowSpec(i, i, ns.Path.FUNCTION_CALL, 0,
                        ns.TrafficPattern(512 << (i % 4), load=0.4,
                                          process="poisson"),
                        ns.SLO.gbps((4.0, 12.0, 40.0, 8.0)[i % 4]))
            for i in range(6)], [names[i % 2] for i in range(6)]


def _place(ns, profile, policy):
    rts = [ns.ArcusRuntime([ns.CATALOG[n] for n in names],
                           profile_table=profile) for names in COMPLEMENTS]
    ctrl = ns.FleetController(rts)
    specs, names = _stream(ns)
    p0 = ns.profiler.profiling_stats()
    placed = ctrl.place(specs, policy=POLICIES[policy](ns),
                        accel_names=names)
    p1 = ns.profiler.profiling_stats()
    return dict(placed=placements(placed),
                profiling={k: p1[k] - p0[k] for k in p1},
                stats=dict(ctrl.stats),
                lanes=[ctrl.lane_map(b) for b in range(len(rts))],
                keys=[ns.placement.server_key(rt) for rt in rts])


@pytest.fixture(scope="module")
def policy_runs():
    out = {}
    for ns in (JAX, PORT):
        profile = ns.ProfileTable(n_ticks=PROFILE_TICKS)
        for policy in POLICIES:
            out[(id(ns), policy)] = _place(ns, profile, policy)
    return out


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_policy_placements_match_reference(policy, policy_runs):
    """Each policy lands (or rejects) every tenant as the reference does,
    with the same candidate counts, profiling batches, score-cache hits
    and misses, controller stats and lane layouts."""
    ref, port = policy_runs[(id(JAX), policy)], policy_runs[(id(PORT), policy)]
    assert ref == port
    assert port["stats"]["admitted"] + port["stats"]["rejected"] == 6


def test_policies_differ_where_scores_differ(policy_runs):
    """First fit stacks tenants on the first feasible server; the scoring
    policies spread them."""
    def servers(policy):
        return [p[1] for p in policy_runs[(id(PORT), policy)]["placed"]]
    assert servers("first_fit") != servers("slo_aware")
    assert servers("best_fit") != servers("slo_aware")


# --- the contention benchmark's control planes, small ----------------------------

ARMS = ("vector", "axis0", "mem_blind")


def _contention(ns, arm):
    """``benchmarks/contention.py``'s three control planes at a small
    scale: two servers of ``synthetic50``, four interleaved 5 Gbps
    tenants (odd ones with the 0.05 memory hint), links with
    ``mem_bw(24)`` and ``host_dma(48)`` (the memory-blind plane profiles
    and scores the link alone)."""
    link = (ns.LinkSpec() if arm == "mem_blind" else ns.LinkSpec(
        resources=(ns.mem_bw(24.0), ns.host_dma(48.0))))
    profile = ns.ProfileTable(link, n_ticks=PROFILE_TICKS)
    rts = [ns.ArcusRuntime([ns.CATALOG["synthetic50"]], link=link,
                           profile_table=profile) for _ in range(2)]
    pol = (ns.placement.SLOAware(axis=0) if arm == "axis0"
           else ns.placement.SLOAware())
    specs = [ns.FlowSpec(i, i, ns.Path.FUNCTION_CALL, 0,
                         ns.TrafficPattern(1024, load=0.5,
                                           process="poisson"),
                         ns.SLO.gbps(5.0),
                         res_demand=() if i % 2 == 0
                         else ((ns.RES_MEM_BW, 0.05, 0.05),))
             for i in range(4)]
    p0 = ns.profiler.profiling_stats()
    placed = ns.FleetController(rts).place(specs, policy=pol)
    p1 = ns.profiler.profiling_stats()
    entries = {k: dataclasses.asdict(v) for k, v in profile.entries.items()}
    return placements(placed), entries, {k: p1[k] - p0[k] for k in p1}


@pytest.mark.parametrize("arm", ARMS)
def test_contention_arms_match_reference(arm):
    """Vector scoring, axis-0 scoring and the memory-blind plane place the
    stream as the reference's, from the same per-axis profiled entries,
    profiling batches and score-cache reuse; the memory-blind plane stacks
    the two bandwidth-bound tenants on one server (beyond its memory
    axis), the vector-aware planes do not."""
    ref, port = _contention(JAX, arm), _contention(PORT, arm)
    assert ref == port
    # the vector planes' third round re-scores server 0 from the cache
    assert port[2]["score_hits"] == (arm != "mem_blind")
    bw_servers = [p[1] for p in port[0] if p[5] % 2 == 0]
    assert (len(set(bw_servers)) == 1) == (arm == "mem_blind")


# --- selection rules on hand-built candidates -------------------------------------


def _candidates(ns, rng, n):
    entry = ns.profiler.CapacityEntry(50.0, [50.0], 1.0)
    spec = ns.FlowSpec(0, 0, ns.Path.FUNCTION_CALL, 0,
                       ns.TrafficPattern(1024), ns.SLO.gbps(1.0))
    out = []
    for i in range(n):
        m = tuple(float(v) for v in rng.choice([-0.2, 0.1, 0.3, 0.5], 2))
        out.append(ns.placement.Candidate(
            server=int(rng.integers(0, 4)), accel_id=int(rng.integers(0, 2)),
            spec=spec, entry=entry, slo_gbps=(1.0,),
            feasible=bool(rng.random() < 0.7), margin=min(m),
            residual=float(rng.choice([1.0, 2.5, 2.5, 7.0])),
            server_key=(("a",) if rng.random() < 0.5 else ("b",),
                        (int(rng.integers(0, 3)),)),
            margin_res=m if rng.random() < 0.8 else ()))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_selection_rules_match_reference(seed):
    """On random candidate sets (ties in scores and server keys, some
    infeasible, some without per-axis margins) every policy selects the
    reference's candidate."""
    for trial in range(25):
        picks = []
        for ns in (JAX, PORT):
            cands = _candidates(ns, np.random.default_rng(
                1000 * seed + trial), 6)
            pols = [ns.placement.FirstFit(), ns.placement.BestFit(),
                    ns.placement.SLOAware(), ns.placement.SLOAware(axis=0),
                    ns.placement.SLOAware(axis=1)]
            picks.append([None if c is None else cands.index(c) for c in
                          (p.select(cands) for p in pols)])
        assert picks[0] == picks[1]
    assert sorted(PORT.placement.POLICIES) == sorted(JAX.placement.POLICIES)
