"""Fleet admission placement — CapacityPlanning lifted fleet-wide.

Arcus's CapacityPlanning (Sec. 3.3, 4.3) admits a flow only if the
profiled Capacity(t, X, N) context of the target accelerator stays
SLO-Friendly.  Run per client server that is a *local* decision: the
caller pre-picks a server, and a flow rejected on a loaded server dies
even when a sibling server has profiled headroom — the coordination gap
"SLO beyond the Hardware Isolation Limits" describes when per-device
isolation is managed in isolation.

This module closes the gap with a pluggable *placement* layer: a
``PlacementPolicy`` ranks the fleet-wide candidate set (every compatible
(server, accelerator) pair, each carrying its profiled would-be context),
and ``runtime.place_fleet`` drives one admission round per tenant,
batching the whole round's cross-server candidate profiling into ONE
``profiler.profile_contexts_multi`` engine call.

Policies (all deterministic):

* ``FirstFit``    — first feasible candidate in (server, accelerator)
                    enumeration order.  Pinned to a fixed server it
                    reproduces per-server ``register_fleet`` decisions
                    exactly (the parity contract).
* ``BestFit``     — feasible candidate with the smallest post-admission
                    residual capacity (tightest fit: keeps the largest
                    holes open for future large tenants).
* ``SLOAware``    — feasible candidate maximizing the post-admission
                    ``slo_tag`` margin (distance of the would-be context
                    from its nearest capacity/ceiling constraint) — it
                    shops every server's accelerator complement and lands
                    the tenant where the fleet keeps the most SLO slack.

For the scoring policies (``BestFit``, ``SLOAware``) ties break on a
*canonical server key* (accelerator complement + registered flow ids),
not the presentation index, so a permuted ``runtimes`` sequence places
every tenant on the same physical server (only true clones — identical
complement AND identical registered set — fall back to presentation
order).  ``FirstFit`` is deterministic for a *given* server order but,
by definition, follows that order — permuting the fleet permutes its
picks.

Port of ``src/repro/core/placement.py`` (pure Python, copied).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import profiler
from repro_torch.core.flow import FlowSpec
from repro_torch.core.profiler import CapacityEntry


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One (server, accelerator) landing option for a tenant, with the
    profiled would-be context it creates."""

    server: int                    # index into the runtimes sequence
    accel_id: int                  # accelerator index on that server
    spec: FlowSpec                 # tenant spec rebound to accel_id
    entry: CapacityEntry           # profiled post-admission context
    slo_gbps: tuple[float, ...]    # canonical-order SLO vector (w/ tenant)
    feasible: bool                 # entry.slo_tag(slo_gbps)
    margin: float                  # entry.slo_margin(slo_gbps) — min axis
    residual: float                # entry.residual_gbps(slo_gbps)
    server_key: tuple              # canonical tie-break identity
    # per-resource-axis margins (entry.slo_margins; axis 0 = link).  Empty
    # for hand-built candidates — axis-scoring policies fall back to the
    # scalar margin then.
    margin_res: tuple = ()


@dataclasses.dataclass
class Placement:
    """Outcome of one admission round, aligned with ``place_fleet``'s
    input specs."""

    spec: FlowSpec
    server: int | None             # None = rejected fleet-wide
    accel_id: int | None
    accepted: bool
    n_candidates: int
    n_feasible: int


def server_key(runtime) -> tuple:
    """Canonical identity of a server for policy tie-breaks: accelerator
    complement (ordered — it defines accel ids) plus the registered flow
    ids.  Invariant under permutation of the ``runtimes`` sequence."""
    return (tuple(a.name for a in runtime.accel_specs),
            tuple(sorted(runtime.table)))


class PlacementPolicy:
    """Chooses where (if anywhere) a tenant lands, given the profiled
    fleet-wide candidate set of one admission round.

    ``select`` sees every candidate — feasible or not — in (server,
    accelerator) enumeration order and returns the winner or ``None``
    (reject).  Implementations must be deterministic functions of the
    candidate set; use ``_tie_key`` so equal scores resolve by canonical
    server identity rather than presentation order."""

    name = "base"

    def select(self, candidates: list[Candidate]) -> Candidate | None:
        raise NotImplementedError

    @staticmethod
    def _tie_key(c: Candidate) -> tuple:
        return (c.server_key, c.accel_id, c.server)


class FirstFit(PlacementPolicy):
    """First feasible candidate in enumeration order.  With ``pinned``
    servers this is exactly today's per-server admission."""

    name = "first_fit"

    def select(self, candidates: list[Candidate]) -> Candidate | None:
        for c in candidates:
            if c.feasible:
                return c
        return None


class BestFit(PlacementPolicy):
    """Smallest post-admission residual capacity among feasible
    candidates (classic best-fit packing on the profiled capacities)."""

    name = "best_fit"

    def select(self, candidates: list[Candidate]) -> Candidate | None:
        feasible = [c for c in candidates if c.feasible]
        if not feasible:
            return None
        return min(feasible, key=lambda c: (c.residual, self._tie_key(c)))


class SLOAware(PlacementPolicy):
    """Largest post-admission ``slo_tag`` margin among feasible
    candidates: the landing spot whose would-be context keeps the most
    normalized headroom to its nearest constraint (aggregate capacity or
    a per-flow contention ceiling).

    By default the score is the *vector* margin — the min over every
    resource axis — so a bandwidth-bound tenant steers away from a
    memory-saturated server and vice versa.  ``axis=<r>`` scores one
    axis' margin only (feasibility stays vector-checked): ``axis=0`` is
    exactly the pre-vector scalar policy, the comparison baseline
    ``benchmarks/contention.py`` measures the vector gain against."""

    name = "slo_aware"

    def __init__(self, axis: int | None = None):
        self.axis = axis
        if axis is not None:
            self.name = f"slo_aware_axis{axis}"

    def _score(self, c: Candidate) -> float:
        if self.axis is not None and len(c.margin_res) > self.axis:
            return c.margin_res[self.axis]
        return c.margin

    def select(self, candidates: list[Candidate]) -> Candidate | None:
        feasible = [c for c in candidates if c.feasible]
        if not feasible:
            return None
        return min(feasible,
                   key=lambda c: (-self._score(c), self._tie_key(c)))


POLICIES = {p.name: p for p in (FirstFit, BestFit, SLOAware)}


def _score_sig(spec: FlowSpec) -> tuple:
    """Scoring-relevant identity of a candidate spec.

    A candidate's score — profiled entry, canonical SLO vector, margin,
    residual, feasibility — is a function of the would-be context, which
    sees only (path, traffic pattern, SLO); flow/vm ids never enter it.
    Keying on this signature lets a homogeneous tenant stream (same
    shape, different ids) reuse scores round over round.  The
    resource-demand hint re-keys the would-be context (and its margins),
    so it is part of the identity."""
    return (int(spec.path), spec.pattern, spec.slo, spec.res_demand)


class ScoreCache:
    """Stateful candidate scorer: reuse prior-round margins for servers
    whose tables did not change.

    Placement used to re-score every admission round from scratch, even
    though a round changes exactly ONE server (the winner's
    PerFlowStatusTable grows by one tenant, re-keying its would-be
    contexts) — every other server's candidates for a same-shaped spec
    are bit-for-bit the previous round's.  The cache keys the scoring
    fields on (server, accelerator, ``_score_sig(spec)``) and guards them
    with the runtime's ``lifecycle_version`` (bumped by ``register`` /
    ``deregister``): a hit replays the stored floats into a fresh
    ``Candidate`` for the current spec — same margins, same decision —
    and skips rebuilding + profiling the context entirely; a registration
    or departure on a server invalidates only that server's entries.

    ``runtime.place_fleet`` / ``FleetController.place`` thread the
    controller's long-lived cache through their rounds by default; pass
    your own instance to share scores across call sites.  Hit/miss counts
    are exposed via ``profiler.profiling_stats()`` (``score_hits`` /
    ``score_misses``)."""

    def __init__(self):
        self._scores: dict[tuple, tuple[int, tuple]] = {}

    def lookup(self, runtime, server: int, accel_id: int,
               spec: FlowSpec) -> Candidate | None:
        hit = self._scores.get((server, accel_id, _score_sig(spec)))
        # the guard binds the entry to the exact runtime (its
        # process-unique _uid — id() could be reused after gc) AND its
        # membership version: a cache shared across different fleets (or
        # a rebuilt fleet reusing server indices) must never replay
        # another runtime's margins
        if hit is not None and hit[0] == (getattr(runtime, "_uid",
                                                  id(runtime)),
                                          runtime.lifecycle_version):
            profiler._PROFILING_STATS["score_hits"] += 1
            entry, slo, ok, margin, residual, skey, margin_res = hit[1]
            return Candidate(server=server, accel_id=accel_id, spec=spec,
                             entry=entry, slo_gbps=slo, feasible=ok,
                             margin=margin, residual=residual,
                             server_key=skey, margin_res=margin_res)
        profiler._PROFILING_STATS["score_misses"] += 1
        return None

    def store(self, runtime, server: int, accel_id: int, spec: FlowSpec,
              c: Candidate) -> None:
        self._scores[(server, accel_id, _score_sig(spec))] = (
            (getattr(runtime, "_uid", id(runtime)),
             runtime.lifecycle_version),
            (c.entry, c.slo_gbps, c.feasible, c.margin, c.residual,
             c.server_key, c.margin_res))

    def server_margin(self, server: int) -> float | None:
        """Worst cached SLO-aware margin among a server's scored
        candidates (``None`` when the server has none) — an advisory
        tightness signal for the slow control tier
        (``control.GlobalRetarget``): it intentionally ignores the
        version guard, since even a slightly stale margin says more
        about a server's headroom than no signal at all."""
        margins = [vals[3] for key, (_guard, vals) in self._scores.items()
                   if key[0] == server]
        return min(margins) if margins else None

    def clear(self) -> None:
        self._scores.clear()
