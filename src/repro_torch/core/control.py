"""Closed-loop shaping policies: WindowMetrics -> token-bucket plans.

The decision layer of the measurement -> policy -> actuation pipeline.
Arcus's shaping rates come from offline profiled capacities and only
change on admit/rebalance, so a mis-profiled or drifting tenant stays
wrong for its whole lifetime.  This module closes the loop bi-level
(Autothrottle-style): a cheap per-server fast tier nudges each tenant's
shaped rate every window toward its measured SLO slack, and a slow
global tier re-targets per-tenant budgets every K windows from the
placement layer's cached margins.

The contract with the controller:

* ``ControlPolicy.decide(window, servers)`` sees one ``ServerView`` per
  server — this window's ``WindowMetrics`` plus each rate-SLO tenant's
  profiled capacity ``Envelope`` — and returns per-server
  ``{flow_id: RatePlan}`` dicts (``None`` = hold that server steady).
* ``actuate`` turns plans into ``TBParams`` register values through the
  same ``params_for_gbps`` / ``params_for_iops`` path admission uses,
  and reports whether anything actually changed — an all-steady window
  keeps the controller's no-register-rewrite resume path.
* ``StaticHold`` decides nothing, computes nothing (not even
  envelopes): a ``StaticHold`` run is bitwise-identical to the
  pre-control-loop controller.

Every policy's plans are clamped to the profiled capacity envelope:
``floor`` is the rate the SLO requires (shaping below it would
manufacture violations), ``ceil`` the most the profiled capacity says
this tenant can take without stealing a co-tenant's SLO headroom.

Port of ``src/repro/core/control.py`` (pure Python, copied).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core import token_bucket as tb
from repro_torch.core.flow import SLOKind
from repro_torch.core.profiler import canonical_order
from repro_torch.core.shaper import reshape_decision
from repro_torch.core.telemetry import WindowMetrics


@dataclasses.dataclass(frozen=True)
class RatePlan:
    """One tenant's shaped-rate decision, in the flow's own SLO unit
    (Gbps or IOPS).  ``burst_scale`` scales the bucket depth relative to
    the planner's default — a fractional depth paces bursts smoothly
    without touching the long-run rate (the Fig. 9 lever)."""

    rate: float
    burst_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class Envelope:
    """Profiled clamp for one tenant's shaped rate (SLO units).
    ``floor`` = the SLO-required rate; ``ceil`` = floor plus the
    capacity headroom the profile says the tenant may absorb."""

    floor: float
    ceil: float

    def clamp(self, rate: float) -> float:
        return min(max(rate, self.floor), self.ceil)


@dataclasses.dataclass
class ServerView:
    """What a policy sees of one server for one window."""

    server: int
    window_s: float
    metrics: dict[int, WindowMetrics]
    envelopes: dict[int, Envelope]     # rate-SLO tenants only
    margin: float | None = None        # cached placement margin (ScoreCache)


class ControlPolicy:
    """Protocol for between-window shaping policies.

    ``needs_envelopes=False`` lets a policy opt out of envelope (and
    placement-margin) computation entirely — the controller then skips
    every profile lookup on its behalf."""

    name = "base"
    needs_envelopes = True

    def reset(self) -> None:
        """Forget per-run state; called at the start of every run."""

    def decide(self, window: int, servers: Sequence[ServerView]
               ) -> list[dict[int, RatePlan] | None]:
        raise NotImplementedError


class StaticHold(ControlPolicy):
    """Keep every register exactly as admission configured it — the
    pre-control-loop behaviour, bitwise (no envelope computation, no
    actuation, no extra profile lookups)."""

    name = "static-hold"
    needs_envelopes = False

    def decide(self, window: int, servers: Sequence[ServerView]
               ) -> list[dict[int, RatePlan] | None]:
        return [None] * len(servers)


class SlackAIMD(ControlPolicy):
    """Per-server fast tier: AIMD on each tenant's granted slack.

    Each rate-SLO tenant's shaped rate lives at ``floor + frac * (ceil -
    floor)`` of its envelope.  A clear window (no co-located SLO
    violation — rate or latency — and every tenant's slack above the
    ``guard`` band) additively raises every tenant's ``frac`` by ``ai``
    toward the profiled ceiling; a violated window multiplicatively
    decays the *granted slack* (``frac *= md``) and shrinks bucket depth
    by ``burst_md`` — the floor is the SLO-required rate, so decrease
    never shapes a tenant below its own SLO.  In between (nothing
    violated, but some tenant inside the guard band) the state holds:
    plans repeat, ``actuate`` reports no change, and the window keeps
    the no-register-rewrite resume path.  Bucket depth recovers
    additively on clear windows.  By construction the rate never leaves
    ``[floor, ceil]`` and increases monotonically on a violation-free
    comfortable trace."""

    name = "slack-aimd"

    def __init__(self, *, ai: float = 0.25, md: float = 0.5,
                 burst_md: float = 0.5, burst_min: float = 0.05,
                 burst_ai: float = 0.25, start_frac: float = 0.0,
                 guard: float = 0.1):
        if not 0.0 < md <= 1.0 or not 0.0 < burst_md <= 1.0:
            raise ValueError("md / burst_md must be in (0, 1]")
        self.ai = float(ai)
        self.md = float(md)
        self.burst_md = float(burst_md)
        self.burst_min = float(burst_min)
        self.burst_ai = float(burst_ai)
        self.start_frac = float(start_frac)
        self.guard = float(guard)
        self._state: dict[tuple[int, int], list[float]] = {}

    def reset(self) -> None:
        self._state.clear()

    def _decide_server(self, sv: ServerView,
                       envelopes: dict[int, Envelope]
                       ) -> dict[int, RatePlan] | None:
        if not envelopes:
            return None
        violated = any(m.violated for m in sv.metrics.values())
        slacks = [m.slack for m in sv.metrics.values()
                  if m.slack == m.slack]          # NaN-aware
        clear = (not violated
                 and (not slacks or min(slacks) > self.guard))
        plans: dict[int, RatePlan] = {}
        for fid, env in envelopes.items():
            st = self._state.setdefault((sv.server, fid),
                                        [self.start_frac, 1.0])
            if clear:
                st[0] = min(1.0, st[0] + self.ai)
                st[1] = min(1.0, st[1] + self.burst_ai)
            elif violated:
                st[0] *= self.md
                st[1] = max(self.burst_min, st[1] * self.burst_md)
            # guard band: hold the state — the plan repeats and the
            # window stays on the no-register-rewrite resume path
            rate = env.clamp(env.floor + st[0] * (env.ceil - env.floor))
            plans[fid] = RatePlan(rate=rate, burst_scale=st[1])
        return plans

    def decide(self, window: int, servers: Sequence[ServerView]
               ) -> list[dict[int, RatePlan] | None]:
        return [self._decide_server(sv, sv.envelopes) for sv in servers]


class GlobalRetarget(ControlPolicy):
    """Slow global tier wrapping a fast per-server policy.

    Every ``period`` windows it re-targets the per-tenant slack budget
    before delegating to the inner policy: each server's total grant
    range (``sum(ceil - floor)``) is re-divided across its tenants in
    proportion to observed need (``1 + violation streak``, weighted by
    measured shortfall), and the whole budget is scaled down when the
    placement layer's cached margin for the server is thin.  Re-targeted
    ceilings never exceed the profiled per-tenant ceiling, so the inner
    policy's envelope guarantee is preserved; between re-target windows
    the last computed ceilings stay in force."""

    name = "global-retarget"

    def __init__(self, inner: ControlPolicy | None = None, *,
                 period: int = 4, margin_floor: float = 0.05):
        self.inner = inner if inner is not None else SlackAIMD()
        self.period = max(int(period), 1)
        self.margin_floor = float(margin_floor)
        self._ceilings: dict[tuple[int, int], float] = {}

    def reset(self) -> None:
        self._ceilings.clear()
        self.inner.reset()

    def _retarget(self, sv: ServerView) -> None:
        envs = sv.envelopes
        if not envs:
            return
        budget = sum(e.ceil - e.floor for e in envs.values())
        if sv.margin is not None and sv.margin < self.margin_floor:
            # the placement layer thinks this server is tight: hand out
            # proportionally less of the profiled headroom
            budget *= max(sv.margin, 0.0) / self.margin_floor
        weights = {}
        for fid in envs:
            m = sv.metrics.get(fid)
            need = 1.0 + (m.streak if m is not None else 0)
            if m is not None and m.slack == m.slack and m.slack < 0:
                need += -m.slack
            weights[fid] = need
        total = sum(weights.values())
        for fid, env in envs.items():
            share = budget * weights[fid] / total if total > 0 else 0.0
            self._ceilings[(sv.server, fid)] = min(env.ceil,
                                                   env.floor + share)

    def decide(self, window: int, servers: Sequence[ServerView]
               ) -> list[dict[int, RatePlan] | None]:
        if window % self.period == 0:
            for sv in servers:
                self._retarget(sv)
        shaped = []
        for sv in servers:
            envs = {fid: dataclasses.replace(
                        env, ceil=max(env.floor,
                                      self._ceilings.get((sv.server, fid),
                                                         env.ceil)))
                    for fid, env in sv.envelopes.items()}
            shaped.append(dataclasses.replace(sv, envelopes=envs))
        return self.inner.decide(window, shaped)


# ---------------------------------------------------------------------------
# Capacity envelopes (the profiled clamp)
# ---------------------------------------------------------------------------


def capacity_envelopes(rt) -> dict[int, Envelope]:
    """Per-tenant shaped-rate envelopes from the server's ProfileTable.

    For every accelerator group the current context's ``CapacityEntry``
    (a cache hit when admission pre-warmed it) yields each rate-SLO
    tenant's headroom: the Gbps it could additionally absorb without
    violating any capacity axis — the aggregate link capacity, its own
    contention ceiling (``n * per_flow``), and every extra shaped
    resource axis through the tenant's demand coefficient.  Converted to
    the flow's SLO unit: ``Envelope(floor=slo_rate, ceil=floor +
    headroom)``."""
    out: dict[int, Envelope] = {}
    by_accel: dict[int, list] = {}
    for fid in sorted(rt.table):
        by_accel.setdefault(rt.table[fid].spec.accel_id, []).append(fid)
    margin = 0.02
    for a, fids in by_accel.items():
        accel = rt.accel_specs[a]
        peers = [rt.table[f].spec for f in fids]
        ctx = [(s.path, s.pattern.msg_bytes, s.pattern.load)
               + ((s.res_demand,) if s.res_demand else ())
               for s in peers]
        entry = rt.profile.capacity(accel, ctx)
        order = canonical_order(ctx)
        slo_gbps = [rt._slo_gbps(peers[i]) for i in order]
        pos_of = {order[j]: j for j in range(len(order))}
        agg_head = entry.capacity[0] * (1 - margin) - sum(slo_gbps)
        for i, fid in enumerate(fids):
            spec = peers[i]
            if spec.slo.kind == SLOKind.LATENCY:
                continue
            j = pos_of[i]
            n = len(entry.per_flow[0])
            head = max(agg_head, 0.0)
            if n == len(slo_gbps) and j < n:
                ceil_i = n * entry.per_flow[0][j] * (1 - margin)
                head = min(head, max(ceil_i - slo_gbps[j], 0.0))
            for r in range(1, len(entry.capacity)):
                coefs = entry.per_flow[r]
                coef = (coefs[j] if n and len(slo_gbps) == len(coefs)
                        else max(coefs, default=1.0))
                lim = entry.capacity[r] * (1 - margin)
                head_r = lim - entry._axis_demand(r, slo_gbps)
                head = min(head, max(head_r, 0.0) / max(coef, 1e-12))
            floor = float(spec.slo.target)
            if spec.slo.kind == SLOKind.IOPS:
                head = head * 1e9 / (8 * max(spec.pattern.msg_bytes, 1))
            out[fid] = Envelope(floor=floor, ceil=floor + max(head, 0.0))
    return out


# ---------------------------------------------------------------------------
# Actuation: RatePlan -> TBParams register values
# ---------------------------------------------------------------------------


def plan_params(rt, st, plan: RatePlan) -> tb.TBParams:
    """Token-bucket registers realizing a plan — the exact
    ``reshape_decision`` planner admission uses (with the plan's rate as
    the SLO target), so an adaptive rate at the envelope floor
    reproduces admission's registers bit-for-bit, message splitting
    included.  ``burst_scale`` then shrinks/keeps the bucket depth,
    clamped so one refill quantum (and one message, in Gbps mode)
    always fits."""
    spec = st.spec
    decision = reshape_decision(
        rt.accel_specs[spec.accel_id],
        dataclasses.replace(spec.slo, target=plan.rate),
        spec.pattern.msg_bytes, clock_hz=rt.clock_hz)
    params = decision.params
    if plan.burst_scale != 1.0:
        min_bkt = (1 if spec.slo.kind == SLOKind.IOPS
                   else spec.pattern.msg_bytes)
        bkt = int(round(params.bkt_size * plan.burst_scale))
        params = dataclasses.replace(
            params, bkt_size=max(bkt, params.refill_rate, min_bkt))
    return params


def actuate(rt, plans: dict[int, RatePlan]) -> bool:
    """Commit one server's plans to its PerFlowStatusTable registers.

    Returns True iff some register value actually changed — the
    controller re-packs (and rewrites) that server's TBState next window
    only then, so policies that hold steady keep the
    no-register-rewrite resume path."""
    changed = False
    for fid, plan in plans.items():
        st = rt.table.get(fid)
        if st is None or st.spec.slo.kind == SLOKind.LATENCY:
            continue
        params = plan_params(rt, st, plan)
        if params != st.params:
            st.params = params
            st.reconfigs += 1
            changed = True
    return changed
