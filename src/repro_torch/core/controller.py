"""Tenant-lifecycle control plane: one ``FleetController`` surface for
admit / depart / rebalance over churn timelines.

Port of ``src/repro/core/controller.py`` on the port's batched engine: the
fleet's dataplanes run as one ``engine.run_window_batch`` batch on the
runtimes' device (one grant-tick launch a tick, one CTA a server; on the
card every window replays the batch entry's CUDA graph of one tick).
Where the reference writes of a compiled engine entry and a donated carry,
the port has a compile-cache entry (``engine._RUN_CACHE``) and a carry
updated in place; where it fetches with ``jax.device_get``, the port makes
one host copy of the window's ``telemetry.FLEET_POLL_KEYS``.  Event splices
write the committed ``[B, width, M]`` trace tensors in place, so a window
without events copies no trace into the entry's buffers.  Decisions,
counters and reports are bitwise the reference's.

Arcus's Algorithm 1 manages SLOs *continuously* as tenants come and go,
but the repo's control plane historically only grew: ``register``,
``register_fleet``, ``place_fleet``, ``run_managed`` and
``run_managed_batch`` accreted as separate entry points, and tenant
*departure* / re-balancing did not exist at all.  This module redesigns
the API around the tenant lifecycle:

* ``admit(spec)`` / ``place(specs)`` — cross-server SLO-aware admission:
  each round profiles the tenant's whole fleet-wide candidate set through
  ONE batched ``profiler.profile_contexts_multi`` engine call and a
  ``placement.PlacementPolicy`` picks the landing server.  A stateful
  ``placement.ScoreCache`` carries candidate margins between rounds, so
  servers whose tables did not change are not re-scored from scratch.
* ``depart(tenant_id)`` — deregistration.  The tenant's padded dataplane
  lane goes inert via ``fl_mask`` (a *traced* engine argument): shapes
  never change, so a live run — and the engine cache entry shared by
  later runs — survives without recompiling.  Lane layouts re-pack
  (compact their holes, changing shapes and paying one new cache entry) only
  when fragmentation crosses ``repack_threshold``, and only between runs.
* ``rebalance()`` — migrate admitted tenants onto freed capacity: each
  tenant is transiently deregistered and re-scored fleet-wide with
  SLO-aware margins (ScoreCache reuses every untouched server's scores);
  it moves only when another server offers strictly more margin.
* ``run(total_ticks, window_ticks, events=[TenantEvent(...)])`` — the
  fleet's batched Algorithm 1 loop (the former ``run_managed_batch``
  internals): B servers' dataplanes run as one batch on a carry updated
  in place, and ARRIVE / DEPART events apply at window boundaries — an
  arriving tenant is placed, registered and handed a fresh lane (its
  arrival trace spliced into the committed device buffers); a departing
  tenant's lane is flushed and masked.  All of it on the same engine
  cache entry, with the rebuild-skip path untouched: a window after which
  nothing changed resumes the carry with no register rewrite.

The between-window path is an explicit measurement -> policy ->
actuation pipeline: ``repro_torch.core.telemetry`` turns the window's
counter deltas into per-tenant ``WindowMetrics``, a
``repro_torch.core.control`` ``ControlPolicy`` (the ``control=``
constructor argument) turns metrics
into shaped-rate plans clamped to profiled capacity envelopes, and
``control.actuate`` commits plans as token-bucket register values
through the existing per-server re-pack path.  The default policy is
``StaticHold`` — decisions and registers bitwise-identical to the
pre-pipeline controller.

Parity contract: with a static tenant set (no events) ``run`` is
bit-for-bit the old ``run_managed_batch`` — counters, WindowReports and
post-run control state equal B serial ``run_managed`` calls — and the
old entry points remain as deprecation shims delegating here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import control as ctl
from repro_torch.core import engine, placement, sim, telemetry
from repro_torch.core import token_bucket as tb
from repro_torch.core.accelerator import AccelTable
from repro_torch.core.engine import INF_I32
from repro_torch.core.flow import (SLO, FlowSet, FlowSpec, Path,
                                   TrafficPattern)
from repro_torch.core.interconnect import ARB_RR
from repro_torch.core.profiler import profile_contexts_multi
from repro_torch.core.runtime import _compatible_accels
from repro_torch.core.sim import SHAPING_HW, SimConfig, gen_arrivals

ARRIVE = "arrive"
DEPART = "depart"


@dataclasses.dataclass(frozen=True)
class TenantEvent:
    """One lifecycle event applied at the START of window ``window``.

    ``arrive``: ``spec`` is placed by the controller's policy (or pinned
    to ``server``; ``accel_name`` lands it on a named accelerator), its
    lane allocated and its arrival trace generated over the remaining
    horizon (``seed`` overrides the derived per-event seed;
    ``ref_gbps`` the load-reference line rate).  ``depart``:
    ``tenant_id`` is deregistered and its lane freed."""

    window: int
    kind: str
    spec: FlowSpec | None = None
    tenant_id: int | None = None
    server: int | None = None
    accel_name: str | None = None
    ref_gbps: float | None = None
    seed: int | None = None

    @staticmethod
    def arrive(window: int, spec: FlowSpec, *, server: int | None = None,
               accel_name: str | None = None, ref_gbps: float | None = None,
               seed: int | None = None) -> "TenantEvent":
        return TenantEvent(window, ARRIVE, spec=spec, server=server,
                           accel_name=accel_name, ref_gbps=ref_gbps,
                           seed=seed)

    @staticmethod
    def depart(window: int, tenant_id: int) -> "TenantEvent":
        return TenantEvent(window, DEPART, tenant_id=tenant_id)


def _hole_spec(lane: int) -> FlowSpec:
    """Placeholder spec for an unoccupied lane: routes to accel 0 with the
    pad-fill flow attributes, injects nothing (1e-9 msgs/s keeps its trace
    empty without disturbing the shared rng stream — CBR draws none)."""
    return FlowSpec(-1 - lane, -1, Path.FUNCTION_CALL, 0,
                    TrafficPattern(msg_bytes=1024, rate_mps=1e-9,
                                   process="cbr"),
                    SLO.gbps(0.0), weight=1.0)


_HOLE_TB = tb.TBParams(1, 1, 1)


def _poll(carry: dict) -> dict[str, np.ndarray]:
    """The window's ``FLEET_POLL_KEYS`` counters ([B, n_max] each) in one
    host copy: stacked on the device as int32 words (the float latency
    sum by its bits), copied once, split on the host."""
    keys = telemetry.FLEET_POLL_KEYS
    words = torch.stack([carry[k].view(torch.int32) for k in keys])
    host = words.to("cpu").numpy()
    return {k: (host[i].view(np.float32)
                if carry[k].dtype == torch.float32 else host[i])
            for i, k in enumerate(keys)}


class FleetController:
    """SLO lifecycle manager for a fleet of client servers.

    Owns the per-server *lane layouts*: ``_lanes[b]`` maps dataplane lane
    index -> flow id (``None`` = hole).  Lanes are what the
    engine sees; keeping them stable across membership changes is what
    lets churn ride one cache entry.  A fresh controller adopts each
    runtime's registered flows in sorted-flow-id order — exactly the
    legacy layout, which is what makes the deprecation shims bitwise."""

    def __init__(self, runtimes: Sequence[Any], *,
                 policy: placement.PlacementPolicy | None = None,
                 repack_threshold: float = 0.5,
                 control: "ctl.ControlPolicy | None" = None,
                 reuse_lanes: bool = False):
        self.runtimes = list(runtimes)
        self.policy = policy or placement.SLOAware()
        self.repack_threshold = float(repack_threshold)
        self.score_cache = placement.ScoreCache()
        # the between-window shaping policy; the default StaticHold keeps
        # every run bitwise-identical to the pre-control-loop controller
        self.control = control if control is not None else ctl.StaticHold()
        # opt-in: let mid-run arrivals refill hole lanes.  Lane recycling
        # is measurement-safe now (engine.recycle_flow_lane and the run
        # loop both reset the lane's delta baseline), but refilling
        # changes lane layouts — and thus arbiter order and counter rows —
        # versus the historical always-append behaviour, so it stays off
        # by default to preserve the bitwise contract.
        self.reuse_lanes = bool(reuse_lanes)
        self._lanes: list[list[int | None]] = [sorted(rt.table)
                                               for rt in self.runtimes]
        self._tenants: dict[int, int] = {}      # flow id -> server index
        self._in_run = False     # mid-run arrivals take FRESH lanes unless
                                 # reuse_lanes opted into hole recycling
                                 # (see _assign_lane)
        self._envelopes: list[tuple[int, dict] | None] = \
            [None] * len(self.runtimes)   # per-server (version, envelopes)
        self.stats = {"admitted": 0, "rejected": 0, "departed": 0,
                      "migrated": 0, "repacks": 0}
        self.last_events: list[dict] = []

    # ------------------------------------------------------------------
    # Lane layout bookkeeping
    # ------------------------------------------------------------------
    def lane_map(self, server: int) -> list[int | None]:
        """Lane index -> flow id (None = hole) of one server — the row
        layout of that server's counters in ``run`` results."""
        return list(self._lanes[server])

    def _sync_layouts(self) -> None:
        """Reconcile layouts with the runtimes' tables: flows deregistered
        behind the controller's back become holes; unknown registered
        flows get lanes (in sorted order, matching the legacy layout)."""
        for b, rt in enumerate(self.runtimes):
            lanes = self._lanes[b]
            live = set(rt.table)
            lanes[:] = [f if (f is not None and f in live) else None
                        for f in lanes]
            known = {f for f in lanes if f is not None}
            for fid in sorted(live - known):
                self._assign_lane(b, fid)

    def _assign_lane(self, b: int, fid: int) -> int:
        """Give a flow a lane: holes first between runs (compactness) —
        and mid-run too when ``reuse_lanes`` is set, since lane surgery
        now resets the recycled lane's counters and measurement baseline
        (``engine.recycle_flow_lane`` + the run loop's prev-slab reset).
        The historical default appends a FRESH lane mid-run, preserving
        layout (and counter-row) compatibility bit-for-bit (a
        between-runs hole refill starts from a fresh carry anyway)."""
        lanes = self._lanes[b]
        if fid in lanes:
            return lanes.index(fid)
        if not self._in_run or self.reuse_lanes:
            for i, f in enumerate(lanes):
                if f is None:
                    lanes[i] = fid
                    return i
        lanes.append(fid)
        return len(lanes) - 1

    def _depart_core(self, tenant_id: int) -> tuple[int, int]:
        """The shared departure sequence (between-runs ``depart`` and the
        mid-run DEPART event): deregister, punch the lane hole, drop the
        tenant record.  Returns (server, freed lane)."""
        b = self._find_server(tenant_id)
        self.runtimes[b].deregister(tenant_id)
        lane = self._lanes[b].index(tenant_id)
        self._lanes[b][lane] = None
        self._tenants.pop(tenant_id, None)
        self.stats["departed"] += 1
        return b, lane

    def _maybe_repack(self, server: int | None = None,
                      force: bool = False) -> int:
        """Compact hole lanes out of layouts whose fragmentation crosses
        ``repack_threshold`` (always, with ``force``).  Compaction re-keys
        lanes and shrinks the batch width — i.e. the next run compiles a
        fresh engine signature — so it only ever happens between runs;
        below the threshold holes are kept and the next run reuses the
        previous cache entry."""
        n = 0
        servers = range(len(self.runtimes)) if server is None else [server]
        for b in servers:
            lanes = self._lanes[b]
            holes = sum(f is None for f in lanes)
            if holes and (force
                          or holes / len(lanes) > self.repack_threshold):
                lanes[:] = [f for f in lanes if f is not None]
                self.stats["repacks"] += 1
                n += 1
        return n

    def _find_server(self, tenant_id: int) -> int:
        b = self._tenants.get(tenant_id)
        if b is not None and tenant_id in self.runtimes[b].table:
            return b
        hits = [b for b, rt in enumerate(self.runtimes)
                if tenant_id in rt.table]
        if not hits:
            raise KeyError(f"unknown tenant {tenant_id}")
        if len(hits) > 1:
            raise ValueError(
                f"tenant id {tenant_id} is registered on several servers "
                f"{hits} — lifecycle operations need fleet-unique ids")
        return hits[0]

    # ------------------------------------------------------------------
    # Admission: cross-server SLO-aware placement
    # ------------------------------------------------------------------
    def _score_round(self, spec: FlowSpec, pin: int | None,
                     name: str | None,
                     cache: placement.ScoreCache | None
                     ) -> list[placement.Candidate]:
        """Score one admission round's fleet-wide candidate set.

        Cache-missing candidates build their would-be contexts and run
        through ONE batched ``profile_contexts_multi`` call; cache hits
        (servers untouched since they were last scored) reuse the prior
        round's Candidate — same floats, same decision, no context
        rebuild."""
        B = len(self.runtimes)
        meta = []
        for b in (range(B) if pin is None else [pin]):
            rt = self.runtimes[b]
            for a in _compatible_accels(rt, spec, name):
                cand_spec = dataclasses.replace(spec, accel_id=a)
                cached = (cache.lookup(rt, b, a, cand_spec)
                          if cache is not None else None)
                ctx = None if cached is not None \
                    else rt._admission_context(cand_spec)
                meta.append((b, a, cand_spec, cached, ctx))
        if meta:
            # ONE batched engine call profiles the whole round's
            # cache-missing cross-server candidate set
            profile_contexts_multi(
                [(self.runtimes[b].profile, ctx[0], ctx[2])
                 for b, _a, _s, cached, ctx in meta if cached is None])
        cands = []
        for b, a, cand_spec, cached, ctx in meta:
            if cached is not None:
                cands.append(cached)
                continue
            ok, entry, slo, margin, margin_res = \
                self.runtimes[b]._admission_check(cand_spec, ctx)
            cand = placement.Candidate(
                server=b, accel_id=a, spec=cand_spec, entry=entry,
                slo_gbps=tuple(slo), feasible=ok, margin=margin,
                residual=entry.residual_gbps(slo),
                server_key=placement.server_key(self.runtimes[b]),
                margin_res=margin_res)
            if cache is not None:
                cache.store(self.runtimes[b], b, a, cand_spec, cand)
            cands.append(cand)
        return cands

    def place(self, specs: Sequence[FlowSpec], *,
              policy: placement.PlacementPolicy | None = None,
              pinned: Sequence[int | None] | None = None,
              accel_names: Sequence[str | None] | None = None,
              score_cache: "placement.ScoreCache | None" = None
              ) -> list[placement.Placement]:
        """Fleet-level admission placement — one admission round per
        tenant, in order (the CapacityPlanning admission of Algorithm 1,
        shopped across every client server).

        A round enumerates every compatible (server, accelerator) landing
        option — all servers, or only ``pinned[i]`` when given; the
        accelerator matching ``accel_names[i]`` on each server, or the
        spec's positional ``accel_id`` when no name is given — scores it
        (see ``_score_round``; the controller's ``ScoreCache`` carries
        untouched servers' margins between rounds), and lets the policy
        pick.  The winner registers via the ordinary per-server
        ``ArcusRuntime.register`` path (a warmed-cache hit, so placement
        can never admit what per-server admission would reject); a tenant
        is rejected only when NO server fits.

        Parity contract: ``policy=FirstFit()`` with every spec pinned to
        its original server reproduces ``admit_fleet`` accept/reject
        decisions exactly."""
        pol = policy or self.policy
        B = len(self.runtimes)
        specs = list(specs)
        pins = list(pinned) if pinned is not None else [None] * len(specs)
        names = (list(accel_names) if accel_names is not None
                 else [None] * len(specs))
        if not (len(pins) == len(specs) and len(names) == len(specs)):
            raise ValueError(
                "pinned / accel_names must have one entry per spec")
        if any(p is not None and not 0 <= p < B for p in pins):
            raise ValueError("pinned server index out of range")
        cache = score_cache if score_cache is not None else self.score_cache
        out: list[placement.Placement] = []
        for spec, pin, name in zip(specs, pins, names):
            cands = self._score_round(spec, pin, name, cache)
            chosen = pol.select(cands)
            if chosen is not None and not chosen.feasible:
                raise ValueError(
                    f"policy {pol.name!r} selected an infeasible candidate "
                    f"(server {chosen.server}, accel {chosen.accel_id}) — "
                    "select() must return a feasible candidate or None")
            accepted = False
            if chosen is not None:
                accepted = self.runtimes[chosen.server].register(chosen.spec)
                if not accepted:
                    # feasibility came from the same cached entry
                    # register() re-reads, so a feasible candidate can
                    # only bounce if register() drifts from
                    # _admission_check
                    raise RuntimeError(
                        f"server {chosen.server} rejected a candidate "
                        "scored feasible — register() and _admission_check "
                        "diverged")
                self._tenants[chosen.spec.flow_id] = chosen.server
                self._assign_lane(chosen.server, chosen.spec.flow_id)
                self.stats["admitted"] += 1
            else:
                self.stats["rejected"] += 1
            out.append(placement.Placement(
                spec=spec,
                server=None if chosen is None else chosen.server,
                accel_id=None if chosen is None else chosen.accel_id,
                accepted=accepted,
                n_candidates=len(cands),
                n_feasible=sum(c.feasible for c in cands)))
        return out

    def admit(self, spec: FlowSpec, *, server: int | None = None,
              accel_name: str | None = None) -> placement.Placement:
        """Admit one tenant (policy placement; ``server`` pins it).  The
        flow id must be fleet-unique so ``depart`` stays unambiguous."""
        if any(spec.flow_id in rt.table for rt in self.runtimes):
            raise ValueError(
                f"flow id {spec.flow_id} is already admitted somewhere in "
                "the fleet — lifecycle tenants need fleet-unique ids")
        return self.place([spec], pinned=[server],
                          accel_names=[accel_name])[0]

    def admit_fleet(self, fleet_specs: Sequence[Sequence[FlowSpec]]
                    ) -> list[list[bool]]:
        """Register per-server FlowSpec lists, batching the admission
        profiling: round r profiles the r-th spec of EVERY server through
        one ``profile_contexts_multi`` engine call, then registers via
        the warmed per-server path — accept/reject decisions identical to
        serial registration.  An empty per-server list is valid; a
        length mismatch is rejected before any work."""
        runtimes = self.runtimes
        if len(fleet_specs) != len(runtimes):
            raise ValueError(
                f"fleet_specs must have one spec list per server "
                f"(got {len(fleet_specs)} lists for {len(runtimes)} "
                "servers)")
        results: list[list[bool]] = [[] for _ in runtimes]
        rounds = max((len(s) for s in fleet_specs), default=0)
        for r in range(rounds):
            jobs = []
            for b, rt in enumerate(runtimes):
                if r >= len(fleet_specs[b]):
                    continue
                accel, _peers, ctx = rt._admission_context(fleet_specs[b][r])
                jobs.append((rt.profile, accel, ctx))
            profile_contexts_multi(jobs)
            for b, rt in enumerate(runtimes):
                if r < len(fleet_specs[b]):
                    ok = rt.register(fleet_specs[b][r])
                    results[b].append(ok)
                    if ok:
                        self._assign_lane(b, fleet_specs[b][r].flow_id)
                        self.stats["admitted"] += 1
                    else:
                        self.stats["rejected"] += 1
        return results

    # ------------------------------------------------------------------
    # Departure + rebalancing
    # ------------------------------------------------------------------
    def depart(self, tenant_id: int) -> int:
        """Deregister a tenant between runs; returns its server index.

        The tenant's lane becomes a hole: the next ``run`` masks it via
        ``fl_mask`` — same shapes, same engine cache entry as the
        previous run.  The layout compacts (one new cache entry) only once its
        hole fraction crosses ``repack_threshold``."""
        self._sync_layouts()
        b, _lane = self._depart_core(tenant_id)
        self._maybe_repack(b)
        return b

    def rebalance(self, *, min_gain: float = 1e-6) -> list[dict]:
        """Migrate admitted tenants onto freed capacity.

        Each tenant (in (server, flow id) order) is transiently
        deregistered and its spec re-scored on every server carrying its
        accelerator type — the home candidate rebuilds the original
        context exactly, so a stay-put decision restores the tenant's
        FlowStatus (headroom, violation history) untouched.  It migrates
        only when the best foreign SLO-aware margin beats the home margin
        by more than ``min_gain`` (hysteresis against twin-server
        ping-pong).  The stateful ``ScoreCache`` makes the sweep cheap:
        a move touches two servers' tables; every other server's
        candidate scores replay from cache.  Returns one record per
        migration."""
        self._sync_layouts()
        moves: list[dict] = []
        tenants = [(b, fid) for b, rt in enumerate(self.runtimes)
                   for fid in sorted(rt.table)]
        for b, fid in tenants:
            rt = self.runtimes[b]
            st = rt.table[fid]
            name = rt.accel_specs[st.spec.accel_id].name
            st = rt.deregister(fid)
            cands = self._score_round(st.spec, None, name, self.score_cache)
            feasible = [c for c in cands if c.feasible]
            home = next((c for c in feasible if c.server == b), None)
            away = [c for c in feasible if c.server != b]
            best = (min(away, key=lambda c: (-c.margin,
                                             placement.PlacementPolicy
                                             ._tie_key(c)))
                    if away else None)
            if (best is None or home is not None
                    and best.margin <= home.margin + min_gain):
                # stay: restore the original FlowStatus bit-for-bit
                rt.table[fid] = st
                rt._version += 1
                continue
            ok = self.runtimes[best.server].register(best.spec)
            if not ok:       # same guard as place(): cannot happen unless
                rt.table[fid] = st          # scoring and register drift
                rt._version += 1
                raise RuntimeError(
                    f"server {best.server} rejected a migration scored "
                    "feasible")
            lane = self._lanes[b].index(fid)
            self._lanes[b][lane] = None
            self._assign_lane(best.server, fid)
            self._tenants[fid] = best.server
            self.stats["migrated"] += 1
            moves.append(dict(tenant=fid, src=b, dst=best.server,
                              accel_id=best.accel_id,
                              margin_before=None if home is None
                              else home.margin,
                              margin_after=best.margin))
        self._maybe_repack()
        return moves

    # ------------------------------------------------------------------
    # The managed fleet loop (the former run_managed_batch internals)
    # ------------------------------------------------------------------
    def _build_lane_args(self, b: int, width: int
                         ) -> tuple[FlowSet, np.ndarray, tb.TBState]:
        """One server's engine-side lane tables at the run's batch width:
        (FlowSet in lane order with hole placeholders, validity mask,
        packed TB registers — benign on holes)."""
        rt = self.runtimes[b]
        lanes = self._lanes[b]
        specs, params = [], []
        mask = np.zeros(width, bool)
        for i in range(width):
            fid = lanes[i] if i < len(lanes) else None
            if fid is None:
                specs.append(_hole_spec(i))
                params.append(_HOLE_TB)
            else:
                specs.append(rt.table[fid].spec)
                params.append(rt.table[fid].params)
                mask[i] = True
        return FlowSet.build(specs), mask, tb.pack(params)

    def _layout_arrivals(self, b: int, full_cfg: SimConfig, seed: int,
                         ref: dict[int, float] | None
                         ) -> tuple[np.ndarray, np.ndarray]:
        """Full-horizon arrival traces in lane order (holes stay silent).
        With a hole-free layout this is exactly the legacy per-server
        ``gen_arrivals`` call — same rng stream, same rows — which is
        what keeps the static-fleet path bitwise.

        ``ref`` keeps its legacy meaning — key k refers to the server's
        k-th LIVE flow — so it is remapped over the active lanes when
        departures have punched holes (with no holes the remap is the
        identity)."""
        rt = self.runtimes[b]
        lanes = self._lanes[b]
        specs = [rt.table[f].spec if f is not None else _hole_spec(i)
                 for i, f in enumerate(lanes)]
        if ref is not None:
            act = [i for i, f in enumerate(lanes) if f is not None]
            ref = {act[k]: v for k, v in ref.items()
                   if isinstance(k, int) and 0 <= k < len(act)}
        t, s = gen_arrivals(FlowSet.build(specs), full_cfg, seed=seed,
                            load_ref_gbps=ref)
        for i, f in enumerate(lanes):
            if f is None:                  # belt & braces: holes silent
                t[i] = INF_I32
                s[i] = 0
        return t, s

    def layout_arrivals(self, server: int, cfg: SimConfig, seed: int,
                        ref: dict[int, float] | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Full-horizon arrival traces for one server in lane order — the
        exact rows ``run`` would generate itself from ``seeds``.  The
        public seam for replayable scenarios (``repro_torch.workloads``):
        emit once, save, and pass back through ``run(arrivals=...)``."""
        return self._layout_arrivals(server, cfg, seed, ref)

    def _fleet_pass(self, host: dict, prev: dict | None, cfg: SimConfig,
                    t0_ticks: int, reports: list[list]) -> dict:
        """One fleet-wide Algorithm 1 pass between engine windows.

        Measurement runs vectorized over the whole fleet (one
        ``[B, width]`` ``telemetry.measured_rates`` slab); the per-flow
        violation / ReAdjustPattern body is the exact serial code path
        (``ArcusRuntime._window_pass`` with the controller's lane map), so
        fleet decisions are the serial decisions by construction."""
        cur = telemetry.fleet_counters(host)
        if prev is None:
            prev = {k: np.zeros_like(v) for k, v in cur.items()}
        window_s = cfg.seconds
        t_end_s = (t0_ticks + cfg.n_ticks) * cfg.tick_cycles / cfg.clock_hz
        B, width = cur["c_done_msgs"].shape
        kind = np.full((B, width), -1, np.int32)
        for b, rt in enumerate(self.runtimes):
            for lane, fid in enumerate(self._lanes[b]):
                if fid is not None:
                    kind[b, lane] = int(rt.table[fid].spec.slo.kind)
        measured = telemetry.measured_rates(cur, prev, kind, window_s)
        for b, rt in enumerate(self.runtimes):
            w_b = len(self._lanes[b])
            lane_of = {fid: i for i, fid in enumerate(self._lanes[b])
                       if fid is not None}
            cur_b = {k: v[b, :w_b] for k, v in cur.items()}
            prev_b = {k: v[b, :w_b] for k, v in prev.items()}
            reports[b].append(rt._window_pass(cur_b, prev_b, window_s,
                                              t_end_s, measured[b],
                                              lane_of))
            rt._prev_counters = cur_b
        return cur

    def _apply_event(self, ev: TenantEvent, ei: int, t0: int,
                     full_cfg: SimConfig, seeds_l: list[int],
                     arr_t, arr_sz, carry, width: int
                     ) -> tuple[Any, Any, Any, list[int],
                                list[tuple[int, int]]]:
        """Apply one ARRIVE/DEPART event at a window boundary.  Returns
        the (possibly updated) arrival buffers, carry, the list of
        servers whose lane tables must re-pack before the next window,
        and the (server, lane) pairs an ARRIVE spliced — the run loop
        resets those lanes' host-side measurement baseline so the first
        window's counter delta cannot mix a departed predecessor's
        totals into the newcomer's measured rate."""
        if ev.kind == DEPART:
            b, lane = self._depart_core(ev.tenant_id)
            # the lane goes dark: no future arrivals, queued-but-unadmitted
            # messages flushed; in-flight messages drain naturally
            arr_t[b, lane] = int(INF_I32)
            arr_sz[b, lane] = 0
            if carry is not None:
                carry = engine.release_flow_lane(carry, b, lane)
            self.last_events.append(dict(
                window=ev.window, kind=DEPART, tenant=ev.tenant_id,
                server=b, lane=lane))
            return arr_t, arr_sz, carry, [b], []

        # ARRIVE — place, register, splice the lane in
        if any(ev.spec.flow_id in rt.table for rt in self.runtimes):
            raise ValueError(
                f"arriving flow id {ev.spec.flow_id} is already admitted "
                "— lifecycle tenants need fleet-unique ids")
        p = self.place([ev.spec], pinned=[ev.server],
                       accel_names=[ev.accel_name])[0]
        if not p.accepted:
            self.last_events.append(dict(
                window=ev.window, kind=ARRIVE, tenant=ev.spec.flow_id,
                server=None, lane=None))
            return arr_t, arr_sz, carry, [], []
        b = p.server
        lane = self._lanes[b].index(ev.spec.flow_id)
        if lane >= width:
            raise RuntimeError(
                f"lane {lane} exceeds the run's reserved width {width}")
        landed = dataclasses.replace(ev.spec, accel_id=p.accel_id)
        seed = (ev.seed if ev.seed is not None
                else (seeds_l[b] * 1_000_003 + 7919 * (ei + 1))
                % (2 ** 31 - 1))
        rest_cfg = dataclasses.replace(full_cfg,
                                       n_ticks=full_cfg.n_ticks - t0)
        t1, s1 = gen_arrivals(FlowSet.build([landed]), rest_cfg, seed=seed,
                              load_ref_gbps=None if ev.ref_gbps is None
                              else {0: ev.ref_gbps})
        off = t0 * full_cfg.tick_cycles
        M = arr_t.shape[2]
        row_t = np.full(M, INF_I32, np.int32)
        row_s = np.zeros(M, np.int32)
        k = min(t1.shape[1], M)
        tt = t1[0, :k].astype(np.int64)
        shifted = np.where(tt >= INF_I32, INF_I32, tt + off)
        row_t[:k] = shifted.astype(np.int32)
        row_s[:k] = np.where(tt >= INF_I32, 0, s1[0, :k])
        arr_t[b, lane] = torch.from_numpy(row_t)
        arr_sz[b, lane] = torch.from_numpy(row_s)
        if carry is not None:
            carry = engine.recycle_flow_lane(carry, b, lane)
        self.last_events.append(dict(
            window=ev.window, kind=ARRIVE, tenant=ev.spec.flow_id,
            server=b, lane=lane))
        return arr_t, arr_sz, carry, [b], [(b, lane)]

    # ------------------------------------------------------------------
    # Control layer: WindowMetrics -> policy decisions -> register plans
    # ------------------------------------------------------------------
    def _server_envelopes(self, b: int) -> dict[int, "ctl.Envelope"]:
        """A server's profiled capacity envelopes, cached per membership
        version: policies re-read them every window, but the underlying
        ``ProfileTable.capacity`` lookups only re-run after a lifecycle
        or path change bumped the runtime's version."""
        rt = self.runtimes[b]
        hit = self._envelopes[b]
        if hit is not None and hit[0] == rt.lifecycle_version:
            return hit[1]
        env = ctl.capacity_envelopes(rt)
        self._envelopes[b] = (rt.lifecycle_version, env)
        return env

    def _control_decide(self, w: int, wcfg: SimConfig,
                        reports: list[list]) -> list[bool]:
        """One measurement -> policy -> actuation step after window ``w``:
        build each server's ``ServerView`` from the fresh WindowReport
        metrics, let ``self.control`` decide, and commit plans through
        ``control.actuate``.  Returns the per-server changed flags (a
        server whose registers did not change keeps the
        no-register-rewrite resume path).  ``StaticHold`` short-circuits
        everything — no envelopes, no margins, no actuation."""
        pol = self.control
        B = len(self.runtimes)
        views = []
        for b, rt in enumerate(self.runtimes):
            metrics = reports[b][-1].metrics if reports[b] else {}
            env = self._server_envelopes(b) if pol.needs_envelopes else {}
            margin = (self.score_cache.server_margin(b)
                      if pol.needs_envelopes else None)
            views.append(ctl.ServerView(server=b, window_s=wcfg.seconds,
                                        metrics=metrics, envelopes=env,
                                        margin=margin))
        plans = pol.decide(w, views)
        if len(plans) != B:
            raise ValueError(
                f"control policy {pol.name!r} returned {len(plans)} plans "
                f"for {B} servers")
        return [bool(plan) and ctl.actuate(self.runtimes[b], plan)
                for b, plan in enumerate(plans)]

    def run(self, *, total_ticks: int, window_ticks: int,
            tick_cycles: int = 8,
            seeds: Sequence[int] | None = None,
            arrivals: Sequence[tuple[np.ndarray, np.ndarray]] | None = None,
            load_ref_gbps: Sequence[dict[int, float] | None]
            | dict[int, float] | None = None,
            sim_kwargs: dict[str, Any] | None = None,
            events: Sequence[TenantEvent] = (),
            _force_rebuild: bool = False):
        """Drive the fleet's batched Algorithm 1 loop over a churn
        timeline.

        B servers' dataplanes run as one batch: per-server
        lane tables (ragged flow counts — and holes — masked via
        ``fl_mask``), accelerator complements (ragged accel counts),
        arrival traces and TBState registers stack along a fleet axis
        into ``engine.run_window_batch``; every window resumes the same
        carry updated in place, and register re-packs happen per server only after
        a window that reconfigured it (or a lifecycle event touched it) —
        an all-clean window resumes with NO register rewrite.

        ``events`` apply at window boundaries (the start of
        ``TenantEvent.window``); the batch width reserves one lane per
        ARRIVE event, so the whole timeline — arrivals, departures, the
        trailing partial window aside — shares one engine cache entry.
        ARRIVE placement profiles through the servers' ProfileTables:
        pre-warmed contexts are pure cache hits (no engine call at all);
        cold contexts run batched profiling engine entries on the side.

        With no events this is bit-for-bit the legacy
        ``run_managed_batch``: counters, WindowReports, admission
        decisions and post-run control state equal B serial
        ``run_managed`` calls.

        Explicit ``arrivals`` must carry one trace row per LANE (holes
        included, in ``lane_map`` order) — a row count mismatching the
        layout is rejected rather than silently landing traffic on the
        wrong lane.

        After every window (except the last) the controller runs one
        measurement -> policy -> actuation step: the window's
        ``WindowMetrics`` feed ``self.control`` (a
        ``control.ControlPolicy``; default ``StaticHold`` — a bitwise
        no-op) and committed plans mark their server for a register
        re-pack; servers whose policies held steady keep the
        no-register-rewrite resume path.

        Returns ``(results, reports)``: one last-window ``SimResult`` per
        server (rows in lane order — see ``lane_map``; with no holes that
        is sorted-flow-id order; a mid-run arrival occupies a fresh lane
        — or, with ``reuse_lanes``, a recycled hole whose counters and
        measurement baseline were reset at splice — so each tenant's
        cumulative lane counters are its own) and one
        ``list[WindowReport]`` per server."""
        runtimes = self.runtimes
        B = len(runtimes)
        if B == 0:
            return [], []
        clock_hz = runtimes[0].clock_hz
        if any(rt.clock_hz != clock_hz for rt in runtimes):
            raise ValueError("fleet servers must share clock_hz")
        dev = runtimes[0].device
        if any(rt.device != dev for rt in runtimes):
            raise ValueError("fleet servers must share one device")
        if any(not rt.table for rt in runtimes):
            raise ValueError("every fleet server needs at least one "
                             "registered flow")
        seeds_l = list(seeds) if seeds is not None else [0] * B
        refs_l = (list(load_ref_gbps)
                  if isinstance(load_ref_gbps, (list, tuple))
                  else [load_ref_gbps] * B)
        if not (len(seeds_l) == B and len(refs_l) == B):
            raise ValueError("seeds / load_ref_gbps must have one entry "
                             "per server")
        sim_kw = dict(sim_kwargs or {})
        sim_kw.setdefault("clock_hz", clock_hz)   # see run_managed
        cfg = SimConfig(n_ticks=window_ticks, tick_cycles=tick_cycles,
                        shaping=SHAPING_HW, arbiter=ARB_RR, **sim_kw)
        full_cfg = dataclasses.replace(cfg, n_ticks=total_ticks)
        n_full, rem = divmod(total_ticks, window_ticks)
        windows = [(w * window_ticks, cfg) for w in range(n_full)]
        if rem:
            windows.append((n_full * window_ticks,
                            dataclasses.replace(cfg, n_ticks=rem)))
        # -- lifecycle plan --------------------------------------------
        self._sync_layouts()
        self._maybe_repack()
        ev_by_w: dict[int, list[tuple[int, TenantEvent]]] = {}
        for ei, ev in enumerate(events):
            if ev.kind == ARRIVE and ev.spec is None:
                raise ValueError("ARRIVE event needs a spec")
            if ev.kind == DEPART and ev.tenant_id is None:
                raise ValueError("DEPART event needs a tenant_id")
            if ev.kind not in (ARRIVE, DEPART):
                raise ValueError(f"unknown event kind {ev.kind!r}")
            if not 0 <= ev.window < len(windows):
                raise ValueError(
                    f"event window {ev.window} outside the run's "
                    f"{len(windows)} windows")
            ev_by_w.setdefault(ev.window, []).append((ei, ev))
        n_arrive = sum(ev.kind == ARRIVE for ev in events)
        # fixed batch width: widest layout plus one reserve lane per
        # ARRIVE (any server may win any arrival) — the whole timeline
        # then shares one cache signature
        width = max(len(lanes) for lanes in self._lanes) + n_arrive
        self.last_events = []
        # -- arrival traces --------------------------------------------
        if arrivals is None:
            arrivals = [self._layout_arrivals(b, full_cfg, seeds_l[b],
                                              refs_l[b])
                        for b in range(B)]
        else:
            arrivals = list(arrivals)
            for b, (t, _s) in enumerate(arrivals):
                if t.shape[0] != len(self._lanes[b]):
                    raise ValueError(
                        f"arrivals[{b}] has {t.shape[0]} rows but server "
                        f"{b}'s layout has {len(self._lanes[b])} lanes "
                        "(holes included) — pass traces in lane order")
        M = max(t.shape[1] for t, _ in arrivals)
        # reserve trace columns for event tenants too: an arriving spec
        # can inject faster than any incumbent, and its spliced row must
        # fit the committed [B, width, M] buffers (``sim.trace_budget``
        # caps a flow at ceil(rate * burst_factor * horizon) + 16
        # messages — the burst factor covers registered processes whose
        # peak rate exceeds their mean)
        for ev in events:
            if ev.kind != ARRIVE or ev.spec is None:
                continue
            horizon_s = ((total_ticks - ev.window * window_ticks)
                         * tick_cycles / cfg.clock_hz)
            rate = max(ev.spec.pattern.rate_msgs_per_sec(
                32.0 if ev.ref_gbps is None else ev.ref_gbps), 1e-9)
            M = max(M, sim.trace_budget(ev.spec.pattern, rate, horizon_s))
        arr_t_np = np.full((B, width, M), INF_I32, np.int32)
        arr_sz_np = np.zeros_like(arr_t_np)
        for b, (t, s) in enumerate(arrivals):
            arr_t_np[b, :t.shape[0], :t.shape[1]] = t
            arr_sz_np[b, :s.shape[0], :s.shape[1]] = s
        # one host->device upload of the stacked full-horizon traces;
        # windows read them in place, and event splices write into them
        arr_t = torch.as_tensor(arr_t_np, device=dev)
        arr_sz = torch.as_tensor(arr_sz_np, device=dev)
        # -- engine-side tables ----------------------------------------
        atabs = [AccelTable.build(rt.accel_specs, rt.clock_hz)
                 for rt in runtimes]
        links = [rt.link for rt in runtimes]
        flowsets: list = [None] * B
        masks: list = [None] * B
        tbss: list = [None] * B
        carry = None
        prev = None
        reports: list[list] = [[] for _ in range(B)]
        for rt in runtimes:
            rt._prev_counters = None
        # per-server re-pack / rebuild only when that server's previous
        # window committed a register write or path change, or a
        # lifecycle event touched it; when NO server did, the engine
        # resumes the carry without any register rewrite at all
        dirty = [False] * B
        self._in_run = True
        self.control.reset()
        try:
            for w, (t0, wcfg) in enumerate(windows):
                for ei, ev in ev_by_w.get(w, ()):
                    arr_t, arr_sz, carry, touched, spliced = \
                        self._apply_event(ev, ei, t0, full_cfg, seeds_l,
                                          arr_t, arr_sz, carry, width)
                    for b in touched:
                        dirty[b] = True
                    # baseline reset: a recycled lane's device counters
                    # restart from zero (engine.recycle_flow_lane), so
                    # the host-side previous snapshot must too — else the
                    # newcomer's first window delta would go negative /
                    # mix in the departed tenant's totals.  (Copied first:
                    # the servers' _prev_counters are views of it.)
                    if prev is not None and spliced:
                        prev = {k: v.copy() for k, v in prev.items()}
                        for bb, ll in spliced:
                            for v in prev.values():
                                v[bb, ll] = 0
                for b in range(B):
                    if tbss[b] is None or dirty[b]:
                        flowsets[b], masks[b], tbss[b] = \
                            self._build_lane_args(b, width)
                writes = tbss if (carry is None or any(dirty)
                                  or _force_rebuild) else None
                carry = engine.run_window_batch(
                    flowsets, atabs, links, wcfg, writes, arr_t, arr_sz,
                    t0_ticks=t0, carry=carry, fl_masks=masks, device=dev)
                host = _poll(carry)
                prev = self._fleet_pass(host, prev, wcfg, t0, reports)
                dirty = [_force_rebuild
                         or bool(reports[b][-1].reconfigured
                                 or reports[b][-1].path_changes)
                         for b in range(B)]
                if w + 1 < len(windows):
                    # control layer: metrics -> policy -> actuation (the
                    # last window has no next window to actuate into; not
                    # deciding there keeps post-run control state — and
                    # StaticHold runs entirely — bitwise)
                    for b, changed in enumerate(
                            self._control_decide(w, wcfg, reports)):
                        if changed:
                            dirty[b] = True
        finally:
            self._in_run = False
        host = {k: carry[k].to("cpu", copy=True).numpy()
                for k in sim._RESULT_KEYS}
        t0_last, wcfg_last = windows[-1]
        results = []
        for b in range(B):
            el = {k: v[b] for k, v in host.items()}
            for k in sim._PER_FLOW_KEYS:
                el[k] = el[k][:len(self._lanes[b])]
            results.append(sim._collect_result(el, wcfg_last, t0_last))
        return results, reports
