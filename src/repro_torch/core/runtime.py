"""Arcus control-plane runtime — Algorithm 1 (Sec. 4.3).

Runs on every client server; periodically:
  * reads per-flow hardware counters (SLOViolationChecker),
  * re-adjusts shaping (ReAdjustPattern = PathSelection + ReshapeDecision,
    committed to the parameter registers without stopping the dataplane),
  * admits/rejects new registrations (AdmissionControl + CapacityPlanning
    over the ProfileTable and PerFlowStatusTable).

The dataplane is the torch simulator (`repro_torch.core.sim`) on the
runtime's device; register writes are the carry's TBState parameter
fields — the MMIO analogue.  Port of ``src/repro/core/runtime.py``: the
per-server ``ArcusRuntime`` and ``WindowReport``; the deprecated fleet
shims wait for the port's fleet controller.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import telemetry
from repro_torch.core import token_bucket as tb
from repro_torch.core.accelerator import AccelTable, AcceleratorSpec
from repro_torch.core.flow import (PATH_INGRESS_DIR, FlowSet, FlowSpec, Path,
                                   SLOKind)
from repro_torch.core.interconnect import ARB_RR, LinkSpec
from repro_torch.core.profiler import ProfileTable, canonical_order
from repro_torch.core.shaper import reshape_decision
from repro_torch.core.sim import SHAPING_HW, SimConfig, gen_arrivals, simulate
from repro_torch.device import resolve_device


@dataclasses.dataclass
class FlowStatus:
    """One PerFlowStatusTable entry (Sec. 4.3 "Capacity planning")."""

    spec: FlowSpec                    # VM id, path id, accelerator id, SLO
    params: tb.TBParams               # mechanism parameters configured
    headroom: float = 1.0             # control-knob: pacing over-provision
    measured: float = float("nan")    # current SLO status (hw counters)
    violations: int = 0
    reconfigs: int = 0
    accepted: bool = True
    streak: int = 0                   # consecutive violated windows (incl.
                                      # latency-SLO violations, which feed
                                      # WindowMetrics but never `violations`)


@dataclasses.dataclass
class WindowReport:
    """One window's Algorithm 1 outcome.

    The legacy fields (``measured`` .. ``path_changes``) keep their
    exact pre-telemetry semantics; ``metrics`` carries the per-tenant
    ``telemetry.WindowMetrics`` digest (SLO slack, violation streak,
    mean latency, per-resource-axis utilization) that control policies
    and benchmarks consume — one schema instead of each re-deriving
    from raw counters.  ``to_json`` / ``from_json`` round-trip the whole
    report."""

    t_end_s: float
    measured: dict[int, float]
    violated: list[int]
    reconfigured: list[int]
    path_changes: list[tuple[int, int, int]]
    metrics: dict[int, telemetry.WindowMetrics] = \
        dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "t_end_s": self.t_end_s,
            "measured": {str(k): v for k, v in self.measured.items()},
            "violated": list(self.violated),
            "reconfigured": list(self.reconfigured),
            "path_changes": [list(pc) for pc in self.path_changes],
            "metrics": {str(k): m.to_json()
                        for k, m in self.metrics.items()},
        }

    @staticmethod
    def from_json(d: dict) -> "WindowReport":
        return WindowReport(
            t_end_s=float(d["t_end_s"]),
            measured={int(k): float(v)
                      for k, v in d.get("measured", {}).items()},
            violated=[int(f) for f in d.get("violated", [])],
            reconfigured=[int(f) for f in d.get("reconfigured", [])],
            path_changes=[tuple(int(x) for x in pc)
                          for pc in d.get("path_changes", [])],
            metrics={int(k): telemetry.WindowMetrics.from_json(m)
                     for k, m in d.get("metrics", {}).items()})


class ArcusRuntime:
    """SLO manager for one client server (Algorithm 1)."""

    def __init__(self, accels: list[AcceleratorSpec],
                 link: LinkSpec | None = None,
                 profile_table: ProfileTable | None = None,
                 *, clock_hz: float = 250e6, slo_tol: float = 0.02,
                 alt_paths: dict[int, list[Path]] | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.accel_specs = accels
        self.clock_hz = clock_hz
        # the runtime clock threads into every config the runtime builds
        # itself: a default link (and the ProfileTable riding on it) runs
        # on the control clock, so dataplane rates, profiled capacities
        # and window seconds share one clock.  An explicitly passed link
        # or profile table wins — it is the caller's override.
        self.link = link if link is not None else LinkSpec(clock_hz=clock_hz)
        self.profile = profile_table or ProfileTable(self.link,
                                                     device=self.device)
        self.slo_tol = slo_tol
        self.alt_paths = alt_paths or {}
        self.table: dict[int, FlowStatus] = {}   # PerFlowStatusTable
        self._prev_counters: dict[str, np.ndarray] | None = None
        self._version = 0        # bumped on register/deregister/path
                                 # changes (the reference's ScoreCache
                                 # invalidation guard)

    # ------------------------------------------------------------------
    # Registration path (Algorithm 1 lines 7-10)
    # ------------------------------------------------------------------
    def register(self, spec: FlowSpec) -> bool:
        if not self._admission_control(spec):
            return False                       # Reject registration (line 9)
        decision = reshape_decision(self.accel_specs[spec.accel_id],
                                    spec.slo, spec.pattern.msg_bytes,
                                    clock_hz=self.clock_hz)
        self.table[spec.flow_id] = FlowStatus(spec=spec,
                                              params=decision.params)
        self._version += 1
        return True

    def deregister(self, flow_id: int) -> FlowStatus:
        """Tenant departure: drop the flow from the PerFlowStatusTable.

        Capacity planning sees the shrunk context immediately (the next
        admission's would-be context no longer includes the tenant, so an
        admit→depart→admit of the same spec reproduces the original
        decision from the same cached profile entries).  Raises
        ``KeyError`` for an unknown flow."""
        st = self.table.pop(flow_id)
        self._version += 1
        return st

    @property
    def lifecycle_version(self) -> int:
        """Monotonic counter of membership changes (register/deregister
        and path changes)."""
        return self._version

    def _admission_context(self, spec: FlowSpec
                           ) -> tuple[AcceleratorSpec, list[FlowSpec],
                                      list[tuple[Path, int, float]]]:
        """The would-be CapacityPlanning context if ``spec`` registered:
        (accelerator, peer specs incl. the candidate, profiler context).
        Single source of truth for what admission profiles."""
        accel = self.accel_specs[spec.accel_id]
        peers = [s.spec for s in self.table.values()
                 if s.spec.accel_id == spec.accel_id] + [spec]
        # a tenant's resource-demand hint rides the context as a 4th tuple
        # element (re-keying its profiled contexts); hint-free tenants keep
        # the 3-tuple form so every existing context key stays bit-stable
        ctx = [(s.path, s.pattern.msg_bytes, s.pattern.load)
               + ((s.res_demand,) if s.res_demand else ())
               for s in peers]
        return accel, peers, ctx

    def _admission_check(self, spec: FlowSpec, _context=None):
        """CapacityPlanning(CHECK) with its evidence: (SLO-Friendly?,
        CapacityEntry, canonical-order SLO vector, slo_margin, per-axis
        slo_margins)."""
        accel, peers, ctx = (_context if _context is not None
                             else self._admission_context(spec))
        entry = self.profile.capacity(accel, ctx)
        # per-flow SLO vector in the entry's canonical context order
        slo_gbps = [self._slo_gbps(peers[i]) for i in canonical_order(ctx)]
        margin_res = entry.slo_margins(slo_gbps)
        margin = margin_res[0]
        for v in margin_res[1:]:
            margin = min(margin, v)
        # slo_tag is defined as slo_margin >= 0 — one decision, one copy
        return margin >= 0, entry, slo_gbps, margin, tuple(margin_res)

    def _admission_control(self, spec: FlowSpec) -> bool:
        """CapacityPlanning(CHECK): the profiled capacity of the would-be
        context must cover every flow's SLO — in aggregate, and per flow
        (a small-message flow cannot be promised more than contention lets
        one flow reach, see ``CapacityEntry.slo_tag``)."""
        return self._admission_check(spec)[0]

    def _slo_gbps(self, spec: FlowSpec) -> float:
        if spec.slo.kind == SLOKind.GBPS:
            return spec.slo.target
        if spec.slo.kind == SLOKind.IOPS:
            return spec.slo.target * spec.pattern.msg_bytes * 8 / 1e9
        return 0.0  # latency SLOs are enforced by shaping others, not pacing

    # ------------------------------------------------------------------
    # Managed execution: dataplane windows + periodic Algorithm 1 pass
    # ------------------------------------------------------------------
    def run_managed(self, *, total_ticks: int, window_ticks: int,
                    tick_cycles: int = 8, seed: int = 0,
                    arrivals: tuple[np.ndarray, np.ndarray] | None = None,
                    load_ref_gbps: dict[int, float] | None = None,
                    sim_kwargs: dict[str, Any] | None = None):
        """Run the dataplane with periodic SLO management, on the runtime's
        device.

        The carry stays on the device from window to window (updated in
        place); only the counters and the completion ring come back to
        the host for each window's Algorithm 1 pass, and the register
        writes it decides go into the next window.

        A trailing partial window (``total_ticks % window_ticks != 0``) runs
        as one final short window, not a silently dropped tail.

        Returns (SimResult of the last window — containing the full
        completion history ring — and the list of WindowReports)."""
        flows = self._flowset()
        atab = AccelTable.build(self.accel_specs, self.clock_hz)
        # the dataplane runs on the runtime's clock: arrival rates, link
        # bandwidth, window seconds and report timestamps all derive from
        # the same SimConfig clock (an explicit sim_kwargs clock still wins)
        sim_kw = dict(sim_kwargs or {})
        sim_kw.setdefault("clock_hz", self.clock_hz)
        cfg = SimConfig(n_ticks=window_ticks, tick_cycles=tick_cycles,
                        shaping=SHAPING_HW, arbiter=ARB_RR, **sim_kw)
        full_cfg = dataclasses.replace(cfg, n_ticks=total_ticks)
        if arrivals is None:
            arrivals = gen_arrivals(flows, full_cfg, seed=seed,
                                    load_ref_gbps=load_ref_gbps)
        # place the full-horizon trace on device once; per-window calls
        # then pass the same buffers (no host->device copies)
        arr_t, arr_sz = (torch.as_tensor(np.asarray(a, np.int32),
                                         device=self.device)
                         for a in arrivals)
        carry = None
        reports: list[WindowReport] = []
        result = None
        self._prev_counters = None
        n_full, rem = divmod(total_ticks, window_ticks)
        windows = [(w * window_ticks, cfg) for w in range(n_full)]
        if rem:
            windows.append((n_full * window_ticks,
                            dataclasses.replace(cfg, n_ticks=rem)))
        for t0, wcfg in windows:
            tbs = tb.pack([self.table[f].params for f in sorted(self.table)])
            result, carry = simulate(
                flows, atab, self.link, wcfg, tbs, arr_t, arr_sz,
                t0_ticks=t0, carry=carry, return_carry=True,
                device=self.device)
            reports.append(self._algorithm1_pass(result, wcfg))
            flows = self._flowset()   # path changes take effect next window
        return result, reports

    def _flowset(self) -> FlowSet:
        return FlowSet.build([self.table[f].spec for f in sorted(self.table)])

    # ------------------------------------------------------------------
    # Algorithm 1 main loop body (lines 3-6)
    # ------------------------------------------------------------------
    def _algorithm1_pass(self, result, cfg: SimConfig) -> WindowReport:
        window_s = cfg.seconds   # the dataplane clock (== self.clock_hz
                                 # unless sim_kwargs overrode it)
        cur = {k: np.array(v) for k, v in result.counters.items()}
        prev = self._prev_counters or {k: np.zeros_like(v)
                                       for k, v in cur.items()}
        self._prev_counters = cur
        kind = np.array([int(self.table[fid].spec.slo.kind)
                         for fid in sorted(self.table)], np.int32)
        measured_row = telemetry.measured_rates(cur, prev, kind, window_s)
        return self._window_pass(cur, prev, window_s, result.seconds,
                                 measured_row)

    def _window_pass(self, cur, prev, window_s: float, t_end_s: float,
                     measured_row: np.ndarray,
                     lane_of: dict[int, int] | None = None) -> WindowReport:
        """Per-flow half of the Algorithm 1 window pass: violation check +
        ReAdjustPattern + report assembly.  The single body shared by the
        serial and fleet paths of the reference.

        ``lane_of`` maps flow id -> dataplane lane index in the counter
        rows; ``None`` means lanes follow sorted-flow-id order (the serial
        layout).

        Besides the legacy report fields the pass assembles each
        tenant's ``telemetry.WindowMetrics`` — the measurement layer the
        control policies consume.  Metrics are derived from the same
        counter deltas with the same float64 ops as the reference; latency-
        SLO violations exist
        only in the metrics (``_slo_ok`` still always passes them),
        keeping the legacy violated/reconfigured lists bit-stable."""
        measured, violated, reconfigured, path_changes = {}, [], [], []
        metrics: dict[int, telemetry.WindowMetrics] = {}
        lat_row = telemetry.mean_latency_s(cur, prev, self.clock_hz)
        adm_row = telemetry.admitted_gbps(cur, prev, window_s)
        for i, fid in enumerate(sorted(self.table)):
            lane = i if lane_of is None else lane_of[fid]
            st = self.table[fid]
            st.measured = float(measured_row[lane])
            measured[fid] = st.measured
            util = telemetry.flow_axis_util(
                st.spec, self.accel_specs[st.spec.accel_id], self.link,
                float(adm_row[lane]))
            m = telemetry.flow_metrics(st.spec, lane, st.measured,
                                       float(lat_row[lane]), st.streak,
                                       util, self.slo_tol)
            st.streak = m.streak
            metrics[fid] = m
            if not self._slo_ok(st):
                st.violations += 1
                violated.append(fid)
                old_path = int(st.spec.path)
                changed = self._re_adjust_pattern(st, cur, prev, window_s,
                                                  lane_of)
                if changed:
                    reconfigured.append(fid)
                    if changed == "path":
                        path_changes.append(
                            (fid, old_path, int(st.spec.path)))
        return WindowReport(t_end_s, measured, violated, reconfigured,
                            path_changes, metrics)

    def _slo_ok(self, st: FlowStatus) -> bool:
        """SLOViolationChecker (lines 11-13)."""
        slo = st.spec.slo
        if slo.kind == SLOKind.LATENCY:
            return True  # checked from completion records by callers
        return st.measured >= slo.target * (1 - self.slo_tol)

    def _re_adjust_pattern(self, st: FlowStatus, cur, prev, window_s: float,
                           lane_of: dict[int, int] | None = None):
        """ReAdjustPattern (lines 17-21)."""
        changed = None
        new_path = self._path_selection(st, cur, prev, window_s, lane_of)
        if new_path is not None:
            st.spec = dataclasses.replace(st.spec, path=new_path)
            # a path change re-keys this flow's would-be contexts, so any
            # ScoreCache margins for this server are stale now
            self._version += 1
            changed = "path"
        # ReshapeDecision: widen pacing headroom toward the observed deficit
        target = (st.spec.slo.target if st.spec.slo.kind != SLOKind.LATENCY
                  else None)
        if target:
            deficit = target / max(st.measured, 1e-9)
            st.headroom = float(np.clip(st.headroom * min(deficit, 1.25),
                                        1.0, 2.0))
            decision = reshape_decision(self.accel_specs[st.spec.accel_id],
                                        st.spec.slo, st.spec.pattern.msg_bytes,
                                        clock_hz=self.clock_hz,
                                        headroom=st.headroom)
            if decision.params != st.params:
                st.params = decision.params   # register write next window
                st.reconfigs += 1
                changed = changed or "params"
        return changed

    def _path_selection(self, st: FlowStatus, cur, prev, window_s: float,
                        lane_of: dict[int, int] | None = None) -> Path | None:
        """PathSelection (line 18): move to a less-loaded path if the current
        ingress direction is saturated and an alternative exists."""
        alts = self.alt_paths.get(st.spec.accel_id, [])
        if not alts:
            return None
        util = self._direction_util(cur, prev, window_s, lane_of)
        cur_dir = PATH_INGRESS_DIR[st.spec.path]
        if cur_dir == 2 or util[cur_dir] < 0.9:
            return None
        for p in alts:
            d = PATH_INGRESS_DIR[p]
            if p != st.spec.path and (d == 2 or util[d] < 0.7):
                return p
        return None

    def _direction_util(self, cur, prev, window_s: float,
                        lane_of: dict[int, int] | None = None) -> np.ndarray:
        h2d_bps = self.link.h2d_gbps * self.link.efficiency * 1e9 / 8
        d2h_bps = self.link.d2h_gbps * self.link.efficiency * 1e9 / 8
        by_dir = np.zeros(3)
        for i, fid in enumerate(sorted(self.table)):
            lane = i if lane_of is None else lane_of[fid]
            st = self.table[fid]
            b = (cur["c_adm_bytes"][lane]
                 - prev["c_adm_bytes"][lane]) / window_s
            d = PATH_INGRESS_DIR[st.spec.path]
            by_dir[d] += b
        return np.array([by_dir[0] / h2d_bps, by_dir[1] / d2h_bps, 0.0])
