"""Window telemetry: counter deltas -> per-tenant metrics.

The measurement layer of the control loop.  Every window the runtime reads
the cumulative hardware counters off the engine carry and derives, per
tenant, the measured rate in its SLO unit, fractional SLO slack, the
violation streak, mean completion latency (``c_lat_sum`` accumulates each
completion's latency in cycles, so a window's mean is a counter-delta
ratio) and link utilization.  Latency-SLO violations feed only
``WindowMetrics``; ``WindowReport.violated`` keeps its rate-SLO-only
semantics.

Port of ``src/repro/core/telemetry.py`` (numpy, copied) for the serial
runtime; the fleet helpers and the extra resource axes are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.flow import PATH_INGRESS_DIR, SLOKind


def measured_rates(cur: dict, prev: dict, kind: np.ndarray,
                   window_s: float) -> np.ndarray:
    """SLOViolationChecker measurement (Algorithm 1 lines 11-13),
    vectorized over trailing flow axes: per-flow achieved rate in the
    flow's own SLO unit (IOPS or Gbps of ingress payload).  Elementwise
    float64 — one server's row is bitwise-identical whether computed
    serially ([n]) or as a fleet slab ([B, n_max])."""
    meas_iops = (cur["c_done_msgs"] - prev["c_done_msgs"]) / window_s
    meas_gbps = ((cur["c_done_bytes"] - prev["c_done_bytes"])
                 * 8 / window_s / 1e9)
    return np.where(kind == int(SLOKind.IOPS), meas_iops, meas_gbps)


def mean_latency_s(cur: dict, prev: dict, clock_hz: float) -> np.ndarray:
    """Mean completion latency over the window, per flow lane, in seconds
    (NaN where the window completed nothing).  ``c_lat_sum`` accumulates
    per-completion latency in cycles, so this is a pure delta ratio."""
    d_msgs = np.asarray(cur["c_done_msgs"] - prev["c_done_msgs"], np.float64)
    d_lat = np.asarray(cur["c_lat_sum"] - prev["c_lat_sum"], np.float64)
    with np.errstate(invalid="ignore"):
        return np.where(d_msgs > 0, d_lat / np.maximum(d_msgs, 1.0)
                        / clock_hz, np.nan)


def admitted_gbps(cur: dict, prev: dict, window_s: float) -> np.ndarray:
    """Ingress payload the shaper admitted this window, in Gbps per lane
    (the demand side of the utilization vector — what the token buckets
    actually let through, as opposed to what completed)."""
    return (cur["c_adm_bytes"] - prev["c_adm_bytes"]) * 8 / window_s / 1e9


def flow_axis_util(spec, accel, link, adm_gbps: float) -> tuple[float, ...]:
    """One flow's utilization of the shaped resource vector: axis 0 (the
    only axis the port has) is the flow's ingress link direction, admitted
    Gbps over the direction's effective bandwidth (off-fabric paths use
    0)."""
    del accel
    d = PATH_INGRESS_DIR[spec.path]
    caps = (link.h2d_gbps, link.d2h_gbps)
    link_cap = caps[d] * link.efficiency if d < 2 else 0.0
    return (adm_gbps / link_cap if link_cap > 0 else 0.0,)


@dataclasses.dataclass(frozen=True)
class WindowMetrics:
    """One tenant's telemetry digest for one window — what a
    ``ControlPolicy`` sees.

    ``measured`` is always the rate in the flow's SLO unit (Gbps or
    IOPS; latency-SLO flows report their achieved Gbps here too, for
    continuity with ``WindowReport.measured``).  ``slack`` is fractional
    headroom against the SLO: positive = meeting it, negative = how far
    below (rate SLOs: measured/target - 1; latency SLOs:
    1 - lat_avg/bound; NaN when the target is degenerate or nothing
    completed).  ``streak`` counts consecutive violated windows.
    ``util`` is the per-resource-axis utilization vector from
    ``flow_axis_util``."""

    flow_id: int
    lane: int
    kind: int                  # SLOKind value
    target: float              # SLO target in its own unit
    measured: float            # achieved rate (SLO unit; Gbps for latency)
    slack: float               # + meeting SLO, - violating, NaN unknown
    violated: bool
    streak: int
    lat_avg_s: float           # mean completion latency (NaN if none)
    util: tuple[float, ...]    # per-resource-axis utilization fractions

    def to_json(self) -> dict:
        return {"flow_id": self.flow_id, "lane": self.lane,
                "kind": self.kind, "target": self.target,
                "measured": self.measured, "slack": self.slack,
                "violated": self.violated, "streak": self.streak,
                "lat_avg_s": self.lat_avg_s, "util": list(self.util)}

    @staticmethod
    def from_json(d: dict) -> "WindowMetrics":
        return WindowMetrics(
            flow_id=int(d["flow_id"]), lane=int(d["lane"]),
            kind=int(d["kind"]), target=float(d["target"]),
            measured=float(d["measured"]), slack=float(d["slack"]),
            violated=bool(d["violated"]), streak=int(d["streak"]),
            lat_avg_s=float(d["lat_avg_s"]),
            util=tuple(float(u) for u in d["util"]))


def flow_metrics(spec, lane: int, measured: float, lat_s: float,
                 streak_prev: int, util: tuple[float, ...],
                 slo_tol: float) -> WindowMetrics:
    """Fold one flow's window measurements into a ``WindowMetrics``.

    The violation rule matches ``ArcusRuntime._slo_ok`` for rate SLOs
    (measured under target by more than ``slo_tol``); latency SLOs —
    which ``_slo_ok`` always passes, preserving the legacy report — are
    judged here against their bound with the same tolerance, so policies
    can react to tail-latency pressure the legacy loop cannot see."""
    kind = spec.slo.kind
    target = float(spec.slo.target)
    if kind == SLOKind.LATENCY:
        violated = bool(np.isfinite(lat_s)
                        and lat_s > target * (1 + slo_tol))
        slack = 1.0 - lat_s / target if (np.isfinite(lat_s)
                                         and target > 0) else float("nan")
    else:
        violated = bool(measured < target * (1 - slo_tol))
        slack = (measured / target - 1.0) if target > 0 else float("nan")
    return WindowMetrics(
        flow_id=spec.flow_id, lane=lane, kind=int(kind), target=target,
        measured=float(measured), slack=float(slack), violated=violated,
        streak=streak_prev + 1 if violated else 0,
        lat_avg_s=float(lat_s), util=util)
