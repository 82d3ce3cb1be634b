"""User-facing SLO policies (Arcus §6 "Enabling accelerator SLO policies").

Each policy maps to token-bucket register plans + admission attributes:

* Reserved      — exact pacing at the committed rate, admission-guaranteed
                  (capacity is debited for the full term).
* OnDemand      — exact pacing while admitted; admission may be rejected when
                  capacity is short (99% availability, short commitments).
* ManagedBurst  — base rate X with bursting to ``burst_x``*X for up to
                  ``burst_s`` seconds per day: a token bucket whose Bkt_Size
                  holds the entire burst budget while Refill_Rate sustains X.
* Opportunistic — no guarantee; unshaped but lowest arbiter weight, harvests
                  leftover capacity (the paper's LM / background example).

Port of ``src/repro/core/policies.py`` (pure Python, copied).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import token_bucket as tb
from repro_torch.core.flow import SLO, SLOKind


@dataclasses.dataclass(frozen=True)
class PolicyPlan:
    params: tb.TBParams
    admission_guaranteed: bool
    capacity_debit_gbps: float
    weight: float = 1.0
    priority: int = 0


def plan_reserved(slo: SLO, msg_bytes: int = 1024,
                  clock_hz: float = 250e6) -> PolicyPlan:
    params = _pace(slo, clock_hz)
    return PolicyPlan(params, True, _gbps_of(slo, msg_bytes), weight=1.0,
                      priority=2)


def plan_on_demand(slo: SLO, msg_bytes: int = 1024,
                   clock_hz: float = 250e6) -> PolicyPlan:
    params = _pace(slo, clock_hz)
    return PolicyPlan(params, False, _gbps_of(slo, msg_bytes), weight=1.0,
                      priority=1)


def plan_managed_burst(slo: SLO, *, burst_x: float = 10.0,
                       burst_s: float = 0.001, msg_bytes: int = 1024,
                       clock_hz: float = 250e6) -> PolicyPlan:
    base = _pace(slo, clock_hz)
    if slo.kind == SLOKind.GBPS:
        burst_tokens = int(slo.target * (burst_x - 1) * 1e9 / 8 * burst_s)
    else:
        burst_tokens = int(slo.target * (burst_x - 1) * burst_s)
    params = tb.TBParams(base.refill_rate,
                         max(base.bkt_size, burst_tokens),
                         base.interval, base.mode)
    # capacity planning must budget the burst, not the base (Sec. 4.3)
    return PolicyPlan(params, True, _gbps_of(slo, msg_bytes) * burst_x,
                      weight=1.0, priority=1)


def plan_opportunistic(clock_hz: float = 250e6) -> PolicyPlan:
    big = 2**30
    params = tb.TBParams(big, big, 1, tb.MODE_GBPS)
    return PolicyPlan(params, False, 0.0, weight=0.05, priority=0)


def _pace(slo: SLO, clock_hz: float) -> tb.TBParams:
    if slo.kind == SLOKind.IOPS:
        return tb.params_for_iops(slo.target, clock_hz)
    return tb.params_for_gbps(slo.target, clock_hz)


def _gbps_of(slo: SLO, msg_bytes: int) -> float:
    if slo.kind == SLOKind.GBPS:
        return slo.target
    if slo.kind == SLOKind.IOPS:
        return slo.target * msg_bytes * 8 / 1e9
    return 0.0
