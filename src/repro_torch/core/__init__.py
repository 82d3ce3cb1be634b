"""Arcus core: SLO management for accelerators with proactive traffic
shaping, in PyTorch (port of ``src/repro/core``).

Layers:
  flow / token_bucket / accelerator / interconnect — abstractions & models
  engine     — the six-stage dataplane tick on torch tensors over a batch
               axis (the link and any extra resource axes), and its
               compile cache (one tick as a CUDA graph on the card)
  sim        — trace generation, results, ``simulate`` / ``simulate_batch``
  shaper     — ReshapeDecision: rate pacing + message re-sizing
  profiler   — Capacity(t, X, N) tables as resource vectors
  telemetry  — counter deltas -> per-tenant window metrics
  runtime    — Algorithm 1 control plane (admission, capacity, re-shaping)
  placement  — fleet admission placement policies over profiled capacities
  control    — closed-loop shaping policies (WindowMetrics -> registers)
  controller — tenant-lifecycle control plane (admit/depart/rebalance/run)
  baselines  — Host_noTS / Host_TS_* / Bypassed_noTS_panic configurations
  policies   — Reserved / OnDemand / ManagedBurst / Opportunistic SLOs
"""
from repro_torch.core.flow import (SLO, FlowSet, FlowSpec, Path, SLOKind,
                                   TrafficPattern)
from repro_torch.core.token_bucket import (MODE_GBPS, MODE_IOPS,
                                           PAPER_TABLE2, TBParams, TBState,
                                           params_for_gbps, params_for_iops)

__all__ = [
    "SLO", "FlowSet", "FlowSpec", "Path", "SLOKind", "TrafficPattern",
    "FleetController", "TenantEvent",
    "MODE_GBPS", "MODE_IOPS", "PAPER_TABLE2", "TBParams", "TBState",
    "params_for_gbps", "params_for_iops",
]


def __getattr__(name: str):
    # the controller imports the engine, which imports the kernels'
    # wrappers, which import this package: load it on first use
    if name in ("FleetController", "TenantEvent"):
        from repro_torch.core import controller
        return getattr(controller, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
