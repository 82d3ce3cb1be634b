"""Arcus core: SLO management for accelerators with proactive traffic
shaping, in PyTorch (port of ``src/repro/core``).

Layers ported so far:
  flow / token_bucket / accelerator / interconnect — abstractions & models
  engine     — the six-stage dataplane tick on torch tensors, and its
               compile cache (one tick as a CUDA graph on the card)
  sim        — trace generation, results and ``simulate``
  shaper     — ReshapeDecision: rate pacing + message re-sizing
  profiler   — Capacity(t, X, N) tables, profiled one context at a time
  telemetry  — counter deltas -> per-tenant window metrics
  runtime    — Algorithm 1 control plane (admission, capacity, re-shaping)
  baselines  — Host_noTS / Host_TS_* / Bypassed_noTS_panic configurations

The fleet controller, placement and policies are not ported yet.
"""
from repro_torch.core.flow import (SLO, FlowSet, FlowSpec, Path, SLOKind,
                                   TrafficPattern)
from repro_torch.core.token_bucket import (MODE_GBPS, MODE_IOPS,
                                           PAPER_TABLE2, TBParams, TBState,
                                           params_for_gbps, params_for_iops)

__all__ = [
    "SLO", "FlowSet", "FlowSpec", "Path", "SLOKind", "TrafficPattern",
    "MODE_GBPS", "MODE_IOPS", "PAPER_TABLE2", "TBParams", "TBState",
    "params_for_gbps", "params_for_iops",
]
