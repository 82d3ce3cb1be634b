"""Flow abstraction (Arcus §3.3).

Accelerator-related traffic is managed as *flows*, similar to network flows.
Each VM can trigger multiple flows; each physical channel sustains multiple
flows; flows are uni- or bidirectional and ride on a *path* (Arcus §2.2).

This module defines the host-side (python) description of flows and the
Structure-of-Arrays form (`FlowSet`) consumed by the torch dataplane.  It is
the port's own copy of ``src/repro/core/flow.py`` (numpy only, unchanged),
kept here so the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Paths (Arcus Fig. 2)
# ---------------------------------------------------------------------------


class Path(enum.IntEnum):
    """Invocation paths. The direction flags encode which half of the
    full-duplex host<->device interconnect each stage of the path consumes
    (Arcus Sec 3.1: CaseP_multi_path exploits duplex; CaseP_same_path does
    not)."""

    FUNCTION_CALL = 0   # loopback: ingress = DMA read (h2d), egress = DMA write (d2h)
    INLINE_NIC_TX = 1   # host -> accel -> wire: ingress h2d, egress off-host (no d2h)
    INLINE_NIC_RX = 2   # wire -> accel -> host: ingress off-host, egress d2h
    INLINE_P2P = 3      # device -> accel -> device (e.g. NVMe): d2h then h2d via root complex


# ingress/egress direction per path: 0 = h2d, 1 = d2h, 2 = off-fabric (free)
PATH_INGRESS_DIR = {
    Path.FUNCTION_CALL: 0,
    Path.INLINE_NIC_TX: 0,
    Path.INLINE_NIC_RX: 2,
    Path.INLINE_P2P: 1,
}
PATH_EGRESS_DIR = {
    Path.FUNCTION_CALL: 1,
    Path.INLINE_NIC_TX: 2,
    Path.INLINE_NIC_RX: 1,
    Path.INLINE_P2P: 0,
}


# ---------------------------------------------------------------------------
# Traffic patterns (Arcus §2.2 "Diverse traffic pattern combinations")
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrafficPattern:
    """A tenant's injection pattern: message size x injection process.

    ``load`` follows the paper's Table 1 convention: fraction of the line
    rate the traffic generator injects at (0.1 ... 0.9).  When ``rate_mps``
    (messages per second) is given it overrides load-based derivation.
    """

    msg_bytes: int = 1024
    load: float = 0.5
    rate_mps: float | None = None
    # any name in the sim's arrival-process registry (``cbr``, ``poisson``
    # and ``onoff`` ship built-in; ``repro_torch.workloads.generators``
    # registers the production-shaped set: mmpp, heavytail, diurnal,
    # corrburst, flash, adversarial)
    process: str = "cbr"
    # onoff: bursts of `burst_len` back-to-back msgs separated by idle gaps.
    burst_len: int = 32
    duty: float = 0.25
    # bimodal: alternate msg sizes (secondary size, probability)
    msg_bytes2: int = 0
    p2: float = 0.0
    # extra (name, value) pairs for registered processes that need knobs
    # beyond the fields above (MMPP state rates, Pareto shape, diurnal
    # period, ...).  A tuple of pairs keeps the dataclass frozen/hashable;
    # the empty default leaves every existing pattern bit-identical.
    params: tuple = ()

    def rate_msgs_per_sec(self, line_gbps: float) -> float:
        if self.rate_mps is not None:
            return self.rate_mps
        line_bps = line_gbps * 1e9 / 8.0
        return self.load * line_bps / max(self.msg_bytes, 1)

    def param(self, name: str, default=None):
        """Look up one ``params`` knob by name (first match wins)."""
        for k, v in self.params:
            if k == name:
                return v
        return default


# ---------------------------------------------------------------------------
# SLOs (Arcus §1: a precise performance number + low variance @ percentile)
# ---------------------------------------------------------------------------


class SLOKind(enum.IntEnum):
    GBPS = 0
    IOPS = 1
    LATENCY = 2  # tail-latency bound (used by use-case 2)


@dataclasses.dataclass(frozen=True)
class SLO:
    kind: SLOKind
    target: float              # Gbps, IOPS, or seconds depending on kind
    percentile: float = 99.0   # availability percentile of the guarantee

    @staticmethod
    def gbps(target: float, percentile: float = 99.0) -> "SLO":
        return SLO(SLOKind.GBPS, target, percentile)

    @staticmethod
    def iops(target: float, percentile: float = 99.0) -> "SLO":
        return SLO(SLOKind.IOPS, target, percentile)

    @staticmethod
    def latency(bound_s: float, percentile: float = 99.0) -> "SLO":
        return SLO(SLOKind.LATENCY, bound_s, percentile)


# ---------------------------------------------------------------------------
# Flow spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlowSpec:
    flow_id: int
    vm_id: int
    path: Path
    accel_id: int
    pattern: TrafficPattern
    slo: SLO
    priority: int = 0          # higher = more important (PANIC baseline uses this)
    weight: float = 1.0        # WRR/WFQ weight
    # per-tenant resource-demand hints: ((resource_name, per_ingress_byte,
    # per_egress_byte), ...) overriding the accelerator's derived demand on
    # that axis for THIS flow (a tenant that declares its workload is
    # compute-bound, say).  Hints re-key the flow's profiling contexts; the
    # empty default keeps every context key bitwise-stable.
    res_demand: tuple = ()


@dataclasses.dataclass
class FlowSet:
    """SoA view of a set of flows, ready to feed the jitted dataplane."""

    n: int
    vm_id: np.ndarray          # [N] int32
    path: np.ndarray           # [N] int32
    ingress_dir: np.ndarray    # [N] int32 (0 h2d, 1 d2h, 2 off-fabric)
    egress_dir: np.ndarray     # [N] int32
    accel_id: np.ndarray       # [N] int32
    priority: np.ndarray       # [N] int32
    weight: np.ndarray         # [N] float32
    slo_kind: np.ndarray       # [N] int32
    slo_target: np.ndarray     # [N] float32
    specs: Sequence[FlowSpec] = dataclasses.field(default_factory=list)

    @staticmethod
    def build(specs: Sequence[FlowSpec]) -> "FlowSet":
        n = len(specs)
        return FlowSet(
            n=n,
            vm_id=np.array([s.vm_id for s in specs], np.int32),
            path=np.array([int(s.path) for s in specs], np.int32),
            ingress_dir=np.array([PATH_INGRESS_DIR[s.path] for s in specs], np.int32),
            egress_dir=np.array([PATH_EGRESS_DIR[s.path] for s in specs], np.int32),
            accel_id=np.array([s.accel_id for s in specs], np.int32),
            priority=np.array([s.priority for s in specs], np.int32),
            weight=np.array([s.weight for s in specs], np.float32),
            slo_kind=np.array([int(s.slo.kind) for s in specs], np.int32),
            slo_target=np.array([s.slo.target for s in specs], np.float32),
            specs=list(specs),
        )
