"""Communication-resource model (Arcus §2.2, §3.1 communication-related
contention).

Models the insufficiently-isolated components the paper identifies:
  * a full-duplex host<->device interconnect (PCIe Gen 3.0 x8 in the paper's
    prototype) with independent per-direction capacity,
  * a root-complex / shared-buffer credit pool drained by in-flight messages,
  * the arbiter that multiplexes flows onto the interconnect (round-robin /
    weighted RR / weighted-fair / strict priority) — the PANIC-style
    interface of the baselines.

Capacities are expressed as bytes-per-cycle so the dataplane can work in
integer cycle time.  The port's own copy of ``src/repro/core/interconnect.py``
(numpy only, unchanged).
"""
from __future__ import annotations

import dataclasses

import numpy as np

ARB_RR = 0
ARB_WRR = 1
ARB_PRIORITY = 2
ARB_WFQ = 3

#: well-known resource-axis names (axis 0 is always the link itself)
RES_LINK = "link"
RES_MEM_BW = "mem_bw"
RES_HOST_DMA = "host_dma"


@dataclasses.dataclass(frozen=True)
class ResourceSpec:
    """One contended resource axis *beyond* the link itself (HW-QoS survey
    dimensions: device memory bandwidth, host/PCIe DMA engines, ...).

    The link stays axis 0 of the resource vector with its own full-duplex
    budget machinery (``LinkSpec``); each ``ResourceSpec`` adds a pooled
    axis the dataplane charges per granted/egressed byte.  The shaping
    knob is a token bucket on the axis itself: ``capacity_gbps`` is the
    refill rate, ``burst_bytes`` the bucket depth (unused budget carried
    forward, 0 = lose idle capacity exactly like the link does).

    ``fabric_only`` axes (host DMA engines) charge only bytes that
    actually cross the host fabric — an off-fabric direction (wire-side
    ingress/egress of the inline paths) is free.
    """

    name: str
    capacity_gbps: float
    burst_bytes: int = 0
    fabric_only: bool = False

    def bytes_per_cycle(self, clock_hz: float) -> float:
        return self.capacity_gbps * 1e9 / 8.0 / clock_hz


def mem_bw(capacity_gbps: float, burst_bytes: int = 0) -> ResourceSpec:
    """Device-memory-bandwidth axis (every byte an accelerator reads or
    writes crosses it)."""
    return ResourceSpec(RES_MEM_BW, capacity_gbps, burst_bytes)


def host_dma(capacity_gbps: float, burst_bytes: int = 0) -> ResourceSpec:
    """Host/PCIe DMA-engine axis — pooled across both directions, charged
    only for bytes that cross the host fabric."""
    return ResourceSpec(RES_HOST_DMA, capacity_gbps, burst_bytes,
                        fabric_only=True)


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Full-duplex interconnect + credit pool — axis 0 of the host's
    contended-resource vector, optionally extended with more axes.

    Defaults model PCIe Gen 3.0 x8: 7.88 GB/s raw per direction; effective
    payload bandwidth ~85% after TLP overheads (the paper's CaseP_multi_path
    reaches 85% of ideal).

    ``resources`` lists the additional shaped axes (``ResourceSpec``): an
    empty tuple (the default) is the scalar R=1 degenerate case and is
    bitwise-identical to the pre-vector engine.
    """

    h2d_gbps: float = 63.0       # Gbit/s per direction (Gen3 x8)
    d2h_gbps: float = 63.0
    efficiency: float = 0.85
    clock_hz: float = 250e6
    credits: int = 64            # root-complex buffer credits (in-flight msgs)
    mtu_bytes: int = 4096        # max TLP burst granted per flow per round
    # per-message fabric overhead (descriptor fetch + doorbell + TLP headers
    # + completion): the reason 64B messages see a fraction of line rate
    # (Sec. 3.1 communication-related inaccuracy).
    msg_overhead_bytes: int = 100
    # additional contended axes beyond the link (R-1 of them; R=1 when empty)
    resources: tuple = ()

    def __post_init__(self):
        # lists are a natural way to hand resources in; keep the spec
        # hashable (profiling groups / compile keys) by storing a tuple
        if not isinstance(self.resources, tuple):
            object.__setattr__(self, "resources", tuple(self.resources))

    def bytes_per_cycle(self) -> tuple[float, float]:
        h2d = self.h2d_gbps * self.efficiency * 1e9 / 8.0 / self.clock_hz
        d2h = self.d2h_gbps * self.efficiency * 1e9 / 8.0 / self.clock_hz
        return h2d, d2h

    @property
    def n_resources(self) -> int:
        """R: the link itself plus every extra axis."""
        return 1 + len(self.resources)

    def resource_caps_per_cycle(self) -> np.ndarray:
        """[R-1] bytes-per-cycle capacities of the extra axes."""
        return np.asarray([r.bytes_per_cycle(self.clock_hz)
                           for r in self.resources], np.float32)

    def resource_burst_bytes(self) -> np.ndarray:
        """[R-1] token-bucket depths (bytes of unused budget carried)."""
        return np.asarray([r.burst_bytes for r in self.resources],
                          np.float32)


def arbiter_weights(kind: int, n: int, weight: np.ndarray,
                    priority: np.ndarray) -> np.ndarray:
    """Static per-flow service quanta for the arbiters used by baselines.

    Returns [N] float32 'quantum' multipliers: the relative share of link
    budget a flow may claim per round. RR = equal; WRR/WFQ = by weight;
    PRIORITY = lexicographic (modeled as exponential weighting, which is how
    strict priority behaves under saturation).
    """
    if kind == ARB_RR:
        w = np.ones(n)
    elif kind in (ARB_WRR, ARB_WFQ):
        w = np.asarray(weight, np.float64).copy()
    elif kind == ARB_PRIORITY:
        p = np.asarray(priority, np.float64)
        w = 16.0 ** (p - p.min())
    else:
        raise ValueError(kind)
    w = w / w.sum()
    return w.astype(np.float32)
