"""Traffic-shaping decisions (Arcus §4.1-4.2).

The shaper's two levers (Sec. 2.2 "Basics of traffic shaping"):
  1. rate limiting   — token-bucket registers, planned by the control plane;
  2. message re-sizing — "Messages can be re-sized by splitting the payloads
     and duplicating another message header."

`ReshapeDecision` combines both: given a flow's SLO and the accelerator's
heterogeneity profile, pick (a) the token-bucket parameters for the target
rate (with ingress-rate inflation when the accelerator's egress/ingress
ratio R != 1) and (b) an optimal message size for the accelerator curve.

Port of ``src/repro/core/shaper.py`` (pure Python and numpy, copied).
"""
from __future__ import annotations

import dataclasses


from repro_torch.core import token_bucket as tb
from repro_torch.core.accelerator import AcceleratorSpec, size_grid
from repro_torch.core.flow import SLO, SLOKind


@dataclasses.dataclass(frozen=True)
class ShapeDecision:
    params: tb.TBParams
    resize_to: int | None = None   # split messages larger than this
    note: str = ""


def optimal_msg_bytes(accel: AcceleratorSpec, lo: int = 256,
                      hi: int = 65536) -> int:
    """Smallest message size achieving >=95% of the accelerator's peak —
    large enough to be efficient, small enough to keep shaping granular."""
    grid = size_grid()
    grid = grid[(grid >= lo) & (grid <= hi)]
    tput = accel.throughput_gbps(grid)
    good = grid[tput >= 0.95 * tput.max()]
    return int(good.min()) if len(good) else int(grid[-1])


def ingress_rate_for_slo(accel: AcceleratorSpec, slo: SLO,
                         msg_bytes: int) -> float:
    """Gbps of *ingress* needed so the SLO is met at the accelerator.

    Heterogeneity-aware (Sec. 5.3.1): a compression SLO of X Gbps needs
    ingress X (input-defined); but if the SLO is on the *egress* side of a
    decompressor, ingress is X / R.  We follow the paper's convention that
    throughput SLOs are defined on the accelerator's input stream, except
    for R_EXPAND where the deliverable is the expanded output."""
    if slo.kind == SLOKind.IOPS:
        return slo.target * msg_bytes * 8 / 1e9
    if slo.kind == SLOKind.GBPS:
        if accel.r_kind == "expand":
            return slo.target / max(accel.r_value, 1e-6)
        return slo.target
    raise ValueError("latency SLOs are enforced by admission, not pacing")


def reshape_decision(accel: AcceleratorSpec, slo: SLO, msg_bytes: int,
                     *, clock_hz: float = 250e6,
                     headroom: float = 1.0) -> ShapeDecision:
    """The ReshapeDecision() of Algorithm 1 (line 20)."""
    if slo.kind == SLOKind.LATENCY:
        # a latency SLO is enforced by shaping *others* (Sec. 4.3): the
        # flow's own bucket is a generous device-speed allowance, not a
        # pacing rate — it must never be the thing queueing messages
        params = tb.params_for_gbps(accel.peak_gbps * max(headroom, 1.0),
                                    clock_hz)
        return ShapeDecision(params, None,
                             "latency SLO: device-speed allowance")
    note = []
    resize = None
    eff_msg = msg_bytes
    opt = 2 * optimal_msg_bytes(accel)  # comfortably on the flat part
    if msg_bytes > 4 * opt:
        # huge messages monopolize PCIe + accel queues (use case 1) — split
        resize = opt
        eff_msg = opt
        note.append(f"split {msg_bytes}B -> {opt}B")
    if slo.kind == SLOKind.IOPS:
        params = tb.params_for_iops(slo.target * headroom, clock_hz)
    else:
        gbps = ingress_rate_for_slo(accel, slo, eff_msg) * headroom
        params = tb.params_for_gbps(gbps, clock_hz)
        note.append(f"ingress {gbps:.2f} Gbps for SLO {slo.target}")
    if resize is not None:
        # split streams must also be paced smoothly: a few chunks of burst,
        # not a whole original message's worth
        import dataclasses as _dc
        params = _dc.replace(
            params, bkt_size=max(params.refill_rate, 4 * resize))
    return ShapeDecision(params, resize, "; ".join(note))
