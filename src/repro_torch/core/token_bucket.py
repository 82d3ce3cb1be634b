"""Per-flow token-bucket rate limiter (Arcus §4.2), vectorized over flows.

Port of ``src/repro/core/token_bucket.py``.  The state is a ``TBState`` of
int32 tensors; ``init``, ``advance``, ``cost_of``, ``try_admit`` and
``consume`` are plain PyTorch functions with the reference's exact int32
semantics (floor ``//`` and ``%``; two's-complement wraparound of
``tokens + k * refill``, which the unshaped profiling registers hit on their
first refill).  The planners (``params_for_gbps`` ...) are pure Python and
copied verbatim.

Semantics:
  * state: tokens[N], cyc[N] residual cycle counter
  * advance by E cycles:  k = (cyc + E) // interval  refills happen,
      tokens <- min(bkt_size, tokens + k * refill_rate)
      cyc    <- (cyc + E) % interval
  * admit(msg_bytes): cost = msg_bytes (GBPS mode) or 1 (IOPS mode);
      admitted iff tokens >= cost; on admit tokens -= cost.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

MODE_GBPS = 0
MODE_IOPS = 1


class TBState(NamedTuple):
    """Vectorized bucket state + parameter 'registers' for N flows."""

    tokens: torch.Tensor       # [N] int32 current tokens
    cyc: torch.Tensor          # [N] int32 residual cycles since last refill
    refill_rate: torch.Tensor  # [N] int32 tokens added per interval
    bkt_size: torch.Tensor     # [N] int32 bucket capacity
    interval: torch.Tensor     # [N] int32 cycles between refills
    mode: torch.Tensor         # [N] int32 MODE_GBPS / MODE_IOPS


def _i32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound.  The conversion is
    modular on every device (a static_cast), unlike an overflowing int32
    multiply-add, so int32 arithmetic that may overflow is done in int64
    and wrapped here."""
    return x.to(torch.int32)


def init(refill_rate, bkt_size, interval, mode, start_full: bool = True,
         *, device=None) -> TBState:
    """Fresh bucket state.  ``tokens`` is a *copy* of ``bkt_size`` (the
    reference shares one buffer; the port updates tokens in place, which
    would write through such an alias)."""
    refill_rate = _i32(refill_rate, device)
    bkt_size = _i32(bkt_size, device)
    interval = _i32(interval, device)
    mode = _i32(mode, device)
    tokens = bkt_size.clone() if start_full else torch.zeros_like(bkt_size)
    return TBState(tokens, torch.zeros_like(bkt_size), refill_rate, bkt_size,
                   interval, mode)


def advance(state: TBState, elapsed_cycles) -> TBState:
    """Advance hardware timers by `elapsed_cycles`; perform due refills."""
    e = _i32(elapsed_cycles, state.cyc.device)
    total = state.cyc + e
    k = torch.div(total, state.interval, rounding_mode="floor")
    cyc = torch.remainder(total, state.interval)
    # clamp the applied refills: one bucket's worth already saturates it
    k = torch.minimum(k, torch.div(state.bkt_size,
                                   torch.clamp(state.refill_rate, min=1),
                                   rounding_mode="floor") + 1)
    tok = wrap_i32(state.tokens.long() + k.long() * state.refill_rate.long())
    tok = torch.minimum(tok, state.bkt_size)
    return state._replace(tokens=tok, cyc=cyc.to(torch.int32))


def cost_of(state: TBState, msg_bytes) -> torch.Tensor:
    msg_bytes = _i32(msg_bytes, state.mode.device)
    return torch.where(state.mode == MODE_GBPS, msg_bytes,
                       torch.ones_like(msg_bytes)).to(torch.int32)


def try_admit(state: TBState, msg_bytes, want) -> tuple[TBState,
                                                         torch.Tensor]:
    """Attempt to admit one head-of-line message per flow.

    want[N] bool: flow actually has a message to offer.
    Returns (new_state, admitted[N] bool)."""
    cost = cost_of(state, msg_bytes)
    want = torch.as_tensor(want, device=state.tokens.device).to(torch.bool)
    ok = want & (state.tokens >= cost)
    tok = torch.where(ok, state.tokens - cost, state.tokens)
    return state._replace(tokens=tok), ok


def consume(state: TBState, amount) -> TBState:
    """Unconditionally consume tokens (used after an arbiter grant)."""
    return state._replace(
        tokens=state.tokens - _i32(amount, state.tokens.device))


# ---------------------------------------------------------------------------
# Parameter planning (control plane; Arcus Table 2) — verbatim reference copy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TBParams:
    refill_rate: int
    bkt_size: int
    interval: int
    mode: int = MODE_GBPS


#: Arcus Table 2 — the paper's published parameter table for Gbps shaping at
#: 250 MHz (tokens = bytes).
PAPER_TABLE2 = {
    1: TBParams(refill_rate=1024, bkt_size=512, interval=1000),
    10: TBParams(refill_rate=4096, bkt_size=4096, interval=800),
    100: TBParams(refill_rate=16384, bkt_size=65536, interval=320),
    1000: TBParams(refill_rate=32768, bkt_size=1048576, interval=64),
}


def params_for_gbps(slo_gbps: float, clock_hz: float = 250e6, *,
                    bkt_size: int | None = None,
                    max_interval: int = 1024) -> TBParams:
    """Derive (Refill_Rate, Interval, Bkt_Size) for a Gbps SLO: the longest
    interval whose integer refill rate best matches the target bytes per
    cycle (the paper's recipe)."""
    target_Bps = slo_gbps * 1e9 / 8.0
    per_cycle = target_Bps / clock_hz  # bytes per cycle
    best = None
    for interval in range(max_interval, 0, -1):
        refill = per_cycle * interval
        if refill < 1:
            continue
        r = int(round(refill))
        err = abs(r / interval - per_cycle) / per_cycle
        if best is None or err < best[0] - 1e-12:
            best = (err, r, interval)
        if err == 0.0:
            break
    assert best is not None, "SLO too small for cycle-level shaping"
    _, refill, interval = best
    if bkt_size is None:
        # large-ish bucket: insensitive to bursts / size variation (§5.2)
        bkt_size = int(max(512, min(1 << 20, 16 * refill)))
    # invariant: a bucket smaller than one refill chunk clips the rate
    bkt_size = max(bkt_size, refill)
    return TBParams(refill, bkt_size, interval, MODE_GBPS)


def params_for_iops(slo_iops: float, clock_hz: float = 250e6, *,
                    burst: int = 64, max_interval: int = 1 << 28) -> TBParams:
    """IOPS mode: tokens are messages.  interval = refill * clock / iops for
    small refills, picking the pair with the least rate error."""
    best = None
    for refill in range(1, 65):
        interval = int(round(refill * clock_hz / slo_iops))
        if interval < 1 or interval > max_interval:
            continue
        err = abs(refill / interval * clock_hz - slo_iops) / slo_iops
        if best is None or err < best[0] - 1e-12:
            best = (err, refill, interval)
        if err == 0.0:
            break
    assert best is not None, (slo_iops, clock_hz)
    _, refill, interval = best
    return TBParams(refill, max(burst, refill), interval, MODE_IOPS)


def achieved_rate(params: TBParams, clock_hz: float = 250e6) -> float:
    """Long-run shaped rate (bytes/s or msgs/s) implied by the registers."""
    return params.refill_rate / params.interval * clock_hz


def pack(params_list: list[TBParams], *, start_full: bool = True,
         device=None) -> TBState:
    """Build a vectorized TBState from per-flow parameter plans."""
    return init(
        np.array([p.refill_rate for p in params_list], np.int32),
        np.array([p.bkt_size for p in params_list], np.int32),
        np.array([p.interval for p in params_list], np.int32),
        np.array([p.mode for p in params_list], np.int32),
        start_full=start_full, device=device,
    )
