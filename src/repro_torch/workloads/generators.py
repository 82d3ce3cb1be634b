"""Production-shaped arrival-trace generators.

Port of ``src/repro/workloads/generators.py``: the handlers are the
reference's numpy code, verbatim, so same-seed traces are byte-identical
to it.  Trace generation is host-side numpy and takes no device.

The repo's historical timelines are synthetic rate sweeps over three
arrival processes (cbr / poisson / onoff).  This module opens the
scenario space with the processes production traffic actually exhibits —
the regimes where "SLO beyond the Hardware Isolation Limits" warns that
isolation which holds at steady state breaks:

* ``mmpp``       — Markov-modulated Poisson: the flow cycles through
                   rate states (e.g. quiet / surge) with exponential
                   sojourns; the long-run mean equals the nominal rate.
* ``heavytail``  — Poisson arrivals with heavy-tailed message sizes
                   (Pareto or lognormal, mean pinned to ``msg_bytes``).
* ``diurnal``    — nonhomogeneous Poisson with a sinusoidal rate curve
                   (the day/night load swing, squeezed into the horizon).
* ``corrburst``  — correlated cross-tenant bursts: every flow sharing a
                   ``group`` id bursts at the SAME epochs (a deploy, a
                   cache flush, a market open), plus base Poisson load.
* ``flash``      — flash crowd: baseline Poisson until ``at`` of the
                   horizon, then the rate jumps ``mult``x and decays
                   exponentially back to baseline.
* ``adversarial``— a tenant that probes token-bucket boundaries:
                   deterministic back-to-back bursts sized to the bucket
                   depth, phase-locked to window edges — the worst
                   compliant-on-average traffic a shaper admits.

All of them are registered into ``repro_torch.core.sim``'s arrival-process
registry on import, so ``TrafficPattern(process="mmpp", params=...)``
flows through every existing trace consumer — ``gen_arrivals``,
``stack_arrivals``/``simulate_batch``, ``baselines.run_system_batch``
and ``FleetController.run`` — and a whole scenario still rides ONE
compiled engine entry.  Knobs ride ``TrafficPattern.params`` (a tuple of
``(name, value)`` pairs; see each handler's docstring).

Determinism: every handler draws only from ``gen_arrivals``'s shared,
seeded rng (``corrburst`` epochs intentionally come from the ``group``
id instead, so correlation survives across seeds and tenant subsets),
and handlers run in registration order — same seed, same trace,
byte-for-byte (digest-pinned in tests).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.engine import SimConfig
from repro_torch.core.flow import (SLO, FlowSet, FlowSpec, Path,
                                   TrafficPattern)
from repro_torch.core.sim import gen_arrivals, register_process

#: inversion-grid resolution for nonhomogeneous-Poisson rate curves —
#: closed-form cumulative intensities sampled this finely keep the
#: interpolation error far below a tick
_NHPP_GRID = 4097


def _invert_nhpp(rng, t_grid: np.ndarray, lam_grid: np.ndarray,
                 M0: int) -> np.ndarray:
    """One nonhomogeneous-Poisson row by inversion: unit-rate exponential
    levels mapped through the inverse cumulative intensity Λ^-1 (linear
    interpolation on a monotone (t, Λ) grid).  Levels beyond Λ(horizon)
    clamp at the horizon — ``gen_arrivals`` trims them as invalid."""
    u = np.cumsum(rng.exponential(1.0, M0))
    t = np.interp(u, lam_grid, t_grid)
    return np.diff(t, prepend=0.0)


# ---------------------------------------------------------------------------
# mmpp
# ---------------------------------------------------------------------------


def _mmpp_weights(pat: TrafficPattern) -> tuple[np.ndarray, np.ndarray,
                                                float]:
    """(state multipliers, mean sojourn weights, weighted-mean multiplier)
    — the normalizer that pins the long-run mean to the nominal rate."""
    mults = np.asarray(pat.param("states", (0.25, 2.5)), float)
    soj = pat.param("sojourn_s", None)
    if soj is None:
        w = np.ones_like(mults)
    else:
        w = np.broadcast_to(np.asarray(soj, float), mults.shape)
    wmean = float((mults * w).sum() / w.sum())
    return mults, w, max(wmean, 1e-12)


def _mmpp_gaps(pats, rates, rng, M0, horizon_s):
    """Markov-modulated Poisson (cyclic state chain).

    params: ``states`` — per-state rate multipliers (default
    ``(0.25, 2.5)``: a quiet state and a 10x-relative surge);
    ``sojourn_s`` — mean sojourn per state in seconds (scalar or
    per-state; default ``horizon / 6`` so a run sees several
    transitions).  State rates are normalized by the sojourn-weighted
    mean multiplier, so the long-run mean rate equals the nominal
    pattern rate regardless of the state mix."""
    out = np.empty((len(pats), M0))
    for j, (pat, rate) in enumerate(zip(pats, rates)):
        mults, _w, wmean = _mmpp_weights(pat)
        soj = pat.param("sojourn_s", None)
        if soj is None:
            soj = horizon_s / 6.0
        soj = np.broadcast_to(np.asarray(soj, float), mults.shape)
        # state timeline: exponential sojourns, cyclic state order
        t_knots, lam_knots = [0.0], [0.0]
        s, t = 0, 0.0
        while t < horizon_s:
            dur = rng.exponential(soj[s])
            lam = rate * mults[s] / wmean
            t += dur
            t_knots.append(t)
            lam_knots.append(lam_knots[-1] + lam * dur)
            s = (s + 1) % len(mults)
        out[j] = _invert_nhpp(rng, np.asarray(t_knots),
                              np.asarray(lam_knots), M0)
    return out


def _mmpp_budget(pat, rate, horizon_s):
    mults, _w, wmean = _mmpp_weights(pat)
    # worst case: the realized timeline dwells in the hottest state
    return float(mults.max()) / wmean + 0.05


# ---------------------------------------------------------------------------
# heavytail
# ---------------------------------------------------------------------------


def _heavytail_gaps(pats, rates, rng, M0, horizon_s):
    """Poisson arrivals, heavy-tailed sizes with mean ``msg_bytes``.

    params: ``dist`` — ``"pareto"`` (default) or ``"lognormal"``;
    ``alpha`` — Pareto shape (> 1; default 1.5, infinite variance);
    ``sigma`` — lognormal shape (default 1.0); ``max_bytes`` — size cap
    (default 1 MiB, the engine's shared accel-buffer scale)."""
    k = len(pats)
    gaps = rng.exponential(1.0, (k, M0)) / rates[:, None]
    sizes = np.empty((k, M0), np.int64)
    for j, pat in enumerate(pats):
        dist = pat.param("dist", "pareto")
        cap = int(pat.param("max_bytes", 1 << 20))
        mean = float(max(pat.msg_bytes, 1))
        if dist == "pareto":
            alpha = float(pat.param("alpha", 1.5))
            if alpha <= 1.0:
                raise ValueError(
                    f"heavytail pareto needs alpha > 1 (got {alpha}) — "
                    "the mean diverges otherwise")
            xm = mean * (alpha - 1.0) / alpha
            raw = xm * (1.0 + rng.pareto(alpha, M0))
        elif dist == "lognormal":
            sigma = float(pat.param("sigma", 1.0))
            mu = np.log(mean) - sigma * sigma / 2.0
            raw = rng.lognormal(mu, sigma, M0)
        else:
            raise ValueError(
                f"unknown heavytail dist {dist!r}; expected 'pareto' or "
                "'lognormal'")
        sizes[j] = np.clip(raw, 1, cap).astype(np.int64)
    return gaps, sizes


# ---------------------------------------------------------------------------
# diurnal
# ---------------------------------------------------------------------------


def _diurnal_gaps(pats, rates, rng, M0, horizon_s):
    """Nonhomogeneous Poisson with a sinusoidal rate curve:
    ``rate(t) = rate * (1 + amp * sin(2π (t/period + phase)))``.

    params: ``period_s`` — curve period (default: the horizon, one full
    day squeezed into the run); ``amp`` — swing amplitude in [0, 1)
    (default 0.8); ``phase`` — phase offset in periods (default 0)."""
    out = np.empty((len(pats), M0))
    t_grid = np.linspace(0.0, horizon_s, _NHPP_GRID)
    for j, (pat, rate) in enumerate(zip(pats, rates)):
        period = float(pat.param("period_s", horizon_s))
        amp = float(np.clip(pat.param("amp", 0.8), 0.0, 0.999))
        phase = float(pat.param("phase", 0.0))
        w = 2.0 * np.pi / period
        # Λ(t) = r t - (r amp / w) (cos(w t + φ0) - cos φ0)
        phi0 = 2.0 * np.pi * phase
        lam_grid = rate * (t_grid - (amp / w)
                           * (np.cos(w * t_grid + phi0) - np.cos(phi0)))
        out[j] = _invert_nhpp(rng, t_grid, lam_grid, M0)
    return out


def _diurnal_budget(pat, rate, horizon_s):
    return 1.0 + float(np.clip(pat.param("amp", 0.8), 0.0, 0.999)) + 0.05


# ---------------------------------------------------------------------------
# corrburst
# ---------------------------------------------------------------------------


def _corrburst_gaps(pats, rates, rng, M0, horizon_s):
    """Correlated cross-tenant bursts on top of base Poisson load.

    Every flow sharing a ``group`` id bursts at the SAME epochs —
    drawn from a dedicated rng seeded by the group id, NOT the trace
    seed, so correlation holds across tenants generated in different
    ``gen_arrivals`` calls (different servers, different seeds).

    params: ``group`` — shared-epoch stream id (default 0);
    ``burst_hz`` — epoch rate (default 2000); ``burst_len`` — messages
    per burst (default 32); ``line_gbps`` — in-burst injection speed
    (default 100).  Base Poisson load runs at
    ``max(rate - burst_hz * burst_len, 0)`` so the mean stays ``rate``.
    """
    out = np.empty((len(pats), M0))
    epoch_cache: dict[tuple[int, float], np.ndarray] = {}
    for j, (pat, rate) in enumerate(zip(pats, rates)):
        group = int(pat.param("group", 0))
        burst_hz = float(pat.param("burst_hz", 2000.0))
        burst_len = int(pat.param("burst_len", pat.burst_len))
        line = float(pat.param("line_gbps", 100.0))
        key = (group, burst_hz)
        if key not in epoch_cache:
            grng = np.random.default_rng(0x5EED0000 + group)
            n_ep = int(round(burst_hz * horizon_s))
            epoch_cache[key] = np.sort(grng.uniform(0.0, horizon_s, n_ep))
        epochs = epoch_cache[key]
        intra = max(pat.msg_bytes, 1) * 8.0 / (line * 1e9)
        bursts = (epochs[:, None]
                  + np.arange(burst_len) * intra).ravel()
        base_rate = max(rate - burst_hz * burst_len, 0.0)
        base = np.cumsum(rng.exponential(1.0, M0)) \
            / max(base_rate, 1e-9)
        merged = np.sort(np.concatenate([bursts, base]))[:M0]
        out[j] = np.diff(merged, prepend=0.0)
    return out


def _corrburst_budget(pat, rate, horizon_s):
    burst_hz = float(pat.param("burst_hz", 2000.0))
    burst_len = int(pat.param("burst_len", pat.burst_len))
    # bursts are a fixed msgs/s floor even when the nominal rate is lower
    return max(1.0, burst_hz * burst_len / max(rate, 1e-9)) + 0.25


# ---------------------------------------------------------------------------
# flash
# ---------------------------------------------------------------------------


def _flash_gaps(pats, rates, rng, M0, horizon_s):
    """Flash crowd: baseline Poisson, then at ``at`` of the horizon the
    rate jumps ``mult``x and decays exponentially back to baseline.

    params: ``at`` — storm onset as a fraction of the horizon (default
    0.3); ``mult`` — peak rate multiplier (default 8.0); ``decay_s`` —
    decay time constant (default ``horizon / 8``)."""
    out = np.empty((len(pats), M0))
    t_grid = np.linspace(0.0, horizon_s, _NHPP_GRID)
    for j, (pat, rate) in enumerate(zip(pats, rates)):
        t0 = float(pat.param("at", 0.3)) * horizon_s
        mult = float(pat.param("mult", 8.0))
        tau = float(pat.param("decay_s", horizon_s / 8.0))
        # Λ(t) = r t + r (mult-1) τ (1 - exp(-(t-t0)/τ)) for t >= t0
        extra = np.where(
            t_grid >= t0,
            rate * (mult - 1.0) * tau
            * (1.0 - np.exp(-np.maximum(t_grid - t0, 0.0) / tau)),
            0.0)
        lam_grid = rate * t_grid + extra
        out[j] = _invert_nhpp(rng, t_grid, lam_grid, M0)
    return out


def _flash_budget(pat, rate, horizon_s):
    mult = float(pat.param("mult", 8.0))
    tau = float(pat.param("decay_s", horizon_s / 8.0))
    return 1.0 + (mult - 1.0) * min(tau / max(horizon_s, 1e-12), 1.0) + 0.1


# ---------------------------------------------------------------------------
# adversarial
# ---------------------------------------------------------------------------


def _adversarial_gaps(pats, rates, rng, M0, horizon_s):
    """Token-bucket boundary probing — deterministic, no rng.

    Every ``period_s`` (phase-lock it to the control loop's window) the
    tenant injects one back-to-back burst of exactly ``bucket_bytes``
    (the depth of its shaped bucket) at ``line_gbps``, then goes silent
    while the bucket refills.  On average the flow stays at
    ``bucket_bytes * 8 / period_s`` bits/s — compliant — while
    concentrating every byte into the instant the shaper can least
    smooth, maximizing the queueing it induces on co-located tenants.

    params: ``bucket_bytes`` — burst size, sized to the victim bucket's
    depth (default 64 KiB); ``period_s`` — burst period (default 48 us);
    ``phase_s`` — offset after each period edge (default 0);
    ``line_gbps`` — in-burst injection speed (default 100)."""
    out = np.empty((len(pats), M0))
    for j, pat in enumerate(pats):
        bucket = int(pat.param("bucket_bytes", 64 * 1024))
        period = float(pat.param("period_s", 48e-6))
        phase = float(pat.param("phase_s", 0.0))
        line = float(pat.param("line_gbps", 100.0))
        nmsg = max(1, int(np.ceil(bucket / max(pat.msg_bytes, 1))))
        intra = max(pat.msg_bytes, 1) * 8.0 / (line * 1e9)
        n_per = int(np.floor(horizon_s / period)) + 1
        times = (phase + period * np.arange(n_per)[:, None]
                 + np.arange(nmsg) * intra).ravel()[:M0]
        if times.size < M0:      # pad past the horizon (trimmed later)
            pad = horizon_s + period * (1.0 + np.arange(M0 - times.size))
            times = np.concatenate([times, pad])
        out[j] = np.diff(times, prepend=0.0)
    return out


def _adversarial_budget(pat, rate, horizon_s):
    bucket = int(pat.param("bucket_bytes", 64 * 1024))
    period = float(pat.param("period_s", 48e-6))
    nmsg = max(1, int(np.ceil(bucket / max(pat.msg_bytes, 1))))
    return max(1.0, nmsg / (period * max(rate, 1e-9))) + 0.1


register_process("mmpp", _mmpp_gaps, budget=_mmpp_budget)
register_process("heavytail", _heavytail_gaps)
register_process("diurnal", _diurnal_gaps, budget=_diurnal_budget)
register_process("corrburst", _corrburst_gaps, budget=_corrburst_budget)
register_process("flash", _flash_gaps, budget=_flash_budget)
register_process("adversarial", _adversarial_gaps,
                 budget=_adversarial_budget)


# ---------------------------------------------------------------------------
# Standalone trace emission
# ---------------------------------------------------------------------------


def make_trace(patterns: "TrafficPattern | list[TrafficPattern]",
               *, n_ticks: int, tick_cycles: int = 8,
               clock_hz: float = 250e6, seed: int = 0,
               ref_gbps: float = 32.0) -> tuple[np.ndarray, np.ndarray]:
    """Emit one (times, sizes) arrival trace for ad-hoc patterns.

    A thin wrapper over ``sim.gen_arrivals`` (the ONE trace code path —
    digests pinned there cover this too): builds throwaway FlowSpecs
    around the patterns and returns ``[N, M]`` int32 cycle times and
    byte sizes, ready for ``stack_arrivals`` / ``simulate_batch`` /
    ``run_system_batch``."""
    if isinstance(patterns, TrafficPattern):
        patterns = [patterns]
    specs = [FlowSpec(i, i, Path.FUNCTION_CALL, 0, p, SLO.gbps(1.0))
             for i, p in enumerate(patterns)]
    cfg = SimConfig(n_ticks=n_ticks, tick_cycles=tick_cycles,
                    clock_hz=clock_hz)
    return gen_arrivals(FlowSet.build(specs), cfg, seed=seed,
                        load_ref_gbps={i: ref_gbps
                                       for i in range(len(specs))})
