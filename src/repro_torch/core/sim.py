"""Cycle-accurate Arcus dataplane simulator: host-side surface.

Port of ``src/repro/core/sim.py``.  It executes the Arcus dataplane protocol
(Sec. 4.1) at cycle granularity:

    per-flow queues -> [token-bucket shaper] -> arbiter -> ingress link
        -> heterogeneous accelerator (lanes, non-linear service curve)
        -> egress link -> completion

vectorized over flows, stepped over time (1 tick = `tick_cycles` FPGA
cycles at 250 MHz).  The tick loop lives in ``repro_torch.core.engine``;
this module keeps trace generation (the reference's numpy code, verbatim,
so same-seed traces are byte-identical), result collection, ``simulate``
and its batched form ``simulate_batch`` (with ``stack_arrivals``): B
independent simulations as one batch of the engine, each element's result
bitwise what a serial ``simulate`` of it gives.

Shaping modes:
  SHAPING_NONE — no traffic shaping (Host_noTS / Bypassed_noTS_panic)
  SHAPING_HW   — Arcus: cycle-accurate token buckets in 'hardware'
  SHAPING_SW   — software shaping: the same token buckets, but timer refills
                 and admissions stall whenever the host is descheduled
                 (stall mask), and every message pays a jittered
                 host-processing delay.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import engine
from repro_torch.core import token_bucket as tb
from repro_torch.core.accelerator import AccelTable
from repro_torch.core.engine import (INF_I32, SHAPING_HW,  # noqa: F401
                                     SHAPING_NONE, SHAPING_SW, SimConfig)
from repro_torch.core.flow import FlowSet
from repro_torch.core.interconnect import LinkSpec

# ---------------------------------------------------------------------------
# Arrival-trace generation (host side, numpy — vectorized over flows)
# ---------------------------------------------------------------------------
#
# Arrival processes are pluggable: ``register_process`` maps a
# ``TrafficPattern.process`` name to a gap generator, so workload packages
# add production-shaped processes without editing this module.  Handlers run
# in REGISTRATION order and draw from the one shared ``rng`` stream, exactly
# as in the reference, so same-seed traces are byte-identical to it (the
# pinned digests of tests/test_dataplane_sim.py gate this).


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """One registered arrival process.

    ``gaps(pats, rates, rng, M0, horizon_s)`` receives the subset of
    patterns using this process (flow order), their nominal mean rates
    (msgs/s), the shared generator, the trace width and the horizon in
    seconds.  It returns inter-arrival gaps ``[k, M0]`` in seconds — or a
    ``(gaps, sizes)`` tuple when the process also draws message sizes
    (``sizes`` int64 bytes ``[k, M0]``; ``None`` keeps the default
    msg_bytes/bimodal sizing).

    ``budget(pattern, rate, horizon_s)`` returns the message-budget factor
    vs the nominal ``rate * horizon`` count — a bursty process whose peak
    rate exceeds its mean must claim the extra columns here or its trace
    is silently truncated at the nominal budget.
    """

    name: str
    gaps: "callable"
    budget: "callable | float" = 1.0

    def budget_factor(self, pattern, rate: float, horizon_s: float) -> float:
        if callable(self.budget):
            return float(self.budget(pattern, rate, horizon_s))
        return float(self.budget)


#: name -> ArrivalProcess, in registration order (= handler draw order)
_PROCESSES: dict[str, ArrivalProcess] = {}


def register_process(name: str, gaps, *, budget=1.0,
                     replace: bool = False) -> ArrivalProcess:
    """Register an arrival process for ``TrafficPattern(process=name)``.

    Handlers draw from ``gen_arrivals``'s shared rng in registration
    order, so registering a new process never perturbs the random stream
    of traces that do not use it (pinned same-seed digests stay pinned).
    Re-registering an existing name raises unless ``replace`` is set."""
    if name in _PROCESSES and not replace:
        raise ValueError(f"arrival process {name!r} is already registered "
                         "(pass replace=True to override)")
    proc = ArrivalProcess(name, gaps, budget)
    _PROCESSES[name] = proc
    return proc


def registered_processes() -> tuple[str, ...]:
    """Registered process names, in registration (= draw) order."""
    return tuple(_PROCESSES)


def _cbr_gaps(pats, rates, rng, M0, horizon_s):
    return np.broadcast_to(1.0 / rates[:, None], (len(pats), M0))


def _poisson_gaps(pats, rates, rng, M0, horizon_s):
    return rng.exponential(1.0, (len(pats), M0)) / rates[:, None]


def _onoff_gaps(pats, rates, rng, M0, horizon_s):
    col = np.arange(M0)
    bl = np.array([p.burst_len for p in pats])[:, None]
    duty = np.array([p.duty for p in pats])[:, None]
    period = bl / rates[:, None]
    on_gap = duty * period / bl
    # idle gap closes each burst so the average rate stays `rate`
    idle = (col[None, :] % bl) == bl - 1
    return on_gap + idle * (1 - duty) * period


register_process("cbr", _cbr_gaps)
register_process("poisson", _poisson_gaps)
register_process("onoff", _onoff_gaps)


def trace_budget(pattern, rate: float, horizon_s: float) -> int:
    """Message-column budget for one flow's trace: the nominal
    ``ceil(rate * horizon) + 16`` scaled by the process's declared burst
    factor.  Shared by ``gen_arrivals`` and the controller's mid-run
    ARRIVE reservation so spliced bursty tenants are never truncated."""
    proc = _PROCESSES.get(pattern.process)
    fac = 1.0 if proc is None else proc.budget_factor(pattern, rate,
                                                      horizon_s)
    return int(np.ceil(max(rate, 1e-9) * fac * horizon_s)) + 16


def gen_arrivals(flows: FlowSet, cfg: SimConfig, *, seed: int = 0,
                 load_ref_gbps: dict[int, float] | None = None,
                 max_msgs: int = 1 << 18) -> tuple[np.ndarray, np.ndarray]:
    """Pre-generate per-flow arrival traces.

    Returns (times[N, M] int32 cycles, sizes[N, M] int32 bytes), padded with
    INF_I32 / 0 past the end of each flow's trace.
    """
    rng = np.random.default_rng(seed)
    horizon_cycles = cfg.n_ticks * cfg.tick_cycles
    horizon_s = horizon_cycles / cfg.clock_hz
    N = flows.n
    pats = [s.pattern for s in flows.specs]
    refs = np.array([(load_ref_gbps or {}).get(i, 32.0) for i in range(N)])
    rates = np.array([max(p.rate_msgs_per_sec(r), 1e-9)
                      for p, r in zip(pats, refs)])
    procs = np.array([p.process for p in pats])
    unknown = sorted(set(procs) - set(_PROCESSES))
    if unknown:
        raise ValueError(
            f"unknown arrival process(es) {unknown}; registered: "
            f"{sorted(_PROCESSES)} (workload processes register via "
            "register_process)")
    # dense [N, M0] generation sized by the fastest flow: slow rows draw
    # more randomness than their m_i needs, but flow counts here are small
    # (tens) and M0 is capped by max_msgs, so the vectorization win
    # dominates the over-draw.  Burst-factor 1.0 (every built-in process)
    # keeps ``rates * fac`` float-identical to the pre-registry budget.
    fac = np.array([_PROCESSES[p.process].budget_factor(p, r, horizon_s)
                    for p, r in zip(pats, rates)])
    ms = np.minimum(max_msgs,
                    np.ceil(rates * fac * horizon_s) + 16).astype(np.int64)
    M0 = int(max(1, ms.max()))
    col = np.arange(M0)

    gaps = np.empty((N, M0))
    size_over: dict[int, np.ndarray] = {}
    for name, proc in _PROCESSES.items():
        idx = np.flatnonzero(procs == name)
        if idx.size == 0:
            continue
        out = proc.gaps([pats[i] for i in idx], rates[idx], rng, M0,
                        horizon_s)
        g, sz = out if isinstance(out, tuple) else (out, None)
        gaps[idx] = g
        if sz is not None:
            for j, i in enumerate(idx):
                size_over[i] = sz[j]

    t = np.cumsum(gaps, axis=1) * cfg.clock_hz
    sizes = np.broadcast_to(
        np.array([p.msg_bytes for p in pats], np.int64)[:, None],
        (N, M0)).copy()
    p2 = np.array([p.p2 for p in pats])
    bim = p2 > 0
    if bim.any():
        mask = rng.random((int(bim.sum()), M0)) < p2[bim, None]
        sz2 = np.array([p.msg_bytes2 for p in pats], np.int64)[bim, None]
        sizes[bim] = np.where(mask, np.broadcast_to(sz2, mask.shape),
                              sizes[bim])
    for i, sz in size_over.items():
        sizes[i] = np.maximum(sz, 1)

    valid = (t < horizon_cycles) & (col[None, :] < ms[:, None])
    M = int(max(1, valid.sum(axis=1).max()))
    times = np.where(valid, np.minimum(t, INF_I32 - 1), INF_I32) \
        .astype(np.int32)[:, :M]
    szs = np.where(valid, sizes, 0).astype(np.int32)[:, :M]
    return times, szs


def stack_arrivals(arrs: list[tuple[np.ndarray, np.ndarray]]
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Pad a list of (times, sizes) traces to common flow-count and trace
    length and stack to [B, N_max, M] for ``simulate_batch``.

    Ragged flow counts pad with empty lanes (arrival time INF, size 0):
    a padded lane never receives a message, so the engine's ``fl_mask``
    keeps it inert."""
    N = max(t.shape[0] for t, _ in arrs)
    M = max(t.shape[1] for t, _ in arrs)
    times = np.full((len(arrs), N, M), INF_I32, np.int32)
    sizes = np.zeros_like(times)
    for b, (t, s) in enumerate(arrs):
        times[b, :t.shape[0], :t.shape[1]] = t
        sizes[b, :s.shape[0], :s.shape[1]] = s
    return times, sizes


def gen_stall_mask(cfg: SimConfig, *, seed: int = 1,
                   stall_rate_hz: float = 2000.0,
                   stall_us: tuple[float, float] = (2.0, 40.0)) -> np.ndarray:
    """Host-descheduling process for SHAPING_SW: bursts of stalled ticks.

    `stall_rate_hz` stall events per second, each lasting Uniform(stall_us)
    microseconds — the context-switch / interrupt / softirq interference
    regime of Sec. 5.2.  Time-denominated so results are independent of
    tick_cycles."""
    rng = np.random.default_rng(seed)
    tick_s = cfg.tick_cycles / cfg.clock_hz
    mask = np.zeros(cfg.n_ticks, bool)
    p_start = stall_rate_hz * tick_s
    t = 0
    while t < cfg.n_ticks:
        if rng.random() < p_start:
            dur_s = rng.uniform(*stall_us) * 1e-6
            d = max(1, int(dur_s / tick_s))
            mask[t:t + d] = True
            t += d
        else:
            t += 1
    return mask


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimResult:
    counters: dict[str, np.ndarray]
    comp_flow: np.ndarray
    comp_lat_s: np.ndarray
    comp_t_s: np.ndarray
    comp_sz: np.ndarray
    seconds: float
    clock_hz: float

    # -- post-processing helpers (paper metrics) -----------------------
    def flow_latencies(self, flow_id: int) -> np.ndarray:
        return np.sort(self.comp_lat_s[self.comp_flow == flow_id])

    def latency_percentiles(self, flow_id: int, qs=(95, 99, 99.9)) -> dict:
        lat = self.flow_latencies(flow_id)
        if len(lat) == 0:
            return {q: float("nan") for q in qs}
        return {q: float(np.percentile(lat, q)) for q in qs}

    def throughput_samples(self, flow_id: int, window_msgs: int = 500,
                           kind: str = "iops",
                           warmup_s: float = 0.0) -> np.ndarray:
        """Fig. 6 methodology: sample throughput every `window_msgs` requests."""
        sel = (self.comp_flow == flow_id) & (self.comp_t_s >= warmup_s)
        t = np.sort(self.comp_t_s[sel])
        sz = self.comp_sz[sel]
        if len(t) < 2 * window_msgs:
            return np.array([])
        n_win = len(t) // window_msgs
        out = []
        for w in range(n_win - 1):
            dt = t[(w + 1) * window_msgs] - t[w * window_msgs]
            if dt <= 0:
                continue
            if kind == "iops":
                out.append(window_msgs / dt)
            else:  # gbps of ingress payload
                b = sz[w * window_msgs:(w + 1) * window_msgs].sum()
                out.append(b * 8 / dt / 1e9)
        return np.asarray(out)

    def mean_rate(self, flow_id: int, kind: str = "iops",
                  warmup_s: float = 0.0) -> float:
        sel = (self.comp_flow == flow_id) & (self.comp_t_s >= warmup_s)
        n = sel.sum()
        dur = self.seconds - warmup_s
        if kind == "iops":
            return float(n / dur)
        return float(self.comp_sz[sel].sum() * 8 / dur / 1e9)

    def mean_ingress_gbps(self, flow_id: int, flows: FlowSet,
                          warmup_s: float = 0.0) -> float:
        """Accelerator goodput measured at ingress (SLO accounting uses the
        input-side bytes, as the paper's traffic generator does)."""
        del flows
        return float(self.counters["c_done_bytes"][flow_id] * 8
                     / self.seconds / 1e9)


#: carry keys the host actually needs — everything else (queues, lanes,
#: rings-in-progress) stays on device between windows.
_RESULT_KEYS = ("c_adm_msgs", "c_adm_b_lo", "c_adm_b_hi", "c_done_msgs",
                "c_done_b_lo", "c_done_b_hi", "c_drops", "c_lat_sum",
                "comp_fl", "comp_lat", "comp_t", "comp_sz", "comp_n")


def combine_byte_counters(hi, lo) -> np.ndarray:
    """Recombine the engine's split lo(20 bits)/hi byte counters into exact
    int64 byte counts — the single definition of the split, shared by
    ``_collect_result`` and the fleet control plane's counter poll."""
    return (np.asarray(hi).astype(np.int64) << 20) + np.asarray(lo)


def _collect_result(host: dict, cfg: SimConfig, t0_ticks: int) -> SimResult:
    n = int(host["comp_n"])
    cap = cfg.comp_cap
    k = min(n, cap)
    # unroll ring order (oldest first) and trim scratch slot
    if n <= cap:
        order = np.arange(k)
    else:
        start = n % cap
        order = (np.arange(cap) + start) % cap
    counters = {key: host[key] for key in
                ("c_adm_msgs", "c_done_msgs", "c_drops", "c_lat_sum")}
    counters["c_adm_bytes"] = combine_byte_counters(host["c_adm_b_hi"],
                                                    host["c_adm_b_lo"])
    counters["c_done_bytes"] = combine_byte_counters(host["c_done_b_hi"],
                                                     host["c_done_b_lo"])
    return SimResult(
        counters=counters,
        comp_flow=host["comp_fl"][:cap][order],
        comp_lat_s=host["comp_lat"][:cap][order] / cfg.clock_hz,
        comp_t_s=host["comp_t"][:cap][order] / cfg.clock_hz,
        comp_sz=host["comp_sz"][:cap][order],
        seconds=(t0_ticks + cfg.n_ticks) * cfg.tick_cycles / cfg.clock_hz,
        clock_hz=cfg.clock_hz,
    )


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def simulate(flows: FlowSet, accels: AccelTable, link: LinkSpec,
             cfg: SimConfig, tb_state: tb.TBState, arr_t, arr_sz,
             stall_mask: np.ndarray | None = None,
             *, t0_ticks: int = 0, carry: dict | None = None,
             return_carry: bool = False, device=None):
    """Run the dataplane for cfg.n_ticks ticks starting at t0_ticks on
    ``device`` (default ``"cuda"``).

    Passing back the returned carry resumes the dataplane without resetting
    queues/buckets — the control plane uses this to reconfigure shaping
    parameters *between windows* while traffic keeps flowing (Sec. 5.3.1
    "Dynamism").  The carry is updated in place; use the one returned with
    ``return_carry=True``, never one passed in."""
    raw = engine.run_window(flows, accels, link, cfg, tb_state,
                            arr_t, arr_sz, stall_mask,
                            t0_ticks=t0_ticks, carry=carry, device=device)
    host = {k: raw[k].to("cpu", copy=True).numpy() for k in _RESULT_KEYS}
    result = _collect_result(host, cfg, t0_ticks)
    if return_carry:
        return result, raw
    return result


#: per-flow counter keys: ragged batch elements are sliced back to their
#: unpadded flow count before result collection
_PER_FLOW_KEYS = ("c_adm_msgs", "c_adm_b_lo", "c_adm_b_hi", "c_done_msgs",
                  "c_done_b_lo", "c_done_b_hi", "c_drops", "c_lat_sum")


def simulate_batch(flows, accels, link, cfg, tb_states,
                   arr_t: np.ndarray, arr_sz: np.ndarray,
                   stall_mask: np.ndarray | None = None,
                   *, t0_ticks: int = 0, device=None) -> list[SimResult]:
    """Run B independent simulations as one batch of the engine
    (``engine.run_window_batch``) on ``device`` (default ``"cuda"``).

    * ``tb_states``: sequence of B TBStates (per-element shaping registers);
    * ``arr_t`` / ``arr_sz``: [B, N_max, M] stacked traces
      (``stack_arrivals`` — it pads ragged flow counts);
    * ``flows``: one shared FlowSet, or a sequence of B FlowSets which may
      have *different flow counts* (padded + flow-masked in the engine);
    * ``cfg``: one shared SimConfig, or a sequence of B that differ only in
      the traced system fields (shaping mode, arbiter, software-delay
      model) — heterogeneous baseline systems batch into one call;
    * ``accels`` / ``link``: one shared value, or sequences of B for
      per-element accelerator tables / link specs; accelerator tables may
      have *different accelerator counts* (padded and ``ac_mask``-masked
      in the engine — padded rows are inert);
    * ``stall_mask``: shared [T] mask or per-element [B, T].

    Returns one SimResult per batch element, each — counters included —
    bitwise-identical to what a serial ``simulate()`` call with the same
    (unpadded) inputs produces."""
    raw = engine.run_window_batch(flows, accels, link, cfg, tb_states,
                                  arr_t, arr_sz, stall_mask,
                                  t0_ticks=t0_ticks, device=device)
    host = {k: raw[k].to("cpu", copy=True).numpy() for k in _RESULT_KEYS}
    B = host["comp_n"].shape[0]
    flows_l = flows if isinstance(flows, (list, tuple)) else [flows] * B
    cfg_l = cfg if isinstance(cfg, (list, tuple)) else [cfg] * B
    out = []
    for b in range(B):
        el = {k: v[b] for k, v in host.items()}
        n_b = flows_l[b].n
        for k in _PER_FLOW_KEYS:
            el[k] = el[k][:n_b]
        out.append(_collect_result(el, cfg_l[b], t0_ticks))
    return out
