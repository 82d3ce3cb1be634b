"""Named, replayable production-shaped fleet scenarios.

Port of ``src/repro/workloads/scenarios.py``.  ``ScenarioSpec.build``
takes ``device=`` as every entry point of the port does: its runtimes (and
the ``ProfileTable`` it makes when none is passed) run on the card unless
the caller passes ``device="cpu"``.  The trace files are the reference's
format byte for byte, so a trace saved by either package loads in the
other.

A ``ScenarioSpec`` composes the production-shaped generators
(``repro_torch.workloads.generators``) with a tenant mix, churn events and
SLOs into one controller-ready package: ``build()`` returns a fresh
``FleetController`` with every tenant admitted, explicit lane-ordered
arrival traces over the full horizon, and the exact ``run_kwargs`` for
``FleetController.run`` — so a whole scenario (every tenant, every
window, any mid-run churn) still rides ONE compiled engine entry.

Replayability: the arrival traces returned by ``build()`` are the exact
rows ``run`` would generate itself (``FleetController.layout_arrivals``
— same rng stream, same lane order).  ``save_trace``/``load_trace``
round-trip them through JSON or npz bit-for-bit, and
``build(arrivals=...)`` swaps a loaded trace back in: replaying a saved
trace reproduces the run's counters exactly (pinned in tests).

The registry (``register_scenario`` / ``get_scenario`` /
``scenario_names``) is what the reference's ``benchmarks/scenarios.py``
and the port's ``chip_smoke.py`` (its ``scenarios`` phase) drive: one
harness, many named scenarios, comparable outputs.

Scenario tuning convention: horizons are fixed and modest (churn-style
— quick and full benchmark modes run the SAME timeline, so committed
baselines gate CI smoke runs exactly), and every server carries a
compliant reference tenant (ids 1000+b, the paper's <1%
throughput-variance probe) plus a small-message latency tenant (ids
2000+b, the tail-latency probe) alongside the scenario traffic.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable

import numpy as np

from repro_torch.core import token_bucket as tb
from repro_torch.core.accelerator import CATALOG
from repro_torch.core.controller import FleetController, TenantEvent
from repro_torch.core.flow import SLO, FlowSpec, Path, TrafficPattern
from repro_torch.core.interconnect import ARB_RR
from repro_torch.core.profiler import ProfileTable
from repro_torch.core.runtime import ArcusRuntime
from repro_torch.core.sim import SHAPING_HW, SimConfig
from repro_torch.device import resolve_device

# registers the processes
import repro_torch.workloads.generators  # noqa: F401

#: scenario definitions assume the default runtime clock; ``build``
#: reads the actual clock off the runtimes it constructs
_CLOCK_HZ = 250e6

TenantFn = Callable[["ScenarioSpec"], "list[list[FlowSpec]]"]
EventFn = Callable[["ScenarioSpec"], "list[TenantEvent]"]


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One named scenario: generators x tenant mix x churn x SLOs.

    ``tenants`` maps the spec to per-server FlowSpec lists (admitted via
    ``admit_fleet`` — rejection at build is an error: scenarios are
    tuned to fit).  ``events`` (optional) maps the spec to the run's
    ``TenantEvent`` churn timeline.  Both are functions of the spec so a
    ``dataclasses.replace``'d variant (longer horizon, more servers)
    re-derives window-locked knobs like the adversarial burst period."""

    name: str
    description: str
    tenants: TenantFn
    events: EventFn | None = None
    servers: int = 2
    complements: tuple = (("synthetic50",),)
    window_ticks: int = 1_500
    n_windows: int = 8
    tick_cycles: int = 8
    seed: int = 17
    ref_gbps: float = 32.0
    #: mode-independent profiling horizon (see benchmarks/churn.py): the
    #: same admission decisions in quick and full benchmark runs
    profile_ticks: int = 8_000

    @property
    def total_ticks(self) -> int:
        return self.window_ticks * self.n_windows

    def window_s(self, clock_hz: float = _CLOCK_HZ) -> float:
        return self.window_ticks * self.tick_cycles / clock_hz

    def horizon_s(self, clock_hz: float = _CLOCK_HZ) -> float:
        return self.total_ticks * self.tick_cycles / clock_hz

    def build(self, *, control=None, profile: ProfileTable | None = None,
              arrivals=None, device=None) -> "BuiltScenario":
        """Materialize the scenario: fresh runtimes + controller, every
        tenant admitted, full-horizon lane-ordered arrival traces, and
        the ``run_kwargs`` that drive ``FleetController.run``.

        ``control`` is the between-window shaping policy under test
        (default ``StaticHold``); ``profile`` shares a warmed
        ``ProfileTable`` across builds so repeated builds (warm-up arm,
        timed arm) profile nothing; ``arrivals`` swaps in a replayed
        trace from ``load_trace`` instead of generating one; ``device``
        (default the card) is where the runtimes, and the table made
        here when none is passed, run."""
        device = resolve_device(device)
        profile = profile if profile is not None \
            else ProfileTable(n_ticks=self.profile_ticks, device=device)
        comps = self.complements
        rts = [ArcusRuntime([CATALOG[n] for n in comps[b % len(comps)]],
                            profile_table=profile, device=device)
               for b in range(self.servers)]
        ctrl = FleetController(rts, control=control)
        clock_hz = rts[0].clock_hz
        specs = self.tenants(self)
        acc = ctrl.admit_fleet(specs)
        rejected = [s.flow_id for lst, oks in zip(specs, acc)
                    for s, ok in zip(lst, oks) if not ok]
        if rejected:
            raise ValueError(
                f"scenario {self.name!r}: tenants {rejected} rejected at "
                "admission — scenarios must be tuned to fit their fleet")
        events = list(self.events(self)) if self.events is not None else []
        cfg = SimConfig(n_ticks=self.total_ticks,
                        tick_cycles=self.tick_cycles,
                        shaping=SHAPING_HW, arbiter=ARB_RR,
                        clock_hz=clock_hz)
        seeds = [self.seed * 7919 + b for b in range(self.servers)]
        refs = [{k: self.ref_gbps for k in range(len(ctrl.lane_map(b)))}
                for b in range(self.servers)]
        if arrivals is None:
            arrivals = [ctrl.layout_arrivals(b, cfg, seeds[b], refs[b])
                        for b in range(self.servers)]
        else:
            arrivals = [(np.asarray(t, np.int32), np.asarray(s, np.int32))
                        for t, s in arrivals]
        run_kwargs = dict(total_ticks=self.total_ticks,
                          window_ticks=self.window_ticks,
                          tick_cycles=self.tick_cycles,
                          seeds=seeds, load_ref_gbps=refs,
                          arrivals=arrivals, events=events)
        return BuiltScenario(spec=self, controller=ctrl, arrivals=arrivals,
                             run_kwargs=run_kwargs,
                             lane_maps=[ctrl.lane_map(b)
                                        for b in range(self.servers)],
                             clock_hz=clock_hz)


@dataclasses.dataclass
class BuiltScenario:
    """A materialized scenario, ready to run (or to save for replay)."""

    spec: ScenarioSpec
    controller: FleetController
    arrivals: list          # per server (times, sizes), lane order
    run_kwargs: dict[str, Any]
    lane_maps: list
    clock_hz: float

    def run(self):
        """Drive the scenario timeline; see ``FleetController.run``.
        One-shot: the controller's state advances, so build a fresh
        scenario per run (``run_kwargs``/``arrivals`` are reusable)."""
        return self.controller.run(**self.run_kwargs)


# ---------------------------------------------------------------------------
# Trace round-trip (replayable runs)
# ---------------------------------------------------------------------------


def save_trace(path, arrivals, *, meta: dict | None = None) -> None:
    """Persist per-server (times, sizes) traces to ``.json`` or ``.npz``.

    Both formats round-trip the int32 arrays exactly; ``meta`` (a
    JSON-serializable dict — scenario name, seed, ...) rides along."""
    path = os.fspath(path)
    meta = dict(meta or {})
    if path.endswith(".json"):
        payload = {"meta": meta,
                   "servers": [{"t": np.asarray(t).astype(int).tolist(),
                                "s": np.asarray(s).astype(int).tolist()}
                               for t, s in arrivals]}
        with open(path, "w") as f:
            json.dump(payload, f)
    elif path.endswith(".npz"):
        arrs: dict[str, np.ndarray] = {
            "n_servers": np.int64(len(arrivals)),
            "meta": np.asarray(json.dumps(meta))}
        for b, (t, s) in enumerate(arrivals):
            arrs[f"t{b}"] = np.asarray(t, np.int32)
            arrs[f"s{b}"] = np.asarray(s, np.int32)
        np.savez_compressed(path, **arrs)
    else:
        raise ValueError(
            f"unsupported trace format {path!r}; use .json or .npz")


def load_trace(path):
    """Inverse of ``save_trace``: returns ``(arrivals, meta)`` with
    per-server int32 (times, sizes) pairs, bit-identical to what was
    saved — feed them to ``ScenarioSpec.build(arrivals=...)``."""
    path = os.fspath(path)
    if path.endswith(".json"):
        with open(path) as f:
            payload = json.load(f)
        arrivals = [(np.asarray(sv["t"], np.int32),
                     np.asarray(sv["s"], np.int32))
                    for sv in payload["servers"]]
        return arrivals, payload.get("meta", {})
    if path.endswith(".npz"):
        with np.load(path) as z:
            meta = json.loads(str(z["meta"]))
            arrivals = [(z[f"t{b}"].astype(np.int32),
                         z[f"s{b}"].astype(np.int32))
                        for b in range(int(z["n_servers"]))]
        return arrivals, meta
    raise ValueError(f"unsupported trace format {path!r}; use .json or .npz")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

SCENARIOS: dict[str, ScenarioSpec] = {}


def register_scenario(spec: ScenarioSpec, *,
                      replace: bool = False) -> ScenarioSpec:
    if spec.name in SCENARIOS and not replace:
        raise ValueError(
            f"scenario {spec.name!r} is already registered; pass "
            "replace=True to override")
    SCENARIOS[spec.name] = spec
    return spec


def scenario_names() -> tuple[str, ...]:
    return tuple(SCENARIOS)


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; registered: "
                       f"{sorted(SCENARIOS)}") from None


# ---------------------------------------------------------------------------
# The named scenarios
# ---------------------------------------------------------------------------

#: every server carries these probes alongside its scenario traffic
REF_SLO = 8.0       # ids 1000+b: compliant poisson, the variance probe
LAT_BOUND_S = 4e-6  # ids 2000+b: small-message latency probe


def _ref_spec(b: int) -> FlowSpec:
    return FlowSpec(1000 + b, 1000 + b, Path.FUNCTION_CALL, 0,
                    TrafficPattern(1024, load=0.35, process="poisson"),
                    SLO.gbps(REF_SLO))


def _lat_spec(b: int) -> FlowSpec:
    return FlowSpec(2000 + b, 2000 + b, Path.FUNCTION_CALL, 0,
                    TrafficPattern(128, rate_mps=1.0e6, process="poisson"),
                    SLO.latency(LAT_BOUND_S))


def _with_probes(spec: ScenarioSpec, per_server) -> list[list[FlowSpec]]:
    """[ref, latency, *scenario tenants] per server — lane order."""
    return [[_ref_spec(b), _lat_spec(b)] + list(per_server(b))
            for b in range(spec.servers)]


def _mmpp_tenants(spec: ScenarioSpec) -> list[list[FlowSpec]]:
    def per_server(b):
        return [FlowSpec(100 + 10 * b + i, 100 + 10 * b + i,
                         Path.FUNCTION_CALL, 0,
                         TrafficPattern(1024, load=0.2, process="mmpp",
                                        params=(("states", (0.25, 2.5)),)),
                         SLO.gbps(6.0))
                for i in range(2)]
    return _with_probes(spec, per_server)


def _heavytail_tenants(spec: ScenarioSpec) -> list[list[FlowSpec]]:
    def per_server(b):
        pareto = TrafficPattern(1024, load=0.2, process="heavytail",
                                params=(("dist", "pareto"),
                                        ("alpha", 1.4),
                                        ("max_bytes", 128 * 1024)))
        logn = TrafficPattern(1024, load=0.2, process="heavytail",
                              params=(("dist", "lognormal"),
                                      ("sigma", 1.2),
                                      ("max_bytes", 128 * 1024)))
        return [FlowSpec(100 + 10 * b, 100 + 10 * b, Path.FUNCTION_CALL, 0,
                         pareto, SLO.gbps(6.0)),
                FlowSpec(101 + 10 * b, 101 + 10 * b, Path.FUNCTION_CALL, 0,
                         logn, SLO.gbps(6.0))]
    return _with_probes(spec, per_server)


def _diurnal_tenants(spec: ScenarioSpec) -> list[list[FlowSpec]]:
    def per_server(b):
        # anti-phase day/night swing across servers, plus a corrburst
        # tenant per server sharing ONE epoch stream (group 7): the
        # bursts land at the same instants fleet-wide
        diurnal = TrafficPattern(1024, load=0.2, process="diurnal",
                                 params=(("amp", 0.9),
                                         ("phase", 0.5 * b)))
        corr = TrafficPattern(1024, load=0.25, process="corrburst",
                              params=(("group", 7),
                                      ("burst_hz", 40_000.0),
                                      ("burst_len", 16)))
        return [FlowSpec(100 + 10 * b, 100 + 10 * b, Path.FUNCTION_CALL, 0,
                         diurnal, SLO.gbps(6.0)),
                FlowSpec(101 + 10 * b, 101 + 10 * b, Path.FUNCTION_CALL, 0,
                         corr, SLO.gbps(7.0))]
    return _with_probes(spec, per_server)


def _flash_tenants(spec: ScenarioSpec) -> list[list[FlowSpec]]:
    def per_server(b):
        flash = TrafficPattern(1024, load=0.15, process="flash",
                               params=(("at", 0.25), ("mult", 6.0)))
        return [FlowSpec(100 + 10 * b, 100 + 10 * b, Path.FUNCTION_CALL, 0,
                         flash, SLO.gbps(5.0))]
    return _with_probes(spec, per_server)


def _flash_events(spec: ScenarioSpec) -> list[TenantEvent]:
    """Opportunist tenants arrive mid-storm (window 2 of the default
    8): admission + lane splice while the flash crowd is still hot."""
    return [TenantEvent.arrive(
        2,
        FlowSpec(300 + b, 300 + b, Path.FUNCTION_CALL, 0,
                 TrafficPattern(1024, load=0.3, process="poisson"),
                 SLO.gbps(4.0)),
        server=b, accel_name="synthetic50")
        for b in range(spec.servers)]


def _adversarial_tenants(spec: ScenarioSpec) -> list[list[FlowSpec]]:
    slo = 6.0
    depth = tb.params_for_gbps(slo).bkt_size
    window_s = spec.window_s()
    # the worst compliant probe: bursts of exactly the bucket depth,
    # phase-locked to window edges, spaced by the smallest whole number
    # of windows over which the refill fully replenishes the bucket —
    # every burst is admitted wholesale, yet the average rate stays
    # under the SLO
    period = float(np.ceil((depth * 8.0 / (slo * 1e9)) / window_s)
                   * window_s)
    nmsg = int(np.ceil(depth / 1024))
    adv = TrafficPattern(1024, rate_mps=nmsg / period, process="adversarial",
                         params=(("bucket_bytes", depth),
                                 ("period_s", period),
                                 ("phase_s", 0.0),
                                 ("line_gbps", 100.0)))

    def per_server(b):
        return [FlowSpec(100 + 10 * b, 100 + 10 * b, Path.FUNCTION_CALL, 0,
                         adv, SLO.gbps(slo))]
    return _with_probes(spec, per_server)


register_scenario(ScenarioSpec(
    name="mmpp_surge",
    description="Markov-modulated Poisson tenants cycling quiet/surge "
                "(10x relative swing) around a compliant mean",
    tenants=_mmpp_tenants))

register_scenario(ScenarioSpec(
    name="heavy_tail",
    description="Poisson arrivals with heavy-tailed message sizes "
                "(Pareto a=1.4 and lognormal s=1.2, mean 1 KiB)",
    tenants=_heavytail_tenants))

register_scenario(ScenarioSpec(
    name="diurnal_corr",
    description="Anti-phase diurnal load swing across servers plus "
                "cross-server correlated burst epochs (shared group)",
    tenants=_diurnal_tenants))

register_scenario(ScenarioSpec(
    name="flash_crowd",
    description="Flash crowd (6x surge, exponential decay) with "
                "opportunist tenants arriving mid-storm",
    tenants=_flash_tenants, events=_flash_events))

register_scenario(ScenarioSpec(
    name="adversarial_probe",
    description="Token-bucket boundary prober: bucket-depth bursts "
                "phase-locked to window edges, compliant on average",
    tenants=_adversarial_tenants))
