"""Offline profiling -> Capacity(t, X, N) tables (Arcus §3.3, §4.3).

"We propose to perform offline profiling to learn Capacity(t, X, N), i.e.,
the available capacity of an accelerator X at a given time t shared by N
VMs, w.r.t. traffic patterns T, path mode combinations P, and system
settings S."

A *context* is (accelerator, [(path, msg-size bucket, load bucket)] per
flow).  For each context the profiler runs a short, unshaped, full-load
dataplane simulation and records the aggregate achievable capacity and the
per-flow split.  Entries carry a 1-bit SLO-Friendly / SLO-Violating tag,
evaluated against a concrete SLO vector at query time.

Port of ``src/repro/core/profiler.py``.  ``profile_context`` profiles one
context with ``simulate`` on the table's device; ``profile_contexts``
batches many heterogeneous contexts — different flow counts, different
accelerators — into one ragged ``simulate_batch``, and
``profile_contexts_multi`` does so across several ProfileTables (one per
client server), one batch per profiling config.  Entries are bitwise what
serial ``profile_context`` calls give.  Tables written by the reference
load with ``from_json`` (same schema, same keys).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import warnings
from typing import Sequence

import numpy as np

from repro_torch.core import baselines, token_bucket as tb
from repro_torch.core.accelerator import AccelTable, AcceleratorSpec
from repro_torch.core.flow import (PATH_EGRESS_DIR, PATH_INGRESS_DIR, SLO,
                                   FlowSet, FlowSpec, Path, TrafficPattern)
from repro_torch.core.interconnect import ARB_RR, RES_LINK, LinkSpec
from repro_torch.core.sim import (SHAPING_NONE, SimConfig, gen_arrivals,
                                  simulate, simulate_batch, stack_arrivals)
from repro_torch.device import resolve_device


def msg_bucket(msg_bytes: int) -> int:
    """Log2 bucket of the message size (64B..1MB)."""
    return int(np.clip(np.round(np.log2(max(msg_bytes, 1))), 6, 20))


def canonical_order(flows: list[tuple[Path, int, float]]) -> list[int]:
    """Indices sorting a context into canonical (path, msg bucket, load
    decile) order — the single source of truth for how
    ``CapacityEntry.per_flow_gbps`` (and any positional SLO vector fed to
    ``slo_tag``) is ordered.  Context tuples may carry a 4th element (a
    per-tenant resource-demand hint); it does not participate in the sort
    key, so hinted and unhinted contexts order identically."""
    return sorted(range(len(flows)),
                  key=lambda i: (int(flows[i][0]), msg_bucket(flows[i][1]),
                                 int(round(flows[i][2] * 10))))


def canonical_context(flows: list[tuple[Path, int, float]]
                      ) -> list[tuple[Path, int, float]]:
    """Context flows in canonical order (see ``canonical_order``)."""
    return [flows[i] for i in canonical_order(flows)]


def context_key(accel_name: str,
                flows: list[tuple[Path, int, float]]) -> str:
    """Canonical context: accel + sorted (path, msg bucket, load decile).

    A non-empty resource-demand hint (optional 4th tuple element) is
    appended to that flow's key part — a hinted tenant profiles under its
    own context.  Hint-free tuples produce keys bitwise-identical to the
    pre-vector format, so committed baselines keep hitting."""
    parts = []
    for t in canonical_context(flows):
        s = (f"{int(t[0])}.{msg_bucket(t[1])}.{int(round(t[2] * 10))}")
        if len(t) > 3 and t[3]:
            s += "~" + ",".join(f"{nm}:{ic:g}:{ec:g}"
                                for nm, ic, ec in t[3])
        parts.append(s)
    return accel_name + "|" + ";".join(parts)


@dataclasses.dataclass(init=False)
class CapacityEntry:
    """Profiled capacity of one context, as a resource vector.

    Axis 0 is always the link: ``capacity[0]`` is the measured aggregate
    ingress goodput and ``per_flow[0]`` the measured per-flow split under
    fair arbitration.  Each extra axis r >= 1 mirrors one
    ``LinkSpec.resources`` entry: ``capacity[r]`` is that axis' shaped
    capacity in Gbps and ``per_flow[r][i]`` the flow's *demand
    coefficient* — Gbps charged on the axis per Gbps of ingress goodput
    (ingress coefficient plus the egress coefficient scaled by the
    device's egress/ingress byte ratio).  Scalar positional arguments (the
    pre-vector schema) are promoted to R=1 vectors; the pre-vector
    ``capacity_gbps`` / ``per_flow_gbps`` names remain readable as
    properties and construct entries through a ``DeprecationWarning``
    shim, as in the reference."""

    capacity: list          # [R] Gbps per axis (axis 0 measured)
    per_flow: list          # [R][n]: measured split / demand coefficients
    fairness: float         # Jain's index of the link split
    ctx: str
    res_names: list         # [R] axis names (axis 0 = "link")

    def __init__(self, capacity=None, per_flow=None, fairness: float = 0.0,
                 ctx: str = "", res_names=None, *,
                 capacity_gbps=None, per_flow_gbps=None):
        if capacity_gbps is not None or per_flow_gbps is not None:
            warnings.warn(
                "CapacityEntry(capacity_gbps=..., per_flow_gbps=...) is "
                "deprecated: pass the vector fields capacity= / per_flow= "
                "(scalars are promoted to R=1)", DeprecationWarning,
                stacklevel=2)
            capacity = capacity_gbps if capacity is None else capacity
            per_flow = per_flow_gbps if per_flow is None else per_flow
        if capacity is None:
            raise TypeError("CapacityEntry requires capacity")
        if not isinstance(capacity, (list, tuple, np.ndarray)):
            capacity = [capacity]              # scalar -> R=1 degenerate
        per_flow = [] if per_flow is None else per_flow
        if not (len(per_flow) and isinstance(per_flow[0],
                                             (list, tuple, np.ndarray))):
            per_flow = [per_flow]              # flat split -> R=1
        self.capacity = [float(c) for c in capacity]
        self.per_flow = [[float(g) for g in row] for row in per_flow]
        self.fairness = float(fairness)
        self.ctx = ctx
        if res_names is None:
            res_names = [RES_LINK] + [f"res{r}"
                                      for r in range(1, len(self.capacity))]
        self.res_names = list(res_names)

    # -- the pre-vector field names, read-only (see class docstring) -----
    @property
    def capacity_gbps(self) -> float:
        return self.capacity[0]

    @property
    def per_flow_gbps(self) -> list:
        return self.per_flow[0]

    def slo_tag(self, slo_gbps: list[float], margin: float = 0.02) -> bool:
        """True = SLO-Friendly: requested SLOs fit the profiled capacity and
        no single SLO exceeds what contention lets one flow reach.

        The per-flow ceiling is ``n * per_flow_gbps[i]``: a flow whose
        contended fair split is g can at best inherit the other n-1 flows'
        arbiter rounds when shaping throttles them, i.e. ~n x g — a
        small-message flow cannot be promised a large-message flow's rate
        no matter how the others are shaped (Fig. 7 heterogeneity).
        ``slo_gbps`` aligns positionally with ``per_flow_gbps`` (canonical
        context order) when the lengths match; aggregate-style queries
        (fewer SLOs than profiled flows) are checked against the best
        single-flow ceiling.

        Defined as ``slo_margin >= 0`` — one copy of the constraint
        logic; the normalization there preserves every inequality's sign
        exactly, so decisions are identical to checking the raw
        inequalities."""
        return self.slo_margin(slo_gbps, margin) >= 0

    def _axis_demand(self, r: int, slo_gbps: list[float]) -> float:
        """Gbps the SLO vector puts on extra axis r (coefficient-weighted;
        aggregate-style queries use the worst coefficient)."""
        coefs = self.per_flow[r]
        if coefs and len(slo_gbps) == len(coefs):
            return sum(s * c for s, c in zip(slo_gbps, coefs))
        worst = max(coefs, default=1.0)
        return sum(s * worst for s in slo_gbps)

    def residual_gbps(self, slo_gbps: list[float],
                      margin: float = 0.02) -> float:
        """Profiled capacity left once the context's SLO vector is honored
        (negative = oversubscribed), minimized over every resource axis.
        The quantity best-fit placement packs on: the server whose
        post-admission residual is smallest-but-nonnegative is the
        tightest fit.  R=1 entries reduce to the link-axis residual."""
        res = self.capacity[0] * (1 - margin) - sum(slo_gbps)
        for r in range(1, len(self.capacity)):
            res = min(res, self.capacity[r] * (1 - margin)
                      - self._axis_demand(r, slo_gbps))
        return res

    def slo_margins(self, slo_gbps: list[float], margin: float = 0.02
                    ) -> list[float]:
        """Per-axis normalized headroom, aligned with ``res_names``.

        Axis 0 is the pre-vector ``slo_margin``: min of
        (limit - demand) / limit over the aggregate link capacity and the
        per-flow contention ceilings.  Each extra axis r compares the
        coefficient-weighted SLO demand against the axis' shaped
        capacity."""
        cap = self.capacity[0] * (1 - margin)
        m = (cap - sum(slo_gbps)) / max(cap, 1e-12)
        n = len(self.per_flow[0])
        ceil = [n * g * (1 - margin) for g in self.per_flow[0]]
        if n and len(slo_gbps) == n:
            pairs = zip(slo_gbps, ceil)
        else:
            best = max(ceil, default=cap)
            pairs = ((s, best) for s in slo_gbps)
        for s, c in pairs:
            m = min(m, (c - s) / max(c, 1e-12))
        out = [m]
        for r in range(1, len(self.capacity)):
            lim = self.capacity[r] * (1 - margin)
            out.append((lim - self._axis_demand(r, slo_gbps))
                       / max(lim, 1e-12))
        return out

    def slo_margin(self, slo_gbps: list[float], margin: float = 0.02
                   ) -> float:
        """Worst-case headroom across ALL resource axes: the min of
        ``slo_margins``.  Sign-consistent with ``slo_tag`` (>= 0 iff
        SLO-Friendly); the magnitude is what SLO-aware placement maximizes.
        R=1 entries reproduce the pre-vector value bitwise (the min over a
        single axis is that axis)."""
        ms = self.slo_margins(slo_gbps, margin)
        m = ms[0]
        for v in ms[1:]:
            m = min(m, v)
        return m


def _context_specs(flows: list[tuple[Path, int, float]]) -> list[FlowSpec]:
    out = []
    for i, t in enumerate(canonical_context(flows)):
        p, m, l = t[0], t[1], t[2]
        hint = tuple(tuple(h) for h in t[3]) if len(t) > 3 else ()
        out.append(FlowSpec(i, i, p, 0,
                            TrafficPattern(msg_bytes=m, load=max(l, 0.99),
                                           process="poisson"),
                            SLO.gbps(1e9), weight=1.0, res_demand=hint))
    return out


class ProfileTable:
    """The ProfileTable of Sec. 4.3 — pointer per context to profiled
    Capacity results."""

    def __init__(self, link: LinkSpec | None = None,
                 *, n_ticks: int = 60_000, tick_cycles: int = 8,
                 clock_hz: float | None = None, device=None):
        self.device = resolve_device(device)
        self.entries: dict[str, CapacityEntry] = {}
        self.link = link or LinkSpec()
        self.n_ticks = n_ticks
        self.tick_cycles = tick_cycles
        # profiling runs on the table's link clock unless explicitly
        # overridden — dataplane rates, accelerator service cycles and the
        # profiled window seconds then all derive from ONE clock, as in
        # run_managed; an explicit clock_hz wins
        self.clock_hz = float(clock_hz if clock_hz is not None
                              else self.link.clock_hz)

    def _cfg(self) -> SimConfig:
        return SimConfig(n_ticks=self.n_ticks, tick_cycles=self.tick_cycles,
                         clock_hz=self.clock_hz,
                         shaping=SHAPING_NONE, arbiter=ARB_RR)

    def _entry_from_result(self, key: str, res, n: int,
                           accel: AcceleratorSpec | None = None,
                           ctx: list | None = None) -> CapacityEntry:
        """The entry of a profiled context: the measured link axis, then
        one column per extra resource axis of the table's link."""
        per = [res.mean_ingress_gbps(i, None) for i in range(n)]
        x = np.asarray(per)
        fair = float((x.sum() ** 2) / (len(x) * (x ** 2).sum() + 1e-12))
        caps = [float(x.sum())]
        pflows = [per]
        names = [RES_LINK]
        # extra axes: shaped capacity is the axis' static cap; the per-flow
        # column is the demand coefficient the engine charges (ingress
        # coefficient + egress coefficient x the device's egress/ingress
        # byte ratio, with fabric_only axes skipping off-fabric directions)
        for rs in getattr(self.link, "resources", ()):
            coefs = []
            for t in canonical_context(ctx or []):
                p, m = Path(t[0]), float(t[1])
                hint = t[3] if len(t) > 3 else ()
                ic = ec = None
                for nm, a, b in hint:
                    if nm == rs.name:
                        ic, ec = float(a), float(b)
                        break
                if ic is None:
                    ic, ec = (accel.resource_demand(rs.name)
                              if accel is not None else (1.0, 1.0))
                if rs.fabric_only:
                    if PATH_INGRESS_DIR[p] == 2:
                        ic = 0.0
                    if PATH_EGRESS_DIR[p] == 2:
                        ec = 0.0
                if p == Path.INLINE_NIC_RX or accel is None:
                    ratio = 1.0   # full payload delivered to the host
                else:
                    ratio = float(accel.egress_bytes(m)) / max(m, 1.0)
                coefs.append(max(ic, 0.0) + ratio * max(ec, 0.0))
            caps.append(float(rs.capacity_gbps))
            pflows.append(coefs)
            names.append(rs.name)
        entry = CapacityEntry(caps, pflows, fair, key, names)
        self.entries[key] = entry
        return entry

    # -- profiling ------------------------------------------------------
    def profile_context(self, accel: AcceleratorSpec,
                        flows: list[tuple[Path, int, float]],
                        *, seed: int = 0) -> CapacityEntry:
        key = context_key(accel.name, flows)
        if key in self.entries:
            return self.entries[key]
        specs = _context_specs(flows)
        fset = FlowSet.build(specs)
        atab = AccelTable.build([accel], self.clock_hz)
        cfg = self._cfg()
        ref = {i: accel.peak_gbps for i in range(len(specs))}
        arr_t, arr_sz = gen_arrivals(fset, cfg, seed=seed, load_ref_gbps=ref)
        tbs = baselines.make_tb_state(baselines.HOST_NO_TS,
                                      [tb.TBParams(1, 1, 1)] * len(specs))
        res = simulate(fset, atab, self.link, cfg, tbs, arr_t, arr_sz,
                       device=self.device)
        return self._entry_from_result(key, res, len(specs), accel, flows)

    def profile_contexts(self,
                         contexts: Sequence[tuple[AcceleratorSpec,
                                                  list[tuple[Path, int,
                                                             float]]]],
                         *, seed: int = 0) -> list[CapacityEntry]:
        """Profile many heterogeneous contexts in ONE batch of the engine.

        ``contexts`` is a sequence of (accelerator, flows) pairs; flow
        counts may differ (the engine pads + flow-masks the batch) and each
        element carries its own accelerator table.  Already-profiled or
        duplicate contexts are deduplicated against the cache, so only the
        misses are simulated — as one ragged ``simulate_batch``.  Entries
        are bitwise-identical to what serial ``profile_context`` calls
        produce."""
        return profile_contexts_multi([(self, a, f) for a, f in contexts],
                                      seed=seed)

    def sweep(self, accel: AcceleratorSpec, *, paths=(Path.FUNCTION_CALL,),
              msg_sizes=(64, 512, 4096), loads=(0.9,),
              n_flows=(1, 2)) -> None:
        """Offline sweep: "all contention cases are swept and recorded" —
        executed as one batched ragged engine call across every context."""
        contexts = []
        for n in n_flows:
            combos = itertools.combinations_with_replacement(
                itertools.product(paths, msg_sizes, loads), n)
            contexts.extend((accel, list(combo)) for combo in combos)
        self.profile_contexts(contexts)

    # -- queries --------------------------------------------------------
    def lookup(self, accel_name: str,
               flows: list[tuple[Path, int, float]]) -> CapacityEntry | None:
        return self.entries.get(context_key(accel_name, flows))

    def capacity(self, accel: AcceleratorSpec,
                 flows: list[tuple[Path, int, float]]) -> CapacityEntry:
        """Lookup; profile on miss (the paper sweeps offline — on-miss
        profiling keeps the repo usable without a pre-baked table)."""
        hit = self.lookup(accel.name, flows)
        return hit if hit is not None else self.profile_context(accel, flows)

    # -- persistence ----------------------------------------------------
    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({k: dataclasses.asdict(v)
                       for k, v in self.entries.items()}, f, indent=1)

    @classmethod
    def from_json(cls, path: str, link: LinkSpec | None = None, *,
                  device=None) -> "ProfileTable":
        """Load a persisted table.  Both schemas are accepted: the current
        vector form (``capacity`` / ``per_flow`` / ``res_names``) and the
        pre-vector scalar form (``capacity_gbps`` / ``per_flow_gbps``) —
        scalar entries load as R=1 degenerate vectors whose ``capacity[0]``
        / ``per_flow[0]`` are bit-for-bit the persisted floats."""
        t = cls(link, device=device)
        with open(path) as f:
            for k, v in json.load(f).items():
                if "capacity_gbps" in v:       # legacy scalar schema
                    t.entries[k] = CapacityEntry(
                        v["capacity_gbps"], v["per_flow_gbps"],
                        v.get("fairness", 0.0), v.get("ctx", ""))
                else:
                    t.entries[k] = CapacityEntry(
                        v["capacity"], v["per_flow"],
                        v.get("fairness", 0.0), v.get("ctx", ""),
                        v.get("res_names"))
        return t

    #: alias — the control-plane callers name the operation "load"
    load_json = from_json


#: running counters over batched profiling: ``calls`` = invocations of
#: ``profile_contexts_multi``, ``sim_batches`` = ``simulate_batch`` calls
#: it issued (0 when every context was a cache hit), ``contexts`` =
#: cache-missing contexts actually simulated.  ``score_hits`` /
#: ``score_misses`` count ``placement.ScoreCache`` candidate-score reuse (a
#: hit skips rebuilding and re-querying the candidate's would-be context).
_PROFILING_STATS = {"calls": 0, "sim_batches": 0, "contexts": 0,
                    "score_hits": 0, "score_misses": 0}


def profiling_stats() -> dict[str, int]:
    """Snapshot of the batched-profiling counters (see above)."""
    return dict(_PROFILING_STATS)


def profiling_stats_clear() -> None:
    for k in _PROFILING_STATS:
        _PROFILING_STATS[k] = 0


def profile_contexts_multi(jobs: Sequence[tuple["ProfileTable",
                                                AcceleratorSpec,
                                                list[tuple[Path, int,
                                                           float]]]],
                           *, seed: int = 0) -> list[CapacityEntry]:
    """Fleet-aware batched profiling across MULTIPLE ProfileTables.

    ``jobs`` is a sequence of (table, accelerator, flows-context) triples —
    typically one per client server in a fleet, each server holding its own
    ProfileTable (possibly with its own LinkSpec).  All cache-missing
    contexts, deduplicated per table, run as ONE ragged ``simulate_batch``
    per profiling config (tables sharing ``n_ticks``/``tick_cycles``/
    ``clock_hz`` and device share the call; per-table links ride the
    batch's link axis).  Entries are bitwise-identical to serial
    ``profile_context`` runs and are written into each job's own table.
    Returns entries aligned with ``jobs``."""
    _PROFILING_STATS["calls"] += 1
    keys = [context_key(a.name, f) for _, a, f in jobs]
    todo: dict[tuple[int, str], tuple["ProfileTable", str, AcceleratorSpec,
                                      list]] = {}
    for (table, accel, flows), key in zip(jobs, keys):
        tk = (id(table), key)
        if key not in table.entries and tk not in todo:
            todo[tk] = (table, key, accel, flows)
    groups: dict[tuple, list] = {}
    for item in todo.values():
        table = item[0]
        groups.setdefault((table.n_ticks, table.tick_cycles, table.clock_hz,
                           str(table.device)), []).append(item)
    for items in groups.values():
        _PROFILING_STATS["sim_batches"] += 1
        _PROFILING_STATS["contexts"] += len(items)
        cfg = items[0][0]._cfg()
        fsets, atabs, tbss, arrs, ns, links = [], [], [], [], [], []
        for table, key, accel, flows in items:
            specs = _context_specs(flows)
            fset = FlowSet.build(specs)
            ref = {i: accel.peak_gbps for i in range(len(specs))}
            fsets.append(fset)
            atabs.append(AccelTable.build([accel], table.clock_hz))
            tbss.append(baselines.make_tb_state(
                baselines.HOST_NO_TS,
                [tb.TBParams(1, 1, 1)] * len(specs)))
            arrs.append(gen_arrivals(fset, cfg, seed=seed,
                                     load_ref_gbps=ref))
            ns.append(len(specs))
            links.append(table.link)
        link_arg = links[0] if all(ln is links[0] for ln in links) else links
        results = simulate_batch(fsets, atabs, link_arg, cfg, tbss,
                                 *stack_arrivals(arrs),
                                 device=items[0][0].device)
        for (table, key, a, f), res, n in zip(items, results, ns):
            table._entry_from_result(key, res, n, a, f)
    return [t.entries[k] for (t, _, _), k in zip(jobs, keys)]
