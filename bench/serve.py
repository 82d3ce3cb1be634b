"""One run of a serving cell on the wall clock.

The window drives the program's ``ArcusScheduler.step()``, shaping on and
its buckets stepped by the token-bucket kernel (``use_kernel=True``), over a
``ServingEngine`` with its default (float32) cache.  Where the launcher
passes the roofline ``StepCostModel`` as the scheduler's clock, the harness
passes ``WallClock``: its ``prefill_s`` and ``decode_s`` return the wall
seconds of the engine call just made (both calls end in a host read of the
argmax, so the call has finished), and the buckets meter tenants' prompt
tokens against the time the engine really took.  The engine is wrapped
(``TimedEngine``) so that the harness's own clock times each call; every
latency is taken from a request's due time by that clock, and the
program's ``TenantStats`` are not read.

Set-up: the configuration's weights drawn from the seed into the program's
model (``bench/weights.py``), the engine at the cell's size (its decode
graph captured), the scheduler, and the background's share of the slots
filled, which warms the prefill, the decode graph and the bucket kernel.
Then the window: each round submits the reserved requests that have
fallen due, and background requests while the slots in use and every
queued request stay under the mix's ``background_fill`` share of the
slots, then runs one ``step()``.  The background so keeps the card busy
with what the reserved tenants leave, and leaves them the rest of the
slots: a reserved request waits for its bucket and the prefills ahead of
it, not for a slot to free.  After the window, the run goes on until
every reserved request due in it has its first token (at most
``DRAIN_S``), so that a late answer counts as late and not as missing.
A ``--trace 1`` run then goes on serving the same traffic for
``TRACE_S`` seconds under the profiler: the traced stretch follows the
window and its drain, so that the profiler's cost (its start and stop
take seconds, and it slows every round) falls on no request or call that
a metric of the window reads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time

import numpy as np
import torch

from bench import profiling, spec, traffic, weights

perf = time.perf_counter

#: seconds of serving a ``--trace 1`` run traces after its window and drain
TRACE_S = 2.0
#: the longest wait after the window for the first tokens still due
DRAIN_S = 60.0


@dataclasses.dataclass
class Rec:
    """One request as the harness saw it."""
    req: object            # the program's Request
    tenant: int
    reserved: bool
    due: float             # perf_counter time it fell due (was submitted)
    admit_start: float = math.nan
    admit_sched_s: float = math.nan   # the scheduler's clock at admission
    times: list = dataclasses.field(default_factory=list)  # each token's
    finished: float = math.nan

    @property
    def first(self) -> float:
        return self.times[0] if self.times else math.nan


@dataclasses.dataclass
class Call:
    t0: float
    t1: float
    traced: bool


@dataclasses.dataclass
class Prefill(Call):
    tokens: int


@dataclasses.dataclass
class Decode(Call):
    contexts: np.ndarray   # cache lengths of the active slots before it
    lengths: np.ndarray    # every slot's length before it (all are attended)


@dataclasses.dataclass
class Round(Call):
    engine_s: float


class Log:
    def __init__(self):
        self.recs: dict[int, Rec] = {}
        self.prefills: list[Prefill] = []
        self.decodes: list[Decode] = []
        self.rounds: list[Round] = []
        self.traced = False

    def span(self, name: str):
        return torch.profiler.record_function(name) if self.traced \
            else contextlib.nullcontext()


class TimedEngine:
    """The program's engine behind the harness's clock: ``admit`` and
    ``step`` are timed and logged; everything else is the engine's."""

    def __init__(self, engine, log: Log):
        self.engine, self.log = engine, log
        self.sched = None
        self.last_s = 0.0
        self.engine_s = 0.0

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def admit(self, req):
        rec = self.log.recs[req.req_id]
        rec.admit_sched_s = self.sched.now_s
        t0 = perf()
        with self.log.span("engine.prefill"):
            slot = self.engine.admit(req)
        t1 = perf()
        self.last_s = t1 - t0
        self.engine_s += t1 - t0
        rec.admit_start = t0
        rec.times.append(t1)
        self.log.prefills.append(Prefill(t0, t1, self.log.traced,
                                         len(req.prompt)))
        return slot

    def step(self):
        eng = self.engine
        lengths, active = eng.lengths.copy(), eng.active.copy()
        t0 = perf()
        with self.log.span("engine.decode"):
            out = eng.step()
        t1 = perf()
        self.last_s = t1 - t0
        self.engine_s += t1 - t0
        for rid in out:
            rec = self.log.recs[rid]
            rec.times.append(t1)
            if rec.req.done:
                rec.finished = t1
        if out:
            self.log.decodes.append(Decode(t0, t1, self.log.traced,
                                           lengths[active], lengths))
        return out


class WallClock:
    """The scheduler's clock: the wall seconds of the engine call just made
    (in the place of ``StepCostModel``)."""

    def __init__(self, engine: TimedEngine):
        self.engine = engine

    def prefill_s(self, batch: int, seq: int) -> float:
        return self.engine.last_s

    def decode_s(self, batch: int, context: int) -> float:
        return self.engine.last_s


@dataclasses.dataclass
class Run:
    """What one run leaves for the metric readers and the checks."""
    cell: spec.Cell
    seed: int
    t0: float
    t1: float
    setup_s: float
    log: Log
    buckets: dict
    trace: object = None          # profiling.Reading of the traced stretch
    memory_peak_bytes: int = 0
    drained_s: float = 0.0
    cache_bytes: int = 0          # the engine's whole cache, all slots
    cache_rows: int = 0           # rows a slot holds

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def engine(self) -> dict:
        return self.cell.engine

    def window(self, calls):
        """The calls of the window."""
        return [c for c in calls if c.t0 >= self.t0 and c.t1 <= self.t1]

    def cache_use(self) -> dict:
        """The cache as the window used it: its size, and the rows (and
        bytes) the active sequences held, averaged over the decode
        steps."""
        d = self.window(self.log.decodes)
        rows = float(np.mean([c.contexts.sum() + len(c.contexts)
                              for c in d])) if d else 0.0
        slots = self.engine["max_batch"]
        per_row = self.cache_bytes / max(1, slots * self.cache_rows)
        return {"slots": slots, "rows_per_slot": self.cache_rows,
                "bytes": self.cache_bytes, "rows_in_use_mean": rows,
                "bytes_in_use_mean": rows * per_row}

    def reserved_due(self):
        """Reserved requests due in the window."""
        return [r for r in self.log.recs.values()
                if r.reserved and self.t0 <= r.due <= self.t1]


class Driver:
    """Builds the program for a cell (``schedule`` then makes the engine and
    the scheduler for a reserved rate) and runs its rounds."""

    def __init__(self, cell: spec.Cell, seed: int, device, *, patch=None):
        from repro_torch.models import transformer as T
        self.cell, self.seed, self.patch = cell, seed, patch
        self.device = torch.device(device)
        self.arch = spec.program_config(cell.config)
        self.specs = cell.reference.param_specs(cell.config)
        self.model = T.Transformer(self.arch, device=self.device)
        weights.load_into(self.model, self.specs, seed)
        self.model.tie()
        self.engine = None

    def schedule(self, rate: float) -> None:
        """A fresh engine (its decode graph captured, one warm prefill and
        decode) and a scheduler of the mix's reserved tenants at ``rate``
        requests a second and its opportunistic tenant."""
        from repro_torch.core.flow import SLO
        from repro_torch.serving.engine import ServingEngine
        from repro_torch.serving.request import Request, Tenant
        from repro_torch.serving.scheduler import ArcusScheduler
        self.Request = Request
        cfg, mix = self.cell.config, self.cell.mix
        eng = self.cell.engine
        self.sched = self.timed = self.engine = None
        gc.collect()
        if self.device.type == "cuda":   # the last rate's cache, released
            torch.cuda.empty_cache()
        self.engine = ServingEngine(self.arch, self.model,
                                    max_batch=eng["max_batch"],
                                    max_len=eng["max_len"],
                                    device=self.device)
        got = str(self.engine.cache[0][0].dtype).removeprefix("torch.")
        if got != eng["cache_dtype"]:
            raise ValueError(f"the engine's cache is {got}, the configuration "
                             f"states {eng['cache_dtype']}")
        # one warm prefill and decode straight through the engine: the
        # kernels' first launches (a checkout's first run builds them there)
        # stay out of every call the scheduler times
        warm = Request(-1, 0, np.arange(16, dtype=np.int64), 2)
        self.engine.admit(warm)
        self.engine.step()
        if self.patch is not None:       # tests: a fault under the timed path
            self.patch(self.engine)
        self.log = Log()
        self.timed = TimedEngine(self.engine, self.log)
        slos = traffic.slos(mix, rate)
        self.bg = len(slos)
        tenants = [Tenant(i, SLO.iops(s), "reserved")
                   for i, s in enumerate(slos)]
        tenants.append(Tenant(self.bg, SLO.iops(1e9), "opportunistic"))
        self.sched = ArcusScheduler(self.timed, tenants, WallClock(self.timed),
                                    shaped=True, use_kernel=True)
        self.timed.sched = self.sched
        b = self.sched.buckets
        self.buckets = dict(slo=slos,
                            refill=b.refill_rate.cpu().tolist(),
                            depth=b.bkt_size.cpu().tolist())
        V = cfg["vocab_size"]
        self.streams = [traffic.Stream(mix, V, self.seed, i, "reserved", r)
                        for i, r in enumerate(traffic.reserved_rates(mix,
                                                                     rate))]
        self.nxt = [s.next() for s in self.streams]
        self.bgs = traffic.Stream(mix, V, self.seed, self.bg, "background")
        self.bg_cap = int(mix["background_fill"] * eng["max_batch"])
        self.rid = 0
        self.waiting: set[int] = set()   # reserved, submitted, no token yet

    # ------------------------------------------------------------------
    def submit(self, d: traffic.Draw, due: float, reserved: bool) -> None:
        req = self.Request(self.rid, d.tenant, np.asarray(d.prompt, np.int64),
                           d.max_new)
        self.log.recs[self.rid] = Rec(req, d.tenant, reserved, due)
        if reserved:
            self.waiting.add(self.rid)
        self.sched.submit(req)
        self.rid += 1

    def fill(self) -> None:
        """The background's share of the slots taken (set-up)."""
        now = perf()
        first = self.rid
        for d in traffic.initial_fill(self.cell.mix,
                                      self.cell.config["vocab_size"],
                                      self.seed, self.bg, self.bg_cap):
            self.submit(d, now, reserved=False)
        self.sched.step()
        left = sum(1 for r in range(first, self.rid)
                   if not self.log.recs[r].times)
        if left:
            raise RuntimeError(f"the fill left {left} of {self.bg_cap} "
                               f"background requests unadmitted")

    def in_use(self) -> int:
        """Slots taken, and those every queued request will take."""
        return self.engine.active_count + sum(
            len(q) for q in self.sched.queues.values())

    def round(self, t0: float) -> None:
        now = perf()
        for i, st in enumerate(self.streams):
            while t0 + self.nxt[i].due <= now:
                self.submit(self.nxt[i], t0 + self.nxt[i].due, reserved=True)
                self.nxt[i] = st.next()
        while self.in_use() < self.bg_cap:
            self.submit(self.bgs.next(), now, reserved=False)
        e0 = self.timed.engine_s
        r0 = perf()
        with self.log.span("sched.round"):
            self.sched.step()
        r1 = perf()
        self.waiting = {r for r in self.waiting if not self.log.recs[r].times}
        self.log.rounds.append(Round(r0, r1, self.log.traced,
                                     self.timed.engine_s - e0))

    def free(self) -> None:
        """Drop the program's model, engine and scheduler."""
        self.sched = self.timed = self.engine = self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run(cell: spec.Cell, seed: int, seconds: float, *, trace: bool,
        device, t_start: float, patch=None, trace_s: float = TRACE_S,
        drain_s: float = DRAIN_S) -> tuple[Run, Driver]:
    """Set up, run the window, the drain and (``trace``) the traced
    stretch, read the peak memory.  The driver is returned with the
    program still in it; ``Driver.free`` drops it before the reference
    runs."""
    p = cell.params
    drv = Driver(cell, seed, device, patch=patch)
    drv.schedule(p["reserved_rate_per_s"])
    drv.fill()
    tracer = profiling.Tracer(drv.device) if trace else None
    if tracer is not None:
        tracer.warm(drv.sched.step)
    if drv.device.type == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    t0 = perf()
    setup_s = t0 - t_start
    while perf() < t0 + seconds:
        drv.round(t0)
    t1 = perf()
    # the drain: reserved requests due in the window get their first token
    while any(drv.log.recs[r].due <= t1 for r in drv.waiting) and \
            perf() < t1 + drain_s:
        drv.round(t0)
    drained = perf() - t1
    reading = None
    if tracer is not None:
        tracer.start()
        drv.log.traced = True
        ts = perf()
        while perf() < ts + trace_s:
            drv.round(t0)
        drv.log.traced = False
        reading = tracer.stop()
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(drv.device) \
        if drv.device.type == "cuda" else 0
    kv = [t for layer in drv.engine.cache for t in layer]
    r = Run(cell=cell, seed=seed, t0=t0, t1=t1, setup_s=setup_s, log=drv.log,
            buckets=drv.buckets, trace=reading,
            memory_peak_bytes=int(peak), drained_s=drained,
            cache_bytes=sum(t.numel() * t.element_size() for t in kv),
            cache_rows=int(kv[0].shape[1]))
    return r, drv
