"""Arcus-shaped continuous-batching scheduler.

Port of ``src/repro/serving/scheduler.py``.  The buckets live on the
engine's device; with ``use_kernel=True`` they are advanced by the port's
token-bucket kernel (the Hopper kernel on CUDA, its plain version on the
CPU), as the reference steps them by its Pallas kernel.  The clock and the
statistics are Python floats and ints, as in the reference.

The paper's protocol mapped onto serving (DESIGN.md §2):

  * flow         = one tenant's request stream into one engine
  * PatternA     = tenant-chosen submission times (untrusted)
  * PatternA'    = what actually enters engine steps — decided here, by
                   per-tenant token buckets (tokens/s = the SLO), exactly
                   the paper's proactive "rate transformation"
  * hardware mechanism = vectorized token buckets advanced on the virtual
                   clock; state can also be stepped by the Pallas kernel
                   (kernels.token_bucket) as the on-device analogue
  * per-flow counters = tokens served / latency per tenant, read by the
                   SLO monitor which re-writes bucket registers.

Baselines: an unshaped FCFS scheduler (head-of-line large tenants steal
decode slots — the serving analogue of Host_noTS).
The clock is the roofline StepCostModel (a virtual clock: the same
schedule on any machine).
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

import torch

from repro_torch.core import token_bucket as tb
from repro_torch.core.flow import SLOKind
from repro_torch.kernels.token_bucket import ops as tb_ops
from repro_torch.serving.costmodel import StepCostModel
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request, Tenant

CLOCK_HZ = 1e9  # virtual bucket clock: 1 cycle = 1 ns


@dataclasses.dataclass
class TenantStats:
    served_tokens: int = 0
    finished: int = 0
    ttft: list = dataclasses.field(default_factory=list)
    tpot: list = dataclasses.field(default_factory=list)  # per-token latency
    window_tps: list = dataclasses.field(default_factory=list)


class ArcusScheduler:
    """Shaped continuous batching with per-tenant SLO buckets."""

    def __init__(self, engine: ServingEngine, tenants: list[Tenant],
                 cost_model: StepCostModel, *, shaped: bool = True,
                 monitor_window_s: float = 0.25, use_kernel: bool = False):
        self.engine = engine
        self.tenants = {t.tenant_id: t for t in tenants}
        self.cost = cost_model
        self.shaped = shaped
        self.use_kernel = use_kernel
        self.queues: dict[int, deque[Request]] = \
            {t.tenant_id: deque() for t in tenants}
        self.now_s = 0.0
        plans = []
        for t in tenants:
            if shaped and t.slo.kind == SLOKind.IOPS:
                # SLO is tokens/s; the bucket is denominated in tokens
                # (GBPS-mode semantics: admission cost = prompt tokens).
                p = tb.params_for_iops(t.slo.target, CLOCK_HZ)
                plans.append(tb.TBParams(p.refill_rate,
                                         max(4096, 8 * p.refill_rate),
                                         p.interval, tb.MODE_GBPS))
            else:
                big = 2 ** 30
                plans.append(tb.TBParams(big, big, 1, tb.MODE_GBPS))
        self._tenant_order = [t.tenant_id for t in tenants]
        dev = engine.device
        self.buckets = tb.pack(plans, device=dev)
        n = len(plans)
        self._no_cost = torch.zeros(n, dtype=torch.int32, device=dev)
        self._no_want = torch.zeros(n, dtype=torch.bool, device=dev)
        self.stats = {t.tenant_id: TenantStats() for t in tenants}
        self.all_reqs: dict[int, Request] = {}
        self._last_monitor = 0.0
        self._last_served = np.zeros(len(tenants), np.int64)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.arrive_s = max(req.arrive_s, self.now_s)
        self.queues[req.tenant_id].append(req)
        self.all_reqs[req.req_id] = req

    def _advance_buckets(self, dt_s: float):
        cycles = int(dt_s * CLOCK_HZ)
        if self.use_kernel:
            self.buckets, _ = tb_ops.token_bucket_step(
                self.buckets, cycles, self._no_cost, self._no_want)
        else:
            self.buckets = tb.advance(self.buckets, cycles)

    def _try_consume(self, tenant_idx: int, tokens: int) -> bool:
        toks = self.buckets.tokens.cpu().numpy()
        if not self.shaped:
            return True
        if toks[tenant_idx] >= tokens:
            new = self.buckets.tokens.clone()
            new[tenant_idx] -= tokens
            self.buckets = self.buckets._replace(tokens=new)
            return True
        return False

    # ------------------------------------------------------------------
    def step(self) -> float:
        """One scheduling round: admit prefills (shaped), one decode step.
        Returns the virtual time consumed."""
        t0 = self.now_s
        # --- admission: shaped prefill entry ---------------------------
        # Arcus: tenant-ordered, gated by each tenant's bucket.
        # Unshaped (FCFS): strict global arrival order — an early greedy
        # tenant's backlog runs first.
        if self.shaped:
            order = [(i, tid) for i, tid in enumerate(self._tenant_order)]
        else:
            heads = [(self.queues[tid][0].arrive_s, i, tid)
                     for i, tid in enumerate(self._tenant_order)
                     if self.queues[tid]]
            order = [(i, tid) for _, i, tid in sorted(heads)]
        for i, tid in order:
            q = self.queues[tid]
            while q and self.engine.free_slots():
                req = q[0]
                if req.arrive_s > self.now_s:
                    break  # not yet arrived (queues are FIFO per tenant)
                need = len(req.prompt)
                if not self._try_consume(i, need):
                    break
                q.popleft()
                self.engine.admit(req)
                dt = self.cost.prefill_s(1, need)
                self.now_s += dt
                self._advance_buckets(dt)
                req.prefill_done_s = self.now_s
                req.first_token_s = self.now_s
                st = self.stats[tid]
                st.ttft.append(self.now_s - req.arrive_s)
                st.served_tokens += 1  # first token from prefill

        # --- decode ------------------------------------------------------
        if self.engine.active_count:
            ctx = int(np.max(self.engine.lengths[self.engine.active])) \
                if self.engine.active.any() else 0
            produced = self.engine.step()
            dt = self.cost.decode_s(max(self.engine.active_count, 1), ctx)
            self.now_s += dt
            self._advance_buckets(dt)
            by_tenant: dict[int, int] = {}
            for rid in produced:
                req = self.all_reqs.get(rid)
                if req is None:
                    continue
                by_tenant[req.tenant_id] = by_tenant.get(req.tenant_id, 0) + 1
                if req.done and not np.isfinite(req.finish_s):
                    req.finish_s = self.now_s
                    self.stats[req.tenant_id].finished += 1
            for tid, n in by_tenant.items():
                st = self.stats[tid]
                st.served_tokens += n
                st.tpot.append(dt)
        else:
            self.now_s += 1e-4
            self._advance_buckets(1e-4)

        self._monitor()
        return self.now_s - t0

    def _monitor(self):
        """The Algorithm-1 loop: read counters each window, check SLOs,
        re-write bucket registers if violated."""
        if self.now_s - self._last_monitor < 0.25:
            return
        window = self.now_s - self._last_monitor
        served = np.asarray([self.stats[t].served_tokens
                             for t in self._tenant_order], np.int64)
        rate = (served - self._last_served) / window
        for i, tid in enumerate(self._tenant_order):
            self.stats[tid].window_tps.append(float(rate[i]))
        self._last_served = served
        self._last_monitor = self.now_s

    # ------------------------------------------------------------------
    def run(self, duration_s: float, *, max_rounds: int = 100_000):
        rounds = 0
        while self.now_s < duration_s and rounds < max_rounds:
            self.step()
            rounds += 1
        return self.stats


class FCFSScheduler(ArcusScheduler):
    """Unshaped baseline (Host_noTS analogue): admission is first-come
    first-served; an aggressive tenant's long prompts monopolize slots."""

    def __init__(self, engine, tenants, cost_model, **kw):
        super().__init__(engine, tenants, cost_model, shaped=False, **kw)
