"""Baseline system configurations (Arcus §5.1 "Configurations").

Each baseline is expressed as (shaping mode, arbiter, stall process) knobs of
the same dataplane, exactly as the paper builds them on the same testbed:

* Host_noTS            — kernel-bypass host access, weighted-round-robin
                         arbitration on the device, no traffic shaping.
* Host_TS_firecracker  — on-host software shaping (Firecracker-style token
                         buckets in the VMM); suffers timer jitter + CPU
                         interference.
* Host_TS_reflex       — on-host software shaping (ReFlex-style request-level
                         pacing); same pathology, slightly tighter timers.
* Bypassed_noTS_panic  — hypervisor-bypassed PANIC interface: priority +
                         weighted-fair queuing, reactive, no shaping.
* Arcus                — hardware per-flow token buckets + RR, proactive.

Port of ``src/repro/core/baselines.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import token_bucket as tb
from repro_torch.core.interconnect import ARB_PRIORITY, ARB_RR, ARB_WRR
from repro_torch.core.sim import (SHAPING_HW, SHAPING_NONE, SHAPING_SW,
                                  SimConfig, gen_stall_mask, simulate_batch,
                                  stack_arrivals)


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    name: str
    shaping: int
    arbiter: int
    sw_host_delay_cycles: int = 0
    sw_jitter_cycles: int = 0
    stall_rate_hz: float = 0.0          # host-desched events per second
    stall_us: tuple[float, float] = (2.0, 40.0)


HOST_NO_TS = SystemConfig("Host_noTS", SHAPING_NONE, ARB_WRR)
# VM CPU contention regime (Sec. 5.2: "CPU processing of VMs leads to
# imprecise software token buckets and software timers and unpredictable
# execution times"): shaping threads lose the core for scheduler-quantum
# scale bursts; per-message host processing adds jittered delay.
HOST_TS_FIRECRACKER = SystemConfig(
    "Host_TS_firecracker", SHAPING_SW, ARB_RR,
    sw_host_delay_cycles=650, sw_jitter_cycles=3000,   # ~2.6us + up to 12us
    stall_rate_hz=150.0, stall_us=(80.0, 600.0))
HOST_TS_REFLEX = SystemConfig(
    "Host_TS_reflex", SHAPING_SW, ARB_RR,
    sw_host_delay_cycles=450, sw_jitter_cycles=2500,   # ~1.8us + up to 10us
    stall_rate_hz=250.0, stall_us=(30.0, 300.0))
BYPASSED_NO_TS_PANIC = SystemConfig("Bypassed_noTS_panic", SHAPING_NONE,
                                    ARB_PRIORITY)
ARCUS = SystemConfig("Arcus", SHAPING_HW, ARB_RR)

ALL = {c.name: c for c in (HOST_NO_TS, HOST_TS_FIRECRACKER, HOST_TS_REFLEX,
                           BYPASSED_NO_TS_PANIC, ARCUS)}


def make_sim_config(sys_cfg: SystemConfig, n_ticks: int, **overrides
                    ) -> SimConfig:
    return SimConfig(
        n_ticks=n_ticks,
        shaping=sys_cfg.shaping,
        arbiter=sys_cfg.arbiter,
        sw_host_delay_cycles=sys_cfg.sw_host_delay_cycles or 500,
        sw_jitter_cycles=sys_cfg.sw_jitter_cycles or 2500,
        **overrides,
    )


def make_stall_mask(sys_cfg: SystemConfig, cfg: SimConfig, *, seed: int = 1,
                    total_ticks: int | None = None) -> np.ndarray | None:
    if sys_cfg.shaping != SHAPING_SW or sys_cfg.stall_rate_hz <= 0:
        return None
    n = total_ticks or cfg.n_ticks
    base = dataclasses.replace(cfg, n_ticks=n)
    return gen_stall_mask(base, seed=seed, stall_rate_hz=sys_cfg.stall_rate_hz,
                          stall_us=sys_cfg.stall_us)


def run_system_batch(systems, flows, accels, link, n_ticks: int, *,
                     tb_states, arr, stall_seed: int = 1,
                     cfg_overrides: dict | None = None, device=None):
    """Run several baseline *systems* over the same scenario as ONE batch
    of the engine (``sim.simulate_batch``) on ``device`` (default
    ``"cuda"``).

    Shaping mode, arbiter and the software-delay model are per-element
    engine inputs, so Arcus and its Host/Bypassed baselines (Sec. 5.1) —
    which differ only in those knobs — run as elements of one batch.

    * ``systems``: sequence of SystemConfig (or names into ``ALL``);
    * ``tb_states``: per-system TBState registers;
    * ``arr``: one shared (times, sizes) trace, or a per-system sequence;
    * SW systems get their stall process generated here ([B, T] mask).

    Returns ``list[SimResult]``, one per system, each bitwise-identical to
    a serial run of that system."""
    systems = [ALL[s] if isinstance(s, str) else s for s in systems]
    cfgs = [make_sim_config(s, n_ticks, **(cfg_overrides or {}))
            for s in systems]
    arrs = list(arr) if isinstance(arr, (list, tuple)) \
        and isinstance(arr[0], (list, tuple)) else [arr] * len(systems)
    stall = None
    masks = [make_stall_mask(s, c, seed=stall_seed)
             for s, c in zip(systems, cfgs)]
    if any(m is not None for m in masks):
        stall = np.stack([m if m is not None else np.zeros(n_ticks, bool)
                          for m in masks])
    return simulate_batch(flows, accels, link, cfgs, list(tb_states),
                          *stack_arrivals(arrs), stall_mask=stall,
                          device=device)


def make_tb_state(sys_cfg: SystemConfig, plans: list[tb.TBParams],
                  *, clock_hz: float = 250e6) -> tb.TBState:
    """Token-bucket registers for a system.  Non-shaping systems get
    effectively-infinite buckets (transparent gate).  Software shapers get
    enlarged buckets (~5 ms of tokens): timestamp-based catch-up after a
    missed timer releases the deferred tokens in a burst — the
    over-provisioning pathology of Table 3."""
    n = len(plans)
    big = 2**30
    if sys_cfg.shaping == SHAPING_NONE:
        return tb.init(np.full(n, big, np.int32), np.full(n, big, np.int32),
                       np.ones(n, np.int32), np.zeros(n, np.int32))
    if sys_cfg.shaping == SHAPING_SW:
        plans = [
            dataclasses.replace(
                p, bkt_size=max(p.bkt_size,
                                int(tb.achieved_rate(p, clock_hz) * 2e-3)))
            for p in plans
        ]
        # software buckets start empty: tokens exist only once the timer
        # thread has run (and its catch-up bursts are the pathology)
        return tb.pack(plans, start_full=False)
    return tb.pack(plans)
