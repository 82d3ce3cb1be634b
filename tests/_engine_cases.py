"""The dataplane engine's parity scenarios, shared by the CPU parity tests
(``test_torch_engine.py``: the port against the JAX engine) and the card
tests (``test_torch_cuda.py``: a CUDA window against the same CPU window).

This module imports the port only (no JAX), so the card tests run where
JAX is not installed; ``port_scenario`` builds a scenario with the port's
modules, and ``test_torch_engine._scenario`` the same one with the JAX
package's.  ``system`` names a ``baselines`` system by its module
attribute; ``paths`` are ``Path`` values (ints)."""
import dataclasses

import numpy as np

from repro_torch.core import baselines as tb_sys, token_bucket as ttb
from repro_torch.core.accelerator import CATALOG, AccelTable
from repro_torch.core.flow import SLO, FlowSet, FlowSpec, Path, TrafficPattern
from repro_torch.core.interconnect import (ARB_PRIORITY, ARB_RR, ARB_WFQ,
                                           ARB_WRR)
from repro_torch.core.sim import (SHAPING_HW, SHAPING_NONE, SHAPING_SW,
                                  SimConfig, gen_arrivals, gen_stall_mask)

N_TICKS = 250

CASES = {
    # Arcus: hardware shaping, round robin (the managed run)
    "hw_rr": dict(shaping=SHAPING_HW, arbiter=ARB_RR),
    # profiling: unshaped, RR, Host_noTS registers (int32 wraparound)
    "none_rr_profiling": dict(shaping=SHAPING_NONE, arbiter=ARB_RR,
                              n_flows=3, system="HOST_NO_TS", load=0.99),
    "none_wrr": dict(shaping=SHAPING_NONE, arbiter=ARB_WRR),
    "none_priority": dict(shaping=SHAPING_NONE, arbiter=ARB_PRIORITY),
    "none_wfq": dict(shaping=SHAPING_NONE, arbiter=ARB_WFQ, n_flows=3),
    # software shaping: stall mask, deferred refills, host-delay LCG (a
    # short host delay, so messages complete within the test's ticks)
    "sw_stall": dict(shaping=SHAPING_SW, arbiter=ARB_RR,
                     cfg=dict(sw_host_delay_cycles=100,
                              sw_jitter_cycles=800)),
    # bimodal message sizes (64 B / 4 KiB)
    "hw_bimodal": dict(shaping=SHAPING_HW, arbiter=ARB_RR, msg=64,
                       msg2=4096, p2=0.2),
    # two accelerators, one with fixed-size egress
    "hw_two_accels": dict(shaping=SHAPING_HW, arbiter=ARB_RR,
                          accels=("synthetic50", "sha3_512")),
    # a completion ring small enough to wrap
    "hw_ring_wrap": dict(shaping=SHAPING_HW, arbiter=ARB_RR,
                         cfg=dict(comp_cap=64)),
    # IOPS SLOs: the admission costs 1 a message (bimodal sizes, so a
    # byte cost would differ)
    "hw_iops": dict(shaping=SHAPING_HW, arbiter=ARB_RR, slo="iops", msg=512,
                    msg2=4096, p2=0.3),
    # off-fabric egress (dir 2) beside a loopback flow
    "hw_nic_tx": dict(shaping=SHAPING_HW, arbiter=ARB_RR,
                      paths=(Path.INLINE_NIC_TX, Path.FUNCTION_CALL)),
    # the same under the reference's sequential egress loop, which leaves
    # other entries in the completion ring's scratch slot
    "hw_nic_tx_seq_egress": dict(shaping=SHAPING_HW, arbiter=ARB_RR,
                                 paths=(Path.INLINE_NIC_TX,
                                        Path.FUNCTION_CALL),
                                 cfg=dict(stage_fast=False)),
    # device to device: d2h ingress, h2d egress, beside a NIC-RX flow
    "hw_p2p": dict(shaping=SHAPING_HW, arbiter=ARB_RR,
                   paths=(Path.INLINE_P2P, Path.INLINE_NIC_RX)),
    # more flows than a warp and eight grants a tick: the grant kernel's
    # argmin spans two warps; the reference takes its one-shot RR grant
    # path on uncontended ticks
    "hw_rr_40_flows": dict(shaping=SHAPING_HW, arbiter=ARB_RR, n_flows=40,
                           cfg=dict(k_grant=8)),
}

#: the system whose registers a shaping mode's scenario uses by default
DEFAULT_SYSTEM = {SHAPING_NONE: "HOST_NO_TS", SHAPING_HW: "ARCUS",
                  SHAPING_SW: "HOST_TS_REFLEX"}


def port_scenario(shaping, arbiter, n_flows=2, system=None, load=0.9,
                  msg=1500, msg2=0, p2=0.0, accels=("ipsec32",), cfg=None,
                  n_ticks=N_TICKS, seed=3,
                  paths=(Path.FUNCTION_CALL, Path.INLINE_NIC_RX),
                  slo="gbps"):
    """``(flows, accel table, cfg, TBState, arrivals, stall mask)`` of a
    case, built with the port: flow i takes ``paths[i % len(paths)]`` and
    SLO ``8 (i + 1)`` Gbps, or with ``slo="iops"`` ``400,000 (i + 1)``
    IOPS, under the registers that SLO plans."""
    if slo == "gbps":
        slos = [SLO.gbps(8.0 * (i + 1)) for i in range(n_flows)]
        plans = [ttb.params_for_gbps(s.target) for s in slos]
    else:
        slos = [SLO.iops(400_000.0 * (i + 1)) for i in range(n_flows)]
        plans = [ttb.params_for_iops(s.target) for s in slos]
    specs = [FlowSpec(i, i, Path(int(paths[i % len(paths)])),
                      i % len(accels),
                      TrafficPattern(msg, load=load, process="poisson",
                                     msg_bytes2=msg2, p2=p2),
                      slos[i], priority=i, weight=1.0 + i)
             for i in range(n_flows)]
    flows = FlowSet.build(specs)
    sim_cfg = SimConfig(n_ticks=n_ticks, shaping=shaping, arbiter=arbiter,
                        **(cfg or {}))
    arr = gen_arrivals(flows, sim_cfg, seed=seed,
                       load_ref_gbps={i: 40.0 for i in range(n_flows)})
    sys_cfg = getattr(tb_sys, system or DEFAULT_SYSTEM[shaping])
    tbs = tb_sys.make_tb_state(sys_cfg, plans)
    stall = None
    if shaping == SHAPING_SW:
        # host-descheduling bursts of 6..31 ticks, a few per window
        stall = gen_stall_mask(sim_cfg, seed=1, stall_rate_hz=500_000.0,
                               stall_us=(0.2, 1.0))
        assert np.asarray(stall).any()
    tab = AccelTable.build([CATALOG[a] for a in accels])
    return flows, tab, sim_cfg, tbs, arr, stall


# --- the batched engine -------------------------------------------------------

#: the batched engine's parity elements (one ``port_scenario`` /
#: ``test_torch_engine._scenario`` each): flow counts 1-3, accelerator
#: counts 1-2, every shaping mode and four arbiter pairs, with the software
#: element's stall mask; ``BATCH_HOLE`` is a mid-table ``fl_masks`` hole
BATCH_ELEMENTS = [
    dict(shaping=SHAPING_HW, arbiter=ARB_RR, n_flows=1),
    dict(shaping=SHAPING_SW, arbiter=ARB_WFQ, n_flows=3,
         accels=("ipsec32", "aes256"),
         cfg=dict(sw_host_delay_cycles=100, sw_jitter_cycles=800)),
    dict(shaping=SHAPING_NONE, arbiter=ARB_PRIORITY, n_flows=2),
    dict(shaping=SHAPING_HW, arbiter=ARB_WRR, n_flows=3,
         accels=("synthetic50", "sha3_512")),
]
BATCH_HOLE = (3, 1)
#: ticks of one batched window; the parity runs three from one trace
BATCH_WINDOW = 100


def batch_masks(hole=BATCH_HOLE) -> list:
    """Per-element ``fl_masks`` of ``BATCH_ELEMENTS`` (padded to 3 lanes)
    with lane ``hole[1]`` of element ``hole[0]`` inert (``hole=None``: the
    default prefix masks)."""
    masks = [np.arange(3) < e["n_flows"] for e in BATCH_ELEMENTS]
    if hole is not None:
        masks[hole[0]][hole[1]] = False
    return masks


def stack_stalls(stalls, n_ticks: int) -> np.ndarray:
    """[B, n_ticks] stall masks (zeros where an element has none)."""
    return np.stack([np.zeros(n_ticks, bool) if s is None else s
                     for s in stalls])


def port_batch(n_windows: int = 3):
    """``BATCH_ELEMENTS`` built with the port over ``n_windows`` windows:
    (flows, accel tables, window configs, registers, [B, N, M] traces,
    [B, T] stall masks)."""
    from repro_torch.core.sim import stack_arrivals
    els = [port_scenario(**e, n_ticks=n_windows * BATCH_WINDOW)
           for e in BATCH_ELEMENTS]
    cfgs = [dataclasses.replace(e[2], n_ticks=BATCH_WINDOW) for e in els]
    return ([e[0] for e in els], [e[1] for e in els], cfgs,
            [e[3] for e in els], stack_arrivals([e[4] for e in els]),
            stack_stalls([e[5] for e in els], n_windows * BATCH_WINDOW))


def port_batch_registers(flows_l) -> list:
    """Second-window registers of ``BATCH_ELEMENTS``: each element's system
    registers for SLOs of ``4 (i + 1)`` Gbps."""
    return [tb_sys.make_tb_state(
        getattr(tb_sys, DEFAULT_SYSTEM[e["shaping"]]),
        [ttb.params_for_gbps(4.0 * (i + 1)) for i in range(f.n)])
        for e, f in zip(BATCH_ELEMENTS, flows_l)]
