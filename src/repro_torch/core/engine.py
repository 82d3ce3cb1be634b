"""Dataplane engine: the six-stage tick on torch tensors, over a batch axis.

Port of ``src/repro/core/engine.py``: the serial ``run_window`` and the
batched ``run_window_batch`` (the reference's ``jax.vmap``).  A window runs
``n_ticks`` ticks of ``_tick``, each the reference's tick in its
*sequential* form — ``grant_body``, ``srv_body`` and ``eg_body`` loops —
with every shaping mode (NONE / HW / SW with stall mask and host-delay LCG)
and every arbiter (RR / WRR / PRIORITY / WFQ):

    1. token-bucket timers      -> Hopper token-bucket kernel
                                   ``grant_tick``, one launch with stage 4
    2. arrivals -> flow queues
    3. per-tick link (and resource-axis) budgets
    4. shaper + arbiter grants  -> the same launch (``k_grant`` grants)
    5. accelerator service
    6. egress link + completions

The link may carry R extra resource axes (``LinkSpec.resources``: device
memory bandwidth, host DMA, ...), each a token bucket of bytes: a grant
is gated on every axis its flow demands and charges its ingress demand, an
egress pop charges its egress demand as debt, and unused budget carries up
to the axis' burst depth.  R is a shape, so it is in an entry's key; with
none the tick computes no resource op.

Stages 1 and 4 run together, after 2 and 3 (which read neither the bucket
state nor ``sw_pend``): ``kernels/token_bucket/ops.grant_tick`` refills
every bucket and runs the ``k_grant`` sequential grants in one launch a
tick on the card (``grant_tick_plain`` on the CPU).  Stages 2, 3, 5 and 6
are eager PyTorch ops.

**One tick body, B dataplanes.**  Every tensor of the tick has a leading
batch axis written out: per-flow tensors are [B, N], per-accelerator ones
[B, A], and so on.  ``run_window_batch`` runs B independent dataplanes as
one batch (one grant-tick launch a tick, one CTA an element); the serial
``run_window`` runs the same body at B = 1 and keeps the reference's serial
shapes at its boundary.  Elements may differ in flow count (padded,
masked by ``fl_mask``), accelerator count (padded, masked by ``ac_mask``),
links, registers, stall masks and ``TRACED_CFG_FIELDS`` (shaping mode,
arbiter, software-delay model).  The set of shaping modes and arbiters a
batch holds is part of its cache key, and a tick computes only their
branches, selecting per element inside that set.

The reference asserts that its one-shot fast paths equal these loops
bitwise, so ``SimConfig.grant_fast`` / ``stage_fast`` are accepted and the
loops run regardless; ``stage_fast`` only picks which queue entry a
direction that does not pop leaves in the completion ring's scratch slot,
as the reference's two egress forms do.

The carry is a dict of tensors on one device (a ``TBState`` under ``"tb"``)
with the reference's keys, shapes and dtypes (a leading [B] axis when
batched), and it is **updated in place**: hand the returned carry forward,
never reuse one passed in (the reference donates it for the same reason).
The tick issues no host sync (no ``.item()``, no Python branch on a
tensor), and it changes no carry tensor's identity or address and adds no
key: every update is a ``copy_`` or an in-place op.  It reads its time
from an int32 device counter (the tick and its index in the window, the
reference's traced ``t``) and advances it in place.

So a tick is capturable.  The reference jits each window (``_run_core``,
a ``lax.scan`` of ticks, cached in ``_RUN_CACHE`` by ``_get_run``); the
port's ``_RUN_CACHE`` holds an entry (``_Run``) per static signature:
serial or batch, the config's structural fields, the batch size, the
values the tick bakes in (modes and arbiters present, accelerator column
states) and all shapes.  The entry owns the
buffers a tick reads and writes; on the card it captures one tick as a
CUDA graph at its first window and replays it ``n_ticks`` times a window,
and on the CPU it runs the same buffers through the eager body.
``cache_info()`` / ``cache_clear()`` as in the reference;
``_run_window_eager`` and ``_run_window_batch_eager`` are the eager body
outside the cache, for the tests and the smoke's comparisons only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import cuda_graph
from repro_torch.core import token_bucket as tb
from repro_torch.core.accelerator import (GRID_N, GRID_TAB_MAX, AccelTable,
                                          fma32, grid_position_table)
from repro_torch.core.flow import FlowSet, Path
from repro_torch.core.interconnect import (ARB_PRIORITY, ARB_RR, ARB_WFQ,
                                           ARB_WRR, LinkSpec)
from repro_torch.device import resolve_device
from repro_torch.kernels.token_bucket import ops as tb_ops
from repro_torch.kernels.token_bucket.ops import (  # noqa: F401 (re-exported)
    SHAPING_HW, SHAPING_NONE, SHAPING_SW)

INF_I32 = np.int32(2**31 - 1)
_LCG_A = 1103515245
_LCG_C = 12345


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_ticks: int
    tick_cycles: int = 8
    clock_hz: float = 250e6
    qlen: int = 256            # per-flow queue slots
    aq_len: int = 256          # per-accelerator queue slots
    aq_byte_cap: int = 1 << 20  # shared accel input buffer (bytes)
    eq_len: int = 2048         # per-direction egress queue slots
    comp_cap: int = 1 << 15    # completion record ring capacity
    k_arr: int = 4             # max arrivals drained per flow per tick
    k_grant: int = 4           # max arbiter grants per tick
    k_srv: int = 2             # service starts per accelerator per tick
    k_eg: int = 4              # egress pops per direction per tick
    lmax: int = 16             # max accelerator lanes
    shaping: int = SHAPING_HW
    arbiter: int = ARB_RR
    # software-shaping pathology model
    sw_host_delay_cycles: int = 500      # ~2 us base host processing delay
    sw_jitter_cycles: int = 2500         # up to +10 us heavy-tail jitter
    # the reference's one-shot fast paths; accepted for config parity, the
    # port always runs the sequential loops they are proven equal to
    grant_fast: bool = True
    stage_fast: bool = True

    @property
    def seconds(self) -> float:
        return self.n_ticks * self.tick_cycles / self.clock_hz


#: SimConfig fields the engine takes as data (per-element tensors), not
#: structure: two SimConfigs differing only in these share one cache entry
#: (its key holds the set of shaping modes and arbiters present) and may be
#: elements of the same batch
TRACED_CFG_FIELDS = ("shaping", "arbiter", "sw_host_delay_cycles",
                     "sw_jitter_cycles")


def _static_cfg(cfg: SimConfig) -> SimConfig:
    """Canonical cache-key form of a SimConfig (traced fields zeroed)."""
    return dataclasses.replace(cfg, **{f: 0 for f in TRACED_CFG_FIELDS})


# ---------------------------------------------------------------------------
# Carry construction
# ---------------------------------------------------------------------------


def _own_tb(tb_state: tb.TBState, device) -> tb.TBState:
    """Engine-owned copies of the TBState leaves on ``device`` (the carry is
    updated in place, so it must not alias the caller's registers)."""
    return tb.TBState(*(
        x.to(device=device, dtype=torch.int32, copy=True)
        if isinstance(x, torch.Tensor)
        else torch.as_tensor(np.array(x, np.int32), device=device)
        for x in tb_state))


def init_carry(flows: FlowSet, accels: AccelTable, cfg: SimConfig,
               tb_state: tb.TBState, *, n_flows: int | None = None,
               n_res: int = 0, device=None) -> dict[str, Any]:
    """A fresh dataplane's carry (one element: the reference's serial
    shapes); ``n_flows`` pads the flow axis for a ragged batch (with
    ``tb_state`` padded to match, ``pad_tb_state``); ``n_res`` is the
    link's number of extra resource axes."""
    dev = resolve_device(device)
    N, A = (n_flows or flows.n), accels.n
    lanes_busy = np.zeros((A, cfg.lmax), np.float32)
    for a in range(A):
        lanes_busy[a, accels.parallelism[a]:] = np.float32(3e38)  # disabled

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return dict(
        q_sz=z(N, cfg.qlen), q_at=z(N, cfg.qlen), q_head=z(N), q_cnt=z(N),
        arr_ptr=z(N),
        tb=_own_tb(tb_state, dev), sw_pend=z(N),
        rr_ptr=z(), vft=z(N, dtype=torch.float32),
        lres=z(2, dtype=torch.float32),
        # extra resource axes (token-bucket residue: unused budget up to
        # each axis' burst_bytes, or the serialization debt when negative)
        res_res=z(n_res, dtype=torch.float32),
        credits_used=z(),
        aq_sz=z(A, cfg.aq_len), aq_fl=z(A, cfg.aq_len),
        aq_at=z(A, cfg.aq_len), aq_head=z(A), aq_cnt=z(A), aq_bytes=z(A),
        lanes=torch.as_tensor(lanes_busy, device=dev),
        eq_sz=z(3, cfg.eq_len), eq_isz=z(3, cfg.eq_len),
        eq_fl=z(3, cfg.eq_len), eq_at=z(3, cfg.eq_len),
        eq_rd=z(3, cfg.eq_len), eq_head=z(3), eq_cnt=z(3),
        c_adm_msgs=z(N), c_adm_b_lo=z(N), c_adm_b_hi=z(N),
        c_done_msgs=z(N), c_done_b_lo=z(N), c_done_b_hi=z(N), c_drops=z(N),
        c_lat_sum=z(N, dtype=torch.float32),
        # completion record ring (one scratch slot at index comp_cap)
        comp_fl=z(cfg.comp_cap + 1), comp_lat=z(cfg.comp_cap + 1),
        comp_t=z(cfg.comp_cap + 1), comp_sz=z(cfg.comp_cap + 1),
        comp_n=z(),
        rng=torch.tensor(0x1234567, dtype=torch.int32, device=dev),
    )


def reconfigure_carry(carry: dict, tb_state: tb.TBState) -> dict:
    """Live reconfiguration: write only the parameter "registers"
    (Refill_Rate / Bkt_Size / Interval / mode); in-flight tokens and timers
    are hardware state and keep running."""
    carry = dict(carry)
    old = carry["tb"]
    new = _own_tb(tb_state, old.tokens.device)
    carry["tb"] = old._replace(
        refill_rate=new.refill_rate, bkt_size=new.bkt_size,
        interval=new.interval, mode=new.mode,
        tokens=torch.minimum(old.tokens, new.bkt_size))
    return carry


def carry_from_numpy(carry_np: dict, device=None) -> dict:
    """The port's carry from a host copy of the reference engine's carry
    (``jax.device_get`` of it: numpy leaves, a ``TBState`` under "tb")."""
    dev = resolve_device(device)
    out = {}
    for k, v in carry_np.items():
        if k == "tb":
            out[k] = tb.TBState(*(torch.as_tensor(np.array(x)).to(dev)
                                  for x in v))
        else:
            out[k] = torch.as_tensor(np.array(v)).to(dev)
    return out


def _stack(carries: list) -> dict:
    """One batched carry ([B, ...] leaves) from B element carries."""
    out = {k: torch.stack([c[k] for c in carries]) for k in carries[0]
           if k != "tb"}
    out["tb"] = tb.TBState(*(torch.stack(xs) for xs in
                             zip(*(c["tb"] for c in carries))))
    return out


def carry_to_numpy(carry: dict) -> dict:
    """Host copy of a carry (numpy leaves; "tb" as a tuple of arrays)."""
    def host(x):
        return x.to("cpu", copy=True).numpy()
    return {k: (tuple(host(x) for x in v) if k == "tb" else host(v))
            for k, v in carry.items()}


# ---------------------------------------------------------------------------
# Membership-change carry resumption (tenant lifecycle)
# ---------------------------------------------------------------------------


def release_flow_lane(carry: dict, b: int, lane: int) -> dict:
    """Depart: flush one flow lane of a resumed batched carry, in place.

    Queued-but-unadmitted messages are discarded (their bytes were never
    counted — admission counters tick at grant time) and the lane stops
    being grant-eligible via the caller's ``fl_mask``; messages already
    admitted into accelerator/egress queues drain naturally.  Shapes are
    untouched, so resuming the carry stays on the same cache entry."""
    carry["q_cnt"][b, lane] = 0
    carry["sw_pend"][b, lane] = 0
    return carry


def recycle_flow_lane(carry: dict, b: int, lane: int) -> dict:
    """Arrive: reset a (possibly previously occupied) flow lane of a
    batched carry in place, so no dataplane state leaks from an earlier
    tenant.

    The arrival pointer rewinds to the lane's (fresh) trace row, the
    ingress queue and arbiter virtual-finish-time reset, and the token
    count is pre-set to INF so the next register write's
    ``min(tokens, bkt_size)`` clamp hands the new tenant a full initial
    bucket.  The lane's cumulative hardware counters zero too (the
    measurement baseline reset); messages the predecessor already pushed
    into the accelerator/egress queues drain onto this lane's counters, as
    in the reference."""
    for k in ("q_cnt", "q_head", "arr_ptr", "sw_pend",
              "c_adm_msgs", "c_adm_b_lo", "c_adm_b_hi", "c_done_msgs",
              "c_done_b_lo", "c_done_b_hi", "c_drops"):
        carry[k][b, lane] = 0
    carry["vft"][b, lane] = 0.0
    carry["c_lat_sum"][b, lane] = 0.0
    carry["tb"].tokens[b, lane] = int(INF_I32)
    return carry


# ---------------------------------------------------------------------------
# Flow / register padding (ragged batches)
# ---------------------------------------------------------------------------


def _host_np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pad_tb_state(state: tb.TBState, n_max: int) -> tb.TBState:
    """Pad per-flow TB registers to ``n_max`` lanes with benign parameters
    (interval 1 avoids div-by-zero in the shared timer advance; padded lanes
    are never offered messages, so their token state is inert)."""
    n = int(_host_np(state.tokens).shape[0])
    if n == n_max:
        return state
    if n > n_max:
        raise ValueError(f"TBState has {n} lanes > n_max={n_max}")
    pad = n_max - n

    def ext(x, fill):
        x = _host_np(x)
        return np.concatenate([x, np.full((pad,), fill, x.dtype)])

    return tb.TBState(
        tokens=ext(state.tokens, 0), cyc=ext(state.cyc, 0),
        refill_rate=ext(state.refill_rate, 1), bkt_size=ext(state.bkt_size, 1),
        interval=ext(state.interval, 1), mode=ext(state.mode, 0))


def _accel_mask(tab: AccelTable) -> np.ndarray:
    """Per-accelerator validity mask (active = has at least one lane).

    Active accelerators must occupy a prefix of the table: the reference's
    closed-form host-delay draw indexes service iterations as
    ``k * n_active + a``, which equals the sequential walk only when every
    active row precedes every padded row (``pad_accel_table`` always
    appends padding)."""
    m = np.asarray(tab.parallelism) > 0
    if np.any(~m[:-1] & m[1:]):
        raise ValueError(
            "active accelerators (parallelism > 0) must form a prefix of "
            f"the AccelTable (got parallelism={list(tab.parallelism)})")
    return m


def pad_accel_table(tab: AccelTable, a_max: int) -> AccelTable:
    """Pad an accelerator table to ``a_max`` rows (ragged accel batching).

    Padded accelerators carry benign service/egress curves (never read:
    no flow routes to them) and ``parallelism=0``, which disables every
    lane at ``init_carry`` time — they can never start service."""
    if tab.n == a_max:
        return tab
    if tab.n > a_max:
        raise ValueError(f"AccelTable has {tab.n} accels > a_max={a_max}")
    pad = a_max - tab.n
    return AccelTable(
        n=a_max,
        service_cycles=np.concatenate(
            [tab.service_cycles,
             np.ones((pad, GRID_N), np.float32)]).astype(np.float32),
        egress_bytes=np.concatenate(
            [tab.egress_bytes,
             np.ones((pad, GRID_N), np.float32)]).astype(np.float32),
        parallelism=np.concatenate(
            [tab.parallelism, np.zeros(pad, np.int32)]).astype(np.int32),
        names=list(tab.names) + ["__pad__"] * pad,
        specs=list(tab.specs))


def _flow_args(flows: FlowSet, n_max: int) -> dict[str, np.ndarray]:
    """Per-flow routing/weight tables padded to ``n_max`` plus the validity
    mask.  Padded lanes route to accel 0 / direction 0 (any in-range value:
    they are never granted) and carry weight 1 to keep 1/w finite."""
    n = flows.n

    def pad(x, fill, dtype):
        x = np.asarray(x, dtype)
        return np.concatenate(
            [x, np.full((n_max - n,), fill, dtype)]) if n_max > n else x

    return dict(
        fl_accel=pad(flows.accel_id, 0, np.int32),
        fl_in_dir=pad(flows.ingress_dir, 0, np.int32),
        fl_eg_dir=pad(flows.egress_dir, 0, np.int32),
        # inline-NIC-RX delivers the full payload to the host no matter what
        # the accelerator emits; other paths transfer the accel's output.
        fl_eg_full=pad(flows.path == int(Path.INLINE_NIC_RX), False, bool),
        fl_prio=pad(flows.priority, 0, np.float32),
        fl_w=pad(np.maximum(flows.weight, 1e-3), 1.0, np.float32),
        fl_mask=pad(np.ones(n, bool), False, bool),
    )


def _resource_tables(flows: FlowSet, accels: AccelTable, link: LinkSpec,
                     n_max: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-flow demand coefficients on the extra resource axes.

    Returns ``(w_in, w_eg)``, each ``[R, n_max]`` float32 for the link's R
    extra axes: bytes charged on axis r per ingress byte granted / per
    egress byte popped for flow i.
    Resolution order: a flow's own ``res_demand`` hint, else its
    accelerator's ``AcceleratorSpec.res_demand``, else 1.0/1.0 (every byte
    crosses the axis).  ``fabric_only`` axes charge nothing for off-fabric
    (dir == 2) stage directions.  Negative demand clamps to 0.  Padded flow
    lanes keep 0 coefficients — they are never granted, so the value is
    inert either way."""
    rspecs = getattr(link, "resources", ())
    R = len(rspecs)
    w_in = np.zeros((R, n_max), np.float32)
    w_eg = np.zeros((R, n_max), np.float32)
    specs = getattr(flows, "specs", ())
    for r, rs in enumerate(rspecs):
        for i in range(flows.n):
            sp = specs[i] if i < len(specs) else None
            ic = ec = None
            if sp is not None:
                for nm, a, b in getattr(sp, "res_demand", ()):
                    if nm == rs.name:
                        ic, ec = float(a), float(b)
                        break
            if ic is None:
                aspec = (accels.spec_of(int(flows.accel_id[i]))
                         if hasattr(accels, "spec_of") else None)
                ic, ec = (aspec.resource_demand(rs.name)
                          if aspec is not None else (1.0, 1.0))
            if rs.fabric_only:
                if int(flows.ingress_dir[i]) == 2:
                    ic = 0.0
                if int(flows.egress_dir[i]) == 2:
                    ec = 0.0
            w_in[r, i] = max(ic, 0.0)
            w_eg[r, i] = max(ec, 0.0)
    return w_in, w_eg


def _n_res(links_l: list) -> int:
    """The batch's number of extra resource axes (every link the same)."""
    n_res = len(getattr(links_l[0], "resources", ()))
    if any(len(getattr(link, "resources", ())) != n_res
           for link in links_l[1:]):
        raise ValueError(
            "batched LinkSpecs must all carry the same number of resource "
            "axes (resource tables are a shared traced shape; a huge-"
            "capacity axis is inert if an element needs fewer)")
    return n_res


# ---------------------------------------------------------------------------
# Per-window arguments
# ---------------------------------------------------------------------------


def _window_stall(stall_mask, cfg: SimConfig, t0_ticks) -> np.ndarray:
    """Window-relative ``[n_ticks]`` (or per-element ``[B, n_ticks]``)
    stall mask: the window's one bound check of the grant tick's
    ``stall[b, t_idx]``, which the card reads."""
    if stall_mask is None:
        return np.zeros(cfg.n_ticks, bool)
    stall_mask = np.asarray(stall_mask, bool)
    if stall_mask.shape[-1] == cfg.n_ticks:
        return stall_mask
    t0 = int(t0_ticks)
    if stall_mask.shape[-1] < t0 + cfg.n_ticks:
        raise ValueError(
            f"stall mask covers {stall_mask.shape[-1]} ticks < "
            f"t0+n_ticks={t0 + cfg.n_ticks}")
    return stall_mask[..., t0:t0 + cfg.n_ticks]


def _check_modes(cfg: SimConfig) -> None:
    """Mode words reach the tick as data: validate them up front."""
    if cfg.arbiter not in (ARB_RR, ARB_WRR, ARB_PRIORITY, ARB_WFQ):
        raise ValueError(cfg.arbiter)
    if cfg.shaping not in (SHAPING_NONE, SHAPING_HW, SHAPING_SW):
        raise ValueError(cfg.shaping)


def _as_i32(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.int32)
    return torch.as_tensor(np.asarray(x, np.int32), device=dev)


def _column_states(mask: np.ndarray) -> tuple:
    """Per column of a [B, A] mask: ``True`` (active in every element),
    ``False`` (in none) or ``None`` (some): the tick reads the mask only
    where the column is mixed."""
    return tuple(bool(col[0]) if (col == col[0]).all() else None
                 for col in mask.T)


def _pack_args(flows_l: list, accels_l: list, links_l: list, cfgs_l: list,
               arr_t: torch.Tensor, arr_sz: torch.Tensor, stall: np.ndarray,
               dev, fl_masks=None) -> dict[str, Any]:
    """A window's arguments for B elements: per-element flow tables padded
    to the largest flow count (and masked), accelerator tables already
    padded to one count, links, mode words and software-delay models,
    ``[B, N, M]`` arrival traces and the window's ``[B or 1, n_ticks]``
    stall masks.  A link with R extra resource axes adds their per-cycle
    capacities and burst depths ([B, R]) and the flows' demand
    coefficients ([B, R, N]; ``res_w_any``: the axes a flow charges in
    either direction); with none the tick computes no resource op.

    Tensors are data a graph reads in place.  The values that are not
    tensors are what an entry bakes in (its key holds them): the shaping
    modes and arbiters present (a tick computes only their branches) and
    each accelerator column's mask state."""
    for c in cfgs_l:
        _check_modes(c)
    n_res = _n_res(links_l)
    B = len(flows_l)
    n_max = max(f.n for f in flows_l)
    per_el = [_flow_args(f, n_max) for f in flows_l]
    if fl_masks is not None:
        for p, m in zip(per_el, fl_masks):
            p["fl_mask"] = np.asarray(m, bool)
    fa = {k: np.stack([p[k] for p in per_el]) for k in per_el[0]}
    cfg0 = cfgs_l[0]
    t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=dev)  # noqa: E731
    args = tb_ops.grant_args(
        fa["fl_accel"], fa["fl_in_dir"], fa["fl_prio"], fa["fl_w"],
        fa["fl_mask"], ovh=[link.msg_overhead_bytes for link in links_l],
        credits=[link.credits for link in links_l],
        shaping=[c.shaping for c in cfgs_l],
        arbiter=[c.arbiter for c in cfgs_l], tick_cycles=cfg0.tick_cycles,
        stall=stall.reshape(-1, stall.shape[-1]), device=dev)
    bpc = np.asarray([link.bytes_per_cycle() for link in links_l],
                     np.float32)
    ac_mask = np.stack([_accel_mask(a) for a in accels_l])
    # the software-delay model as float64 columns of float32 values: the
    # host delay's fused multiply-add works in float64 (accelerator.fma32)
    delay = lambda f: t(np.asarray(  # noqa: E731
        [np.float32(getattr(c, f)) for c in cfgs_l],
        np.float32).astype(np.float64).reshape(B, 1), torch.float64)
    args.update(
        arr_t=arr_t, arr_sz=arr_sz,
        svc_tab=t(np.stack([a.service_cycles for a in accels_l]),
                  torch.float32),
        eg_tab=t(np.stack([a.egress_bytes for a in accels_l]),
                 torch.float32),
        ac_mask=t(ac_mask, torch.bool), ac_cols=_column_states(ac_mask),
        bpc=t(bpc, torch.float32),
        # per egress direction (dir 2 is off-fabric and never divides)
        bpc3=t(bpc[:, [0, 1, 1]], torch.float32),
        sw_delay=delay("sw_host_delay_cycles"),
        sw_jit=delay("sw_jitter_cycles"),
        fl_eg_dir=t(fa["fl_eg_dir"], torch.long),
        fl_eg_full=t(fa["fl_eg_full"], torch.bool),
        # constants reused every tick (no per-tick allocation from Python)
        jj_arr=torch.arange(cfg0.k_arr, dtype=torch.int32, device=dev),
        dirs=torch.arange(3, dtype=torch.long, device=dev),
        ar3p1=torch.arange(1, 4, dtype=torch.int32, device=dev),
        bud_off=torch.full((B, 1), tb_ops.BIG, dtype=torch.float32,
                           device=dev),
    )
    if n_res:
        tabs = [_resource_tables(f, a, link, n_max)
                for f, a, link in zip(flows_l, accels_l, links_l)]
        w_in = np.stack([w for w, _ in tabs])
        w_eg = np.stack([w for _, w in tabs])
        args.update(
            res_cap=t(np.stack([link.resource_caps_per_cycle()
                                for link in links_l]), torch.float32),
            res_burst=t(np.stack([link.resource_burst_bytes()
                                  for link in links_l]), torch.float32),
            res_w_in=t(w_in, torch.float32), res_w_eg=t(w_eg, torch.float32),
            # a flow's grants stall while ANY axis it demands, in either
            # direction, is in debt
            res_w_any=t((w_in > 0.0) | (w_eg > 0.0), torch.bool))
    return args


# ---------------------------------------------------------------------------
# The tick
# ---------------------------------------------------------------------------


def _lcg(rng: torch.Tensor) -> torch.Tensor:
    return tb.wrap_i32(rng.long() * _LCG_A + _LCG_C)


def _f32(v) -> float:
    return float(np.float32(v))


def _host_delay(u, sw_jit, sw_delay):
    """``sw_delay + u ** 4 * sw_jit`` as the compiled reference computes it:
    ``(u * u) * (u * u)``, the jitter's multiply fused into the add."""
    u2 = u * u
    return fma32(u2 * u2, sw_jit, sw_delay)


def _both(x, y):
    """``x & y`` for values that are each ``True``, ``False`` or a bool
    tensor, with no op where a Python value settles it."""
    if x is False or y is False:
        return False
    if x is True:
        return y
    if y is True:
        return x
    return x & y


def _blend(row, i0, frac):
    """``accelerator.grid_blend`` of each element's [B, GRID_N] table row
    at its [B, 1] grid position."""
    return fma32(row.gather(1, i0 + 1), frac, row.gather(1, i0) * (1.0 - frac))


def _tick(cfg: SimConfig, args: dict, c: dict, clock: torch.Tensor) -> None:
    """One simulated tick of B dataplanes, in place on the batched carry
    ``c`` (every leaf [B, ...]): no carry tensor changes identity or
    address.  ``clock`` is the int32 [2] device counter (the tick, the
    tick's index in its window), shared by the batch; the tick reads it on
    the device and advances it at its end, so a CUDA graph of one tick
    replays as the next tick.

    Each op works on every element at once.  Where an element's shaping
    mode or an accelerator column's mask changes what an op does, the
    batch's static set of them (``args["modes"]``, ``args["ac_cols"]``)
    decides: a branch no element takes is not computed, one every element
    takes is computed unmasked, and only a mixed batch selects per element
    with ``where``."""
    fl_eg_dir, fl_eg_full = args["fl_eg_dir"], args["fl_eg_full"]
    svc_tab, eg_tab = args["svc_tab"], args["eg_tab"]
    A = svc_tab.shape[1]
    sw = tb_ops.word_is(args["modes"], args["mode"], SHAPING_SW)

    # [1] int32 cycles, wrapping as the reference's traced int32 t does
    now = clock[:1] * cfg.tick_cycles
    now_end = now + cfg.tick_cycles

    # -- 2. arrivals -> per-flow queues (single gather) ---------------------
    arr_t, arr_sz = args["arr_t"], args["arr_sz"]
    M = arr_t.shape[2]
    jj = args["jj_arr"]
    pos = c["arr_ptr"][:, :, None] + jj
    gidx = torch.clamp(pos, max=M - 1).long()
    nxt_t = arr_t.gather(2, gidx)
    nxt_s = arr_sz.gather(2, gidx)
    due = (nxt_t < now_end) & (pos < M)
    n_due = due.sum(2, dtype=torch.int32)
    n_take = torch.minimum(n_due, torch.clamp(cfg.qlen - c["q_cnt"], min=0))
    take = due & (jj < n_take[:, :, None])
    slot = ((c["q_head"][:, :, None] + c["q_cnt"][:, :, None] + jj)
            % cfg.qlen).long()
    for k, v in (("q_sz", nxt_s), ("q_at", nxt_t)):
        c[k].scatter_(2, slot, torch.where(take, v, c[k].gather(2, slot)))
    c["q_cnt"] += n_take
    c["arr_ptr"] += n_due
    c["c_drops"] += n_due - n_take

    # -- 3. per-tick link budgets ------------------------------------------
    budget = args["bpc"] * float(cfg.tick_cycles) + c["lres"]  # [B, 2] bytes
    # extra resource axes: each a token bucket of [B, R] bytes.  R is a
    # shape (in the entry's key): with none, no resource op is computed
    res_w_eg = args.get("res_w_eg")
    res_bud = None
    if res_w_eg is not None:
        res_bud = args["res_cap"] * float(cfg.tick_cycles) + c["res_res"]

    # -- 1. token-bucket timers + 4. shaper + arbiter grants ---------------
    # one launch of the Hopper kernel a tick, one CTA an element (the plain
    # version on the CPU); grants are gated on and charge the resource axes
    tb_ops.grant_tick(cfg, args, c, budget, clock[1:], res_bud)

    # -- 5. accelerator service (pass-major: iteration i serves i % A) ------
    # int32 -> float32 rounds to nearest, as np.float32 of the tick's cycles
    f_now, f_end = now.float(), now_end.float()
    # the device's table (made once, never written: a graph reads it in
    # place)
    grid_i0, grid_frac = grid_position_table(svc_tab.device)
    for i in range(A * cfg.k_srv):
        a = i % A
        sa = slice(a, a + 1)
        # padded accel rows (ragged batching) are inert
        act = args["ac_cols"][a]
        if act is None:
            act = args["ac_mask"][:, a]
        lanes_a = c["lanes"][:, a]
        lane = torch.argmin(lanes_a, dim=1, keepdim=True)
        lv = lanes_a.gather(1, lane)
        # a lane that frees during this tick may chain back-to-back
        ok = (lv < f_end) & (c["aq_cnt"][:, sa] > 0)
        if act is False:
            ok = ok & False
        elif act is not True:
            ok = ok & act[:, None]
        h = c["aq_head"][:, sa].long()
        sz = c["aq_sz"][:, a].gather(1, h)
        fl = c["aq_fl"][:, a].gather(1, h).long()
        at = c["aq_at"][:, a].gather(1, h)
        szf = sz.float()
        gi = torch.clamp(sz, 0, GRID_TAB_MAX).long()[:, 0]
        i0 = grid_i0.gather(0, gi)[:, None]
        frac = grid_frac.gather(0, gi)[:, None]
        svc = _blend(svc_tab[:, a], i0, frac)
        esz = torch.where(fl_eg_full.gather(1, fl), szf,
                          _blend(eg_tab[:, a], i0, frac))
        end = torch.maximum(lv, f_now) + svc
        lanes_a.scatter_(1, lane, torch.where(ok, end, lv))
        oki = ok.to(torch.int32)
        c["aq_head"][:, sa] = (c["aq_head"][:, sa] + oki) % cfg.aq_len
        c["aq_cnt"][:, sa] -= oki
        c["aq_bytes"][:, sa] -= torch.where(ok, sz, 0)
        if sw is not False:
            # host-processing delay (software shaping): the LCG advances
            # once per active-accelerator iteration, busy or idle
            r = _lcg(c["rng"])
            adv = _both(act, sw if sw is True else sw[:, 0])
            if adv is True:
                c["rng"].copy_(r)
            elif adv is not False:
                c["rng"].copy_(torch.where(adv, r, c["rng"]))
            u = torch.remainder(r.long().abs(), 65536).float() / 65536.0
            hostd = _host_delay(u[:, None], args["sw_jit"], args["sw_delay"])
            ready = (end + hostd).to(torch.int32)
            if sw is not True:
                ready = torch.where(sw, ready, end.to(torch.int32))
        else:
            ready = end.to(torch.int32)
        # egress queue push
        d = fl_eg_dir.gather(1, fl)
        cnt_d = c["eq_cnt"].gather(1, d)
        slot = ((c["eq_head"].gather(1, d) + cnt_d) % cfg.eq_len).long()
        okq = ok & (cnt_d < cfg.eq_len)
        tb_ops.put_at(c["eq_sz"], d, slot, okq,
                      torch.clamp(esz.to(torch.int32), min=1))
        tb_ops.put_at(c["eq_isz"], d, slot, okq, sz)
        tb_ops.put_at(c["eq_fl"], d, slot, okq, fl.to(torch.int32))
        tb_ops.put_at(c["eq_at"], d, slot, okq, at)
        tb_ops.put_at(c["eq_rd"], d, slot, okq, ready)
        c["eq_cnt"].scatter_add_(1, d, okq.to(torch.int32))

    # -- 6. egress link + completions (sequential pops) ---------------------
    # A direction's pops are a prefix of the tick's iterations, so pass j
    # pops the entry j past the tick's first head either way.  Where a
    # direction does not pop, the reference's vectorised egress
    # (``stage_fast``) reads that entry and its sequential loop the current
    # head; the values reach the completion ring's scratch slot.
    dirs = args["dirs"]
    head0 = c["eq_head"].long()
    prev = torch.ones(3, dtype=torch.bool, device=dirs.device)
    for j in range(cfg.k_eg):
        h = ((head0 + j) % cfg.eq_len if cfg.stage_fast
             else c["eq_head"].long())[:, :, None]
        sz, isz, fl, at, rd = (c[k].gather(2, h)[:, :, 0] for k in
                               ("eq_sz", "eq_isz", "eq_fl", "eq_at", "eq_rd"))
        bud3 = torch.cat([budget, args["bud_off"]], dim=1)
        pop = prev & (c["eq_cnt"] > 0) & (rd < now_end) & (bud3 > 0.0)
        prev = pop
        popi = pop.to(torch.int32)
        c["eq_head"].add_(popi).remainder_(cfg.eq_len)
        c["eq_cnt"] -= popi
        budget = budget - torch.where(pop[:, :2],
                                      sz[:, :2].float() + args["ovh"], 0.0)
        if res_bud is not None:
            # ungated debt charge of every axis: the three directions'
            # products summed as the compiled reference contracts its
            # reduction (a fused multiply-add chain from the first
            # product), then subtracted
            w = res_w_eg.gather(2, fl.long()[:, None, :].expand(
                -1, res_w_eg.shape[1], -1))                     # [B, R, 3]
            e = torch.where(pop, sz, 0).float()[:, None, :]
            acc = w[:, :, 0] * e[:, :, 0]
            acc = fma32(w[:, :, 1], e[:, :, 1], acc)
            acc = fma32(w[:, :, 2], e[:, :, 2], acc)
            res_bud = res_bud - acc
        n_pop = popi.sum(1, dtype=torch.int32)
        c["credits_used"] -= n_pop
        # completion = transfer start + own serialization delay
        ser = torch.where(dirs < 2, sz.float() / args["bpc3"], 0.0)
        comp_time = torch.maximum(rd, now) + ser.to(torch.int32)
        lat = comp_time - at
        # completion ring; non-pops all land in the scratch slot comp_cap,
        # which ends up holding the last non-pop's values (as an in-order
        # scatter leaves it), written identically by every duplicate
        base = c["comp_n"]
        offs = torch.cumsum(popi, 1, dtype=torch.int32) - popi
        idx = torch.where(pop, (base[:, None] + offs) % cfg.comp_cap,
                          cfg.comp_cap).long()
        last = ((~pop).to(torch.int32) * args["ar3p1"]).argmax(
            dim=1, keepdim=True)
        for k, v in (("comp_fl", fl), ("comp_lat", lat),
                     ("comp_t", comp_time), ("comp_sz", isz)):
            c[k].scatter_(1, idx, torch.where(pop, v, v.gather(1, last)))
        c["comp_n"].add_(n_pop)
        # per-flow counters; integer adds commute, the float latency sum
        # is added direction by direction, in the reference's order
        fll = fl.long()
        c["c_done_msgs"].scatter_add_(1, fll, popi)
        lo = c["c_done_b_lo"].scatter_add(1, fll, torch.where(pop, isz, 0))
        c["c_done_b_hi"] += lo >> 20
        c["c_done_b_lo"].copy_(lo & 0xFFFFF)
        latf = torch.where(pop, lat.float(), 0.0)
        for d in range(3):
            c["c_lat_sum"].scatter_add_(1, fll[:, d:d + 1], latf[:, d:d + 1])

    # positive leftover budget is lost (a link cannot save idle time);
    # negative budget (serialization debt) carries
    c["lres"].copy_(torch.clamp(budget, max=0.0))
    if res_bud is not None:
        # each axis is a token bucket: unused budget carries up to the
        # axis' burst depth (0: idle capacity is lost, as on the link);
        # debt always carries
        c["res_res"].copy_(torch.minimum(res_bud, args["res_burst"]))
    clock.add_(1)


# ---------------------------------------------------------------------------
# The window's body and the module-level compile cache
# ---------------------------------------------------------------------------


def _run_core(cfg: SimConfig, args: dict, carry: dict,
              clock: torch.Tensor) -> None:
    """The window's eager body: ``cfg.n_ticks`` ticks from ``clock``."""
    for _ in range(cfg.n_ticks):
        _tick(cfg, args, carry, clock)


#: window arguments that are usually the same tensors window after window
#: (``run_managed`` passes one full-horizon trace to every window): copied
#: into an entry only when a window passes other tensors than its last
#: one, or the same ones changed since
_SHARED_KEYS = ("arr_t", "arr_sz")


def _map(fn, x):
    """``fn`` on every tensor of ``x`` (a tensor, a tuple or namedtuple of
    them, or a dict of those); other values as they are."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    if isinstance(x, tuple):
        out = [_map(fn, v) for v in x]
        return type(x)(*out) if hasattr(x, "_fields") else tuple(out)
    return x


def _one(carry: dict) -> dict:
    """A serial carry as a batch of one: [1, ...] views of its tensors, so
    the batched tick updates the caller's tensors in place."""
    return _map(lambda x: x.unsqueeze(0), carry)


def _load(dst, src) -> None:
    """Copy every tensor of ``src`` into the tensor at the same place in
    ``dst``, which has the same structure, shapes and dtypes."""
    if isinstance(dst, torch.Tensor):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"run_window: a {tuple(src.shape)} {src.dtype}"
                             f" tensor where the entry holds "
                             f"{tuple(dst.shape)} {dst.dtype}")
        dst.copy_(src)
    elif isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise ValueError(f"run_window: keys {sorted(src)} where the "
                             f"entry holds {sorted(dst)}")
        for k, v in dst.items():
            _load(v, src[k])
    elif isinstance(dst, tuple):
        for v, w in zip(dst, src, strict=True):
            _load(v, w)


def _args_sig(args: dict) -> tuple:
    """What a window's graph bakes in beyond the config: every argument
    tensor's shape, dtype and device, and every other argument's value (the
    shaping modes and arbiters present, the accelerator columns' mask
    states).  The carry's shapes follow from these and the config."""
    def sig(v):
        if isinstance(v, torch.Tensor):
            return (tuple(v.shape), v.dtype, v.device)
        if isinstance(v, (tuple, list)):
            return tuple(sig(y) for y in v)
        return v
    return tuple(sorted((k, sig(v)) for k, v in args.items()))


def _same_tensor(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same elements of the same storage, unwritten since ``b``'s
    version was read (views share their base's version counter)."""
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype
            and a.device == b.device)


class _Run:
    """One compile-cache entry: the argument, carry and clock buffers a
    tick of B dataplanes reads and writes at fixed addresses ([B, ...]
    leaves; B = 1 for the serial engine), and on the card the CUDA graph of
    one tick over them (captured at the entry's first window).

    A window loads the caller's arguments and carry into the buffers, sets
    the clock to ``(t0, 0)``, runs ``n_ticks`` ticks (graph replays on the
    card, ``_run_core`` on the CPU) and stores the buffers back into the
    caller's carry, so two dataplanes of one signature never share a
    returned carry.  The ``_SHARED_KEYS`` arguments are copied in only
    when they are not the tensors the last window passed.  Values that are
    not tensors were fixed at the first window; the key holds them."""

    def __init__(self, cfg: SimConfig, args: dict, carry: dict):
        self.cfg = cfg
        self.args = _map(torch.empty_like, args)
        self.carry = _map(torch.empty_like, carry)
        self.clock = torch.zeros(2, dtype=torch.int32,
                                 device=carry["rng"].device)
        self.graph = None
        self.traces = 0
        self._shared = None     # (the shared tensors last loaded, versions)

    def _load_shared(self, args: dict) -> None:
        src = [args[k] for k in _SHARED_KEYS]
        versions = [x._version for x in src]
        if self._shared is not None and versions == self._shared[1] and all(
                _same_tensor(a, b) for a, b in zip(src, self._shared[0])):
            return
        for k in _SHARED_KEYS:
            _load(self.args[k], args[k])
        self._shared = (src, versions)

    def _body(self) -> None:
        _tick(self.cfg, self.args, self.carry, self.clock)

    def _warmup(self) -> None:
        """One tick on copies of the carry and the clock: loads every
        kernel and makes the device's grid table before the capture, and
        leaves the dataplane where it was."""
        _tick(self.cfg, self.args, _map(torch.clone, self.carry),
              self.clock.clone())

    def __call__(self, carry: dict, args: dict, t0: int) -> dict:
        _load({k: v for k, v in self.args.items() if k not in _SHARED_KEYS},
              {k: v for k, v in args.items() if k not in _SHARED_KEYS})
        self._load_shared(args)
        _load(self.carry, carry)
        self.clock[0] = t0
        self.clock[1] = 0
        if self.clock.is_cuda:
            if self.graph is None:
                tb_ops._grant_launcher()     # the kernel library, loaded
                self.graph = cuda_graph.Captured(self._body, self._warmup)
                self.traces += 1
            for _ in range(self.cfg.n_ticks):
                self.graph.replay()
        else:
            # the CPU runs the same buffers through the eager body; its
            # first window stands for the capture
            self.traces = 1
            _run_core(self.cfg, self.args, self.carry, self.clock)
        _load(carry, self.carry)
        return carry


_RUN_CACHE: dict[Any, _Run] = {}
_CACHE_MAX = 64     # profiler sweeps can touch many context shapes; evict
                    # the oldest entries (FIFO) so a long-lived control
                    # plane does not accumulate graphs and buffers


def _get_run(key, builder) -> _Run:
    run = _RUN_CACHE.get(key)
    if run is None:
        if len(_RUN_CACHE) >= _CACHE_MAX:
            _RUN_CACHE.pop(next(iter(_RUN_CACHE)))
        run = builder()
        _RUN_CACHE[key] = run
    return run


def cache_info() -> dict[str, int]:
    """Compile-cache stats: distinct window signatures (serial and batch
    entries) and captures.

    ``traces`` counts the CUDA graphs captured across the cached entries
    (on the CPU, one for each entry that has run a window): a steady value
    across repeated ``simulate()`` / ``run_managed`` windows proves that
    no window captured again."""
    return {"entries": len(_RUN_CACHE),
            "traces": sum(r.traces for r in _RUN_CACHE.values())}


def cache_clear() -> None:
    _RUN_CACHE.clear()


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _prepare(flows: FlowSet, accels: AccelTable, link: LinkSpec,
             cfg: SimConfig, tb_state: tb.TBState, arr_t, arr_sz,
             stall_mask, t0_ticks, carry, device) -> tuple[dict, dict]:
    """A serial window's arguments and its carry (fresh, or ``carry`` with
    ``tb_state``'s registers written), both as a batch of one: the carry's
    leaves are [1, ...] views of the serial carry's tensors."""
    dev = resolve_device(device)
    args = _pack_args([flows], [accels], [link], [cfg],
                      _as_i32(arr_t, dev)[None], _as_i32(arr_sz, dev)[None],
                      _window_stall(stall_mask, cfg, t0_ticks), dev)
    if carry is None:
        carry = init_carry(flows, accels, cfg, tb_state,
                           n_res=len(getattr(link, "resources", ())),
                           device=dev)
    else:
        carry = reconfigure_carry(carry, tb_state)
    return args, _one(carry)


def run_window(flows: FlowSet, accels: AccelTable, link: LinkSpec,
               cfg: SimConfig, tb_state: tb.TBState, arr_t, arr_sz,
               stall_mask=None, *, t0_ticks: int = 0,
               carry: dict | None = None, device=None) -> dict:
    """Run one window of ``cfg.n_ticks`` ticks through the compile cache;
    returns the carry.

    ``carry=None`` starts a fresh dataplane with ``tb_state`` as its bucket
    state; a carry from an earlier window resumes it with ``tb_state``'s
    registers written (tokens clamp to the new bucket size).  The carry is
    updated in place — hand the returned one forward.  The window is the
    batched engine's tick at B = 1.  On the card the window replays its
    entry's CUDA graph ``n_ticks`` times (a capture or replay that fails
    raises); on the CPU the entry runs the eager body."""
    args, carry = _prepare(flows, accels, link, cfg, tb_state, arr_t,
                           arr_sz, stall_mask, t0_ticks, carry, device)
    key = ("single", _static_cfg(cfg), _args_sig(args))
    run = _get_run(key, lambda: _Run(_static_cfg(cfg), args, carry))
    return _map(lambda x: x[0], run(carry, args, int(t0_ticks)))


def _run_window_eager(flows: FlowSet, accels: AccelTable, link: LinkSpec,
                      cfg: SimConfig, tb_state: tb.TBState, arr_t, arr_sz,
                      stall_mask=None, *, t0_ticks: int = 0,
                      carry: dict | None = None, device=None) -> dict:
    """``run_window``'s eager body on the caller's carry, outside the
    compile cache: for the tests and the smoke's graph-against-eager
    comparisons only."""
    args, carry = _prepare(flows, accels, link, cfg, tb_state, arr_t,
                           arr_sz, stall_mask, t0_ticks, carry, device)
    clock = torch.tensor([int(t0_ticks), 0], dtype=torch.int32,
                         device=carry["rng"].device)
    _run_core(_static_cfg(cfg), args, carry, clock)
    return _map(lambda x: x[0], carry)


def _as_list(x, B):
    return list(x) if isinstance(x, (list, tuple)) else [x] * B


def _prepare_batch(flows, accels, link, cfg, tb_states, arr_t, arr_sz,
                   stall_mask, t0_ticks, carry, fl_masks, device):
    """A batched window's static config, arguments and carry, with the
    reference's checks (``run_window_batch``)."""
    if not hasattr(arr_t, "ndim"):       # nested python lists
        arr_t = np.asarray(arr_t)
        arr_sz = np.asarray(arr_sz)
    if arr_t.ndim != 3:
        raise ValueError(
            f"arr_t must be [B, N, M] (got ndim={arr_t.ndim}) — "
            "see stack_arrivals()")
    B = arr_t.shape[0]
    flows_l = _as_list(flows, B)
    accels_l = _as_list(accels, B)
    links_l = _as_list(link, B)
    cfgs_l = _as_list(cfg, B)
    if tb_states is None and carry is None:
        raise ValueError("tb_states=None is only valid when resuming a "
                         "carry (initial registers are required)")
    if not (len(accels_l) == B and len(links_l) == B
            and (tb_states is None or len(tb_states) == B)
            and len(flows_l) == B and len(cfgs_l) == B):
        raise ValueError(
            f"batch size mismatch: arr_t has B={B} but "
            f"flows={len(flows_l)}, accels={len(accels_l)}, "
            f"links={len(links_l)}, "
            f"tb_states={len(tb_states or [])}, cfgs={len(cfgs_l)}")
    cfg0 = cfgs_l[0]
    if any(_static_cfg(c) != _static_cfg(cfg0) for c in cfgs_l[1:]):
        raise ValueError(
            "batched SimConfigs may differ only in traced fields "
            f"{TRACED_CFG_FIELDS}")
    a_max = max(a.n for a in accels_l)
    padded_l = [pad_accel_table(a, a_max) for a in accels_l]
    n_res = _n_res(links_l)
    n_max = max(f.n for f in flows_l)
    if arr_t.shape[1] != n_max:
        raise ValueError(
            f"arr_t flow axis {arr_t.shape[1]} != n_flows_max {n_max} — "
            "see stack_arrivals()")
    if fl_masks is not None:
        if len(fl_masks) != B:
            raise ValueError(
                f"fl_masks must have one mask per element (got "
                f"{len(fl_masks)} for B={B})")
        for m in fl_masks:
            if np.asarray(m).shape != (n_max,):
                raise ValueError(
                    f"fl_masks entries must be [{n_max}] bool "
                    f"(got shape {np.asarray(m).shape})")
    stall = _window_stall(stall_mask, cfg0, t0_ticks)
    if stall.ndim == 2 and stall.shape[0] != B:
        raise ValueError(f"stall_mask must be [T] or [B={B}, T] (got shape "
                         f"{np.asarray(stall_mask).shape})")
    dev = resolve_device(device)
    args = _pack_args(flows_l, padded_l, links_l, cfgs_l,
                      _as_i32(arr_t, dev), _as_i32(arr_sz, dev), stall, dev,
                      fl_masks)
    if carry is None:
        carry = _stack([init_carry(flows_l[b], padded_l[b], cfg0,
                                   pad_tb_state(tb_states[b], n_max),
                                   n_flows=n_max, n_res=n_res, device=dev)
                        for b in range(B)])
    elif tb_states is not None:
        # resumed fleet window: write only the per-element parameter
        # "registers" (stacked [B, n_max] leaves), like run_window does;
        # tb_states=None resumes without touching the registers
        padded = [pad_tb_state(s, n_max) for s in tb_states]
        carry = reconfigure_carry(carry, tb.TBState(*(
            np.stack([_host_np(x) for x in xs]) for xs in zip(*padded))))
    return _static_cfg(cfg0), args, carry


def run_window_batch(flows: FlowSet | Sequence[FlowSet],
                     accels: AccelTable | Sequence[AccelTable],
                     link: LinkSpec | Sequence[LinkSpec],
                     cfg: SimConfig | Sequence[SimConfig],
                     tb_states: Sequence[tb.TBState] | None,
                     arr_t, arr_sz, stall_mask=None, *,
                     t0_ticks: int = 0, carry: dict | None = None,
                     fl_masks: Sequence[np.ndarray] | None = None,
                     device=None) -> dict:
    """Run B independent windows as one batch: every tensor of the tick
    carries a leading batch axis, one grant-tick launch a tick serves every
    element (one CTA each), and on the card the window replays its entry's
    CUDA graph of one tick.

    Batched per element: arrival trace, TBState registers, and (when
    sequences are passed) flow sets, SimConfigs, accelerator tables, link
    specs and ``[B, T]`` stall masks (a ``[T]`` mask is shared).  Flow sets
    may have *different flow counts*: they are padded to the largest count
    and masked (``fl_mask``), with counters of active lanes bitwise-equal
    to unpadded serial runs.  Accelerator tables may likewise have
    *different accelerator counts*: they are padded to the largest count
    (``pad_accel_table``) and masked (``ac_mask``), with the same bitwise
    guarantee.  SimConfigs may differ only in ``TRACED_CFG_FIELDS``
    (shaping, arbiter, software-delay model).

    Passing back the returned ``carry`` resumes all B dataplanes with fresh
    per-element TBState registers applied; ``tb_states=None`` resumes
    without the register rewrite.  The carry is updated in place — hand the
    returned one forward.  ``fl_masks`` (one ``[n_flows_max]`` bool array
    per element) overrides the default validity masks: a departed tenant's
    lane goes inert while every other lane keeps its position.  Returns
    the batched carry ([B, ...] leaves)."""
    cfg0, args, carry = _prepare_batch(
        flows, accels, link, cfg, tb_states, arr_t, arr_sz, stall_mask,
        t0_ticks, carry, fl_masks, device)
    B = args["bpc"].shape[0]
    key = ("batch", cfg0, B, _args_sig(args))
    run = _get_run(key, lambda: _Run(cfg0, args, carry))
    return run(carry, args, int(t0_ticks))


def _run_window_batch_eager(flows, accels, link, cfg, tb_states, arr_t,
                            arr_sz, stall_mask=None, *, t0_ticks: int = 0,
                            carry: dict | None = None, fl_masks=None,
                            device=None) -> dict:
    """``run_window_batch``'s eager body on the caller's carry, outside
    the compile cache: for the tests and the smoke's comparisons only."""
    cfg0, args, carry = _prepare_batch(
        flows, accels, link, cfg, tb_states, arr_t, arr_sz, stall_mask,
        t0_ticks, carry, fl_masks, device)
    clock = torch.tensor([int(t0_ticks), 0], dtype=torch.int32,
                         device=carry["rng"].device)
    _run_core(cfg0, args, carry, clock)
    return carry
