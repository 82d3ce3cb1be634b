"""Dataplane engine: the six-stage tick on torch tensors.

Port of ``src/repro/core/engine.py`` (serial ``run_window`` only).  A window
runs ``n_ticks`` ticks of ``_tick``, each the reference's tick in its
*sequential* form — ``grant_body``, ``srv_body`` and ``eg_body`` loops — with
every shaping mode (NONE / HW / SW with stall mask and host-delay LCG) and
every arbiter (RR / WRR / PRIORITY / WFQ):

    1. token-bucket timers      -> Hopper token-bucket kernel
                                   ``grant_tick``, one launch with stage 4
    2. arrivals -> flow queues
    3. per-tick link budgets
    4. shaper + arbiter grants  -> the same launch (``k_grant`` grants)
    5. accelerator service
    6. egress link + completions

Stages 1 and 4 run together, after 2 and 3 (which read neither the bucket
state nor ``sw_pend``): ``kernels/token_bucket/ops.grant_tick`` refills
every bucket and runs the ``k_grant`` sequential grants in one launch a
tick on the card (``grant_tick_plain`` on the CPU).  Stages 2, 3, 5 and 6
are eager PyTorch ops.

The reference asserts that its one-shot fast paths equal these loops
bitwise, so ``SimConfig.grant_fast`` / ``stage_fast`` are accepted and the
loops run regardless; ``stage_fast`` only picks which queue entry a
direction that does not pop leaves in the completion ring's scratch slot,
as the reference's two egress forms do.  Shaping mode and arbiter are
plain Python values here (the port has no batched engine yet), so a tick
computes only the branch its mode selects; ``where`` over both branches
gives the same bits.

The carry is a dict of tensors on one device (a ``TBState`` under ``"tb"``)
with the reference's keys, shapes and dtypes, and it is **updated in
place**: hand the returned carry forward, never reuse one passed in (the
reference donates it for the same reason).  The tick issues no host sync
(no ``.item()``, no Python branch on a tensor), and it changes no carry
tensor's identity or address and adds no key: every update is a
``copy_`` or an in-place op.  It reads its time from an int32 device
counter (the tick and its index in the window, the reference's traced
``t``) and advances it in place.

So a tick is capturable.  The reference jits each window (``_run_core``,
a ``lax.scan`` of ticks, cached in ``_RUN_CACHE`` by ``_get_run``); the
port's ``_RUN_CACHE`` holds an entry (``_Run``) per static signature:
the config, the link and accelerator values the tick bakes in, and all
shapes.  The entry owns the buffers a tick reads and writes; on the card it
captures one tick as a CUDA graph at its first window and replays it
``n_ticks`` times a window, and on the CPU it runs the same buffers through
the eager body.  ``cache_info()`` / ``cache_clear()`` as in the reference;
``_run_window_eager`` is the eager body outside the cache, for the tests
and the smoke's comparisons only.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import cuda_graph
from repro_torch.core import token_bucket as tb
from repro_torch.core.accelerator import (GRID_TAB_MAX, AccelTable, fma32,
                                          grid_blend, grid_position_table)
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


#: SimConfig fields the reference passes to its engine as traced values
#: (runtime mode words rather than compile-time structure)
TRACED_CFG_FIELDS = ("shaping", "arbiter", "sw_host_delay_cycles",
                     "sw_jitter_cycles")


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
               tb_state: tb.TBState, *, device=None) -> dict[str, Any]:
    dev = resolve_device(device)
    N, A = flows.n, accels.n
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
        res_res=z(0, dtype=torch.float32),   # no extra resource axes
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


def carry_to_numpy(carry: dict) -> dict:
    """Host copy of a carry (numpy leaves; "tb" as a tuple of arrays)."""
    def host(x):
        return x.to("cpu", copy=True).numpy()
    return {k: (tuple(host(x) for x in v) if k == "tb" else host(v))
            for k, v in carry.items()}


# ---------------------------------------------------------------------------
# Per-window arguments
# ---------------------------------------------------------------------------


def _accel_mask(tab: AccelTable) -> np.ndarray:
    """Per-accelerator validity mask (active = has at least one lane);
    active accelerators must form a prefix of the table."""
    m = np.asarray(tab.parallelism) > 0
    if np.any(~m[:-1] & m[1:]):
        raise ValueError(
            "active accelerators (parallelism > 0) must form a prefix of "
            f"the AccelTable (got parallelism={list(tab.parallelism)})")
    return m


def _flow_args(flows: FlowSet) -> dict[str, np.ndarray]:
    """Per-flow routing/weight tables (every lane is an active flow: the
    port has no padded batch, so no validity mask)."""
    return dict(
        fl_accel=np.asarray(flows.accel_id, np.int32),
        fl_in_dir=np.asarray(flows.ingress_dir, np.int32),
        fl_eg_dir=np.asarray(flows.egress_dir, np.int32),
        # inline-NIC-RX delivers the full payload to the host no matter what
        # the accelerator emits; other paths transfer the accel's output.
        fl_eg_full=np.asarray(flows.path == int(Path.INLINE_NIC_RX), bool),
        fl_prio=np.asarray(flows.priority, np.float32),
        fl_w=np.asarray(np.maximum(flows.weight, 1e-3), np.float32),
    )


def _window_stall(stall_mask, cfg: SimConfig, t0_ticks) -> np.ndarray:
    """Window-relative ``[n_ticks]`` stall mask: the window's one bound
    check of the grant tick's ``stall[t_idx]``, which the card reads."""
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
    if cfg.arbiter not in (ARB_RR, ARB_WRR, ARB_PRIORITY, ARB_WFQ):
        raise ValueError(cfg.arbiter)
    if cfg.shaping not in (SHAPING_NONE, SHAPING_HW, SHAPING_SW):
        raise ValueError(cfg.shaping)


def _as_i32(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.int32)
    return torch.as_tensor(np.asarray(x, np.int32), device=dev)


def _pack_args(flows: FlowSet, accels: AccelTable, link: LinkSpec,
               cfg: SimConfig, arr_t, arr_sz, stall_mask, t0_ticks,
               dev) -> dict[str, Any]:
    _check_modes(cfg)
    if getattr(link, "resources", ()):
        raise NotImplementedError(
            "repro_torch: the shaped resource vector (LinkSpec.resources) "
            "is not ported yet")
    h2d_bpc, d2h_bpc = link.bytes_per_cycle()
    fa = _flow_args(flows)
    ac_mask = _accel_mask(accels)
    t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=dev)  # noqa: E731
    args = tb_ops.grant_args(
        fa["fl_accel"], fa["fl_in_dir"], fa["fl_prio"], fa["fl_w"],
        ovh=link.msg_overhead_bytes, credits=link.credits,
        tick_cycles=cfg.tick_cycles,
        stall=_window_stall(stall_mask, cfg, t0_ticks), device=dev)
    args.update(
        arr_t=_as_i32(arr_t, dev), arr_sz=_as_i32(arr_sz, dev),
        svc_tab=t(accels.service_cycles, torch.float32),
        eg_tab=t(accels.egress_bytes, torch.float32),
        ac_mask=[bool(m) for m in ac_mask],
        bpc=t(np.asarray([h2d_bpc, d2h_bpc], np.float32), torch.float32),
        # per egress direction (dir 2 is off-fabric and never divides)
        bpc3=t(np.asarray([h2d_bpc, d2h_bpc, d2h_bpc], np.float32),
               torch.float32),
        fl_eg_dir=t(fa["fl_eg_dir"], torch.long),
        fl_eg_full=t(fa["fl_eg_full"], torch.bool),
        # constants reused every tick (no per-tick allocation from Python)
        jj_arr=torch.arange(cfg.k_arr, dtype=torch.int32, device=dev),
        dirs=torch.arange(3, dtype=torch.long, device=dev),
        ar3p1=torch.arange(1, 4, dtype=torch.int32, device=dev),
        bud_off=torch.full((1,), tb_ops.BIG, dtype=torch.float32,
                           device=dev),
    )
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


def _tick(cfg: SimConfig, args: dict, c: dict, clock: torch.Tensor) -> None:
    """One simulated tick, in place on the carry ``c``: no carry tensor
    changes identity or address.  ``clock`` is the int32 [2] device counter
    (the tick, the tick's index in its window); the tick reads it on the
    device and advances it at its end, so a CUDA graph of one tick replays
    as the next tick."""
    fl_eg_dir, fl_eg_full = args["fl_eg_dir"], args["fl_eg_full"]
    svc_tab, eg_tab = args["svc_tab"], args["eg_tab"]
    ac_mask = args["ac_mask"]
    ovh = args["ovh"]
    A = svc_tab.shape[0]
    sw = cfg.shaping == SHAPING_SW

    # [1] int32 cycles, wrapping as the reference's traced int32 t does
    now = clock[:1] * cfg.tick_cycles
    now_end = now + cfg.tick_cycles

    # -- 2. arrivals -> per-flow queues (single gather) ---------------------
    arr_t, arr_sz = args["arr_t"], args["arr_sz"]
    M = arr_t.shape[1]
    jj = args["jj_arr"]
    pos = c["arr_ptr"][:, None] + jj[None, :]
    gidx = torch.clamp(pos, max=M - 1).long()
    nxt_t = arr_t.gather(1, gidx)
    nxt_s = arr_sz.gather(1, gidx)
    due = (nxt_t < now_end) & (pos < M)
    n_due = due.sum(1, dtype=torch.int32)
    n_take = torch.minimum(n_due, torch.clamp(cfg.qlen - c["q_cnt"], min=0))
    take = due & (jj[None, :] < n_take[:, None])
    slot = ((c["q_head"][:, None] + c["q_cnt"][:, None] + jj[None, :])
            % cfg.qlen).long()
    for k, v in (("q_sz", nxt_s), ("q_at", nxt_t)):
        c[k].scatter_(1, slot, torch.where(take, v, c[k].gather(1, slot)))
    c["q_cnt"] += n_take
    c["arr_ptr"] += n_due
    c["c_drops"] += n_due - n_take

    # -- 3. per-tick link budgets ------------------------------------------
    budget = args["bpc"] * float(cfg.tick_cycles) + c["lres"]  # [2] bytes

    # -- 1. token-bucket timers + 4. shaper + arbiter grants ---------------
    # one launch of the Hopper kernel a tick (the plain version on the CPU)
    tb_ops.grant_tick(cfg, args, c, budget, clock[1:])

    # -- 5. accelerator service (pass-major: iteration i serves i % A) ------
    # int32 -> float32 rounds to nearest, as np.float32 of the tick's cycles
    f_now, f_end = now.float(), now_end.float()
    # the device's table (made once, never written: a graph reads it in
    # place)
    grid_i0, grid_frac = grid_position_table(svc_tab.device)
    for i in range(A * cfg.k_srv):
        a = i % A
        sa = slice(a, a + 1)
        lanes_a = c["lanes"][a]
        lane = torch.argmin(lanes_a, dim=0, keepdim=True)
        lv = lanes_a.gather(0, lane)
        # a lane that frees during this tick may chain back-to-back
        ok = (lv < f_end) & (c["aq_cnt"][sa] > 0)
        if not ac_mask[a]:
            ok = ok & False
        h = c["aq_head"][sa].long()
        sz = c["aq_sz"][a].gather(0, h)
        fl = c["aq_fl"][a].gather(0, h).long()
        at = c["aq_at"][a].gather(0, h)
        szf = sz.float()
        gi = torch.clamp(sz, 0, GRID_TAB_MAX).long()
        i0, frac = grid_i0.gather(0, gi), grid_frac.gather(0, gi)
        svc = grid_blend(svc_tab, a, i0, frac)
        esz = torch.where(fl_eg_full.gather(0, fl), szf,
                          grid_blend(eg_tab, a, i0, frac))
        end = torch.maximum(lv, f_now) + svc
        lanes_a.scatter_(0, lane, torch.where(ok, end, lv))
        oki = ok.to(torch.int32)
        c["aq_head"][sa] = (c["aq_head"][sa] + oki) % cfg.aq_len
        c["aq_cnt"][sa] -= oki
        c["aq_bytes"][sa] -= torch.where(ok, sz, 0)
        if sw:
            # host-processing delay: the LCG advances once per active-
            # accelerator iteration, busy or idle
            r = _lcg(c["rng"])
            if ac_mask[a]:
                c["rng"].copy_(r)
            u = torch.remainder(r.long().abs(), 65536).float() / 65536.0
            hostd = _host_delay(u, args["sw_jit"], args["sw_delay"])
            ready = (end + hostd).to(torch.int32)
        else:
            ready = end.to(torch.int32)
        # egress queue push
        d = fl_eg_dir.gather(0, fl)
        cnt_d = c["eq_cnt"].gather(0, d)
        slot = ((c["eq_head"].gather(0, d) + cnt_d) % cfg.eq_len).long()
        okq = ok & (cnt_d < cfg.eq_len)
        tb_ops.put_at(c["eq_sz"], d, slot, okq,
             torch.clamp(esz.to(torch.int32), min=1))
        tb_ops.put_at(c["eq_isz"], d, slot, okq, sz)
        tb_ops.put_at(c["eq_fl"], d, slot, okq, fl.to(torch.int32))
        tb_ops.put_at(c["eq_at"], d, slot, okq, at)
        tb_ops.put_at(c["eq_rd"], d, slot, okq, ready)
        c["eq_cnt"].scatter_add_(0, d, okq.to(torch.int32))

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
             else c["eq_head"].long())[:, None]
        sz, isz, fl, at, rd = (c[k].gather(1, h)[:, 0] for k in
                               ("eq_sz", "eq_isz", "eq_fl", "eq_at", "eq_rd"))
        bud3 = torch.cat([budget, args["bud_off"]])
        pop = prev & (c["eq_cnt"] > 0) & (rd < now_end) & (bud3 > 0.0)
        prev = pop
        popi = pop.to(torch.int32)
        c["eq_head"].add_(popi).remainder_(cfg.eq_len)
        c["eq_cnt"] -= popi
        budget = budget - torch.where(pop[:2], sz[:2].float() + ovh, 0.0)
        n_pop = popi.sum(dtype=torch.int32)
        c["credits_used"] -= n_pop
        # completion = transfer start + own serialization delay
        ser = torch.where(dirs < 2, sz.float() / args["bpc3"], 0.0)
        comp_time = torch.maximum(rd, now) + ser.to(torch.int32)
        lat = comp_time - at
        # completion ring; non-pops all land in the scratch slot comp_cap,
        # which ends up holding the last non-pop's values (as an in-order
        # scatter leaves it), written identically by every duplicate
        base = c["comp_n"]
        offs = torch.cumsum(popi, 0, dtype=torch.int32) - popi
        idx = torch.where(pop, (base + offs) % cfg.comp_cap,
                          cfg.comp_cap).long()
        last = ((~pop).to(torch.int32) * args["ar3p1"]).argmax(
            dim=0, keepdim=True)
        for k, v in (("comp_fl", fl), ("comp_lat", lat),
                     ("comp_t", comp_time), ("comp_sz", isz)):
            c[k].scatter_(0, idx, torch.where(pop, v, v.gather(0, last)))
        c["comp_n"].add_(n_pop)
        # per-flow counters; integer adds commute, the float latency sum
        # is added direction by direction, in the reference's order
        fll = fl.long()
        c["c_done_msgs"].scatter_add_(0, fll, popi)
        lo = c["c_done_b_lo"].scatter_add(0, fll, torch.where(pop, isz, 0))
        c["c_done_b_hi"] += lo >> 20
        c["c_done_b_lo"].copy_(lo & 0xFFFFF)
        latf = torch.where(pop, lat.float(), 0.0)
        for d in range(3):
            c["c_lat_sum"].scatter_add_(0, fll[d:d + 1], latf[d:d + 1])

    # positive leftover budget is lost (a link cannot save idle time);
    # negative budget (serialization debt) carries
    c["lres"].copy_(torch.clamp(budget, max=0.0))
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
    link's overhead and credits, the accelerator mask, the host-delay
    constants).  The carry's shapes follow from these and the config."""
    def sig(v):
        if isinstance(v, torch.Tensor):
            return (tuple(v.shape), v.dtype, v.device)
        if isinstance(v, (tuple, list)):
            return tuple(sig(y) for y in v)
        return v
    return tuple(sorted((k, sig(v)) for k, v in args.items()))


class _Run:
    """One compile-cache entry: the argument, carry and clock buffers a
    tick reads and writes at fixed addresses, and on the card the CUDA
    graph of one tick over them (captured at the entry's first window).

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
                a is b for a, b in zip(src, self._shared[0])):
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
    """Compile-cache stats: distinct window signatures and captures.

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
    """A window's arguments and its carry (fresh, or ``carry`` with
    ``tb_state``'s registers written)."""
    dev = resolve_device(device)
    args = _pack_args(flows, accels, link, cfg, arr_t, arr_sz, stall_mask,
                      t0_ticks, dev)
    if cfg.shaping == SHAPING_SW:
        args["sw_delay"] = _f32(cfg.sw_host_delay_cycles)
        args["sw_jit"] = _f32(cfg.sw_jitter_cycles)
    if carry is None:
        carry = init_carry(flows, accels, cfg, tb_state, device=dev)
    else:
        carry = reconfigure_carry(carry, tb_state)
    return args, carry


def run_window(flows: FlowSet, accels: AccelTable, link: LinkSpec,
               cfg: SimConfig, tb_state: tb.TBState, arr_t, arr_sz,
               stall_mask=None, *, t0_ticks: int = 0,
               carry: dict | None = None, device=None) -> dict:
    """Run one window of ``cfg.n_ticks`` ticks through the compile cache;
    returns the carry.

    ``carry=None`` starts a fresh dataplane with ``tb_state`` as its bucket
    state; a carry from an earlier window resumes it with ``tb_state``'s
    registers written (tokens clamp to the new bucket size).  The carry is
    updated in place — hand the returned one forward.  On the card the
    window replays its entry's CUDA graph ``n_ticks`` times (a capture or
    replay that fails raises); on the CPU the entry runs the eager body."""
    args, carry = _prepare(flows, accels, link, cfg, tb_state, arr_t,
                           arr_sz, stall_mask, t0_ticks, carry, device)
    key = ("single", cfg, _args_sig(args))
    run = _get_run(key, lambda: _Run(cfg, args, carry))
    return run(carry, args, int(t0_ticks))


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
    _run_core(cfg, args, carry, clock)
    return carry
