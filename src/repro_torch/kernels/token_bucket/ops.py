"""Token-bucket shaper: the Hopper kernels' wrappers and their plain PyTorch
versions.

Port of ``src/repro/kernels/token_bucket/ops.py`` (whose Pallas kernel is
``kernel.py::_tb_kernel``).  ``csrc/token_bucket.cu`` (built at first use)
holds two kernels:

* ``token_bucket_step`` advances every flow's bucket by ``elapsed`` cycles
  and, where ``want`` is given, admits the flows that want to send and can
  pay ``cost`` (bytes in GBPS mode, one message in IOPS mode): the TPU
  kernel's function, one launch a call (the serving scheduler's buckets).
* ``grant_tick`` is the dataplane tick's stages 1 and 4 in one launch: the
  token-bucket timers of every flow, then ``k_grant`` sequential shaper +
  arbiter grants (eligibility, arbiter key, argmin, queue pop, link budget,
  credits, accelerator-queue push, arbiter state, admission counters), for
  every element of a batch of dataplanes at once (one CTA an element; the
  serial engine is a batch of one).  It carries the TPU kernel's "refill
  and admission for every flow in one launch" on to the decision the
  engine makes around it.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version (``token_bucket_step_plain``,
``grant_tick_plain``), which the kernel repeats bit for bit.  ``LAUNCHES``
counts launches of both kernels and nothing else; ``LAUNCHES_BY_PATH``
splits them by kernel.
"""
from __future__ import annotations

import ctypes
import pathlib

import numpy as np
import torch

from repro_torch.core import token_bucket as tb
from repro_torch.core.accelerator import fma32
from repro_torch.core.interconnect import ARB_PRIORITY, ARB_WFQ, ARB_WRR
from repro_torch.core.token_bucket import TBState, wrap_i32
from repro_torch.kernels import _build

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "token_bucket.cu"
_FN = None
_GRANT_FN = None

#: shaping mode words of the dataplane (``SimConfig.shaping``)
SHAPING_NONE = 0
SHAPING_HW = 1
SHAPING_SW = 2
#: the arbiter key of an ineligible flow (float32)
BIG = float(np.float32(3e38))
#: flows ``grant_tick``'s kernel holds (1024 threads, 8 flows a thread)
MAX_GRANT_FLOWS = 8192

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
#: the same launches by kernel
LAUNCHES_BY_PATH = {"step": 0, "grant_tick": 0}


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.build("token_bucket", _SRC).tb_step_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def build() -> float:
    """Build (or load) the kernel library; seconds the build took."""
    _launcher()
    return _build.BUILD_SECONDS["token_bucket"]


def _elapsed_tensor(elapsed, like: torch.Tensor) -> torch.Tensor:
    if isinstance(elapsed, torch.Tensor):
        return elapsed.to(torch.int32)
    return torch.full((1,), int(elapsed), dtype=torch.int32,
                      device=like.device)


def token_bucket_step_plain(state: TBState, elapsed, cost=None, want=None
                            ) -> tuple[TBState, torch.Tensor | None]:
    """The kernel's function in plain PyTorch ops (any device): the same
    floor division and modulo, and int32 wraparound via int64."""
    e = _elapsed_tensor(elapsed, state.tokens)
    interval = torch.clamp(state.interval, min=1)
    total = wrap_i32(state.cyc.long() + e)
    k = torch.div(total, interval, rounding_mode="floor")
    cyc = torch.remainder(total, interval)
    k = torch.minimum(k, torch.div(state.bkt_size,
                                   torch.clamp(state.refill_rate, min=1),
                                   rounding_mode="floor") + 1)
    tok = wrap_i32(state.tokens.long() + k.long() * state.refill_rate)
    tok = torch.minimum(tok, state.bkt_size)
    admit = None
    if want is not None:
        c = torch.where(state.mode == 0, cost, 1)
        admit = want & (tok >= c)
        tok = torch.where(admit, wrap_i32(tok.long() - c), tok)
    return state._replace(tokens=tok, cyc=cyc), admit


def _check(name: str, x: torch.Tensor, shape, dtype, dev,
           fn: str = "token_bucket_step") -> None:
    shape = tuple(shape)
    if x.device != dev or x.dtype != dtype or not x.is_contiguous() \
            or tuple(x.shape) != shape:
        raise ValueError(
            f"{fn}: {name} must be a contiguous {list(shape)} {dtype} "
            f"tensor on {dev} (got {tuple(x.shape)} {x.dtype} on {x.device},"
            f" contiguous={x.is_contiguous()})")


def token_bucket_step(state: TBState, elapsed, cost=None, want=None, *,
                      out: tuple[torch.Tensor, torch.Tensor] | None = None
                      ) -> tuple[TBState, torch.Tensor | None]:
    """Refill every bucket by ``elapsed`` cycles (an int, a [1] tensor
    broadcast to all flows, or a per-flow [N] int32 tensor) and, when
    ``want`` ([N] bool) is given, admit and charge ``cost`` ([N] int32).

    Returns the new state (registers shared with ``state``) and the [N]
    bool admissions (``None`` without ``want``).  ``out=(tokens, cyc)``
    names the output buffers; they may be the input buffers (in place)."""
    tokens = state.tokens
    if tokens.device.type == "cpu":
        new, admit = token_bucket_step_plain(state, elapsed, cost, want)
        if out is not None:
            out[0].copy_(new.tokens)
            out[1].copy_(new.cyc)
            new = new._replace(tokens=out[0], cyc=out[1])
        return new, admit
    if tokens.device.type != "cuda":
        raise ValueError(f"token_bucket_step: unsupported device "
                         f"{tokens.device}")
    global LAUNCHES
    dev, n = tokens.device, tokens.shape[0]
    for name in TBState._fields:
        _check(name, getattr(state, name), (n,), torch.int32, dev)
    e = _elapsed_tensor(elapsed, tokens)
    if e.device != dev or e.dtype != torch.int32 or e.ndim != 1 \
            or e.shape[0] not in (1, n) or not e.is_contiguous():
        raise ValueError("token_bucket_step: elapsed must be a contiguous "
                         f"[1] or [{n}] int32 tensor on {dev}")
    if (want is None) != (cost is None):
        raise ValueError("token_bucket_step: pass cost and want together")
    if want is not None:
        _check("cost", cost, (n,), torch.int32, dev)
        _check("want", want, (n,), torch.bool, dev)
    tok_out, cyc_out = out if out is not None else (torch.empty_like(tokens),
                                                    torch.empty_like(tokens))
    _check("out tokens", tok_out, (n,), torch.int32, dev)
    _check("out cyc", cyc_out, (n,), torch.int32, dev)
    admit = torch.empty_like(tokens, dtype=torch.bool) \
        if want is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    err = _launcher()(
        n, ptr(tokens), ptr(state.cyc), ptr(state.refill_rate),
        ptr(state.bkt_size), ptr(state.interval), ptr(state.mode), ptr(e),
        0 if e.shape[0] == 1 else 1, ptr(cost), ptr(want), ptr(tok_out),
        ptr(cyc_out), ptr(admit), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"token_bucket kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    LAUNCHES_BY_PATH["step"] += 1
    return state._replace(tokens=tok_out, cyc=cyc_out), admit


# ---------------------------------------------------------------------------
# The dataplane's grant tick: stage 1 (timers) + stage 4 (grants)
# ---------------------------------------------------------------------------


def grant_args(fl_accel, fl_in_dir, fl_prio, fl_w, fl_mask, *, ovh,
               credits, shaping, arbiter, tick_cycles: int, stall,
               device) -> dict:
    """The per-window arguments of ``grant_tick`` (a part of the engine's
    ``args``) for B batch elements of N flows each: every flow's
    accelerator, ingress direction, priority and weight (floored at 1e-3
    by the caller) and whether it is an active lane (``fl_mask``), all
    [B, N]; each element's per-message fabric overhead, root-complex
    credits, shaping mode and arbiter, all [B]; the tick's cycles; and the
    window's stall masks, [B, n_ticks] or one [1, n_ticks] row for every
    element.  ``modes`` and ``arbs`` are the shaping modes and arbiters
    the batch holds (the engine keys its entries on them): a tick computes
    only their branches."""
    t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=device)  # noqa: E731
    fl_in_dir = np.asarray(fl_in_dir, np.int32)
    B, N = fl_in_dir.shape
    col = lambda x, dt: np.asarray(x, dt).reshape(B, 1)  # noqa: E731
    shaping, arbiter = col(shaping, np.int32), col(arbiter, np.int32)
    return dict(
        fl_accel=t(np.asarray(fl_accel, np.int64), torch.long),
        fl_in_dir=t(fl_in_dir, torch.int32),
        fl_in01=t(np.minimum(fl_in_dir, 1), torch.long),
        fl_in_off=t(fl_in_dir == 2, torch.bool),
        fl_prio=t(np.asarray(fl_prio, np.float32), torch.float32),
        fl_w=t(np.asarray(fl_w, np.float32), torch.float32),
        fl_mask=t(np.asarray(fl_mask, bool), torch.bool),
        ovh=t(col(ovh, np.float32), torch.float32),
        credits=t(col(credits, np.int32), torch.int32),
        mode=t(shaping, torch.int32), arb=t(arbiter, torch.int32),
        modes=tuple(sorted(set(shaping.ravel().tolist()))),
        arbs=tuple(sorted(set(arbiter.ravel().tolist()))),
        stall=t(np.asarray(stall, bool).reshape(-1, np.shape(stall)[-1]),
                torch.bool),
        # constants reused every tick (no per-tick allocation from Python)
        iota_n=torch.arange(N, dtype=torch.int32, device=device),
        iota_l=torch.arange(N, dtype=torch.long, device=device),
        ar2=torch.arange(2, dtype=torch.long, device=device),
        e_tick=torch.full((1,), tick_cycles, dtype=torch.int32,
                          device=device))


def word_is(present: tuple, words: torch.Tensor, word: int):
    """Where a batch element's mode word is ``word``: ``True`` or ``False``
    when the batch's words (``present``, static) settle it for every
    element, else the [B, 1] bool tensor."""
    if word not in present:
        return False
    if len(present) == 1:
        return True
    return words == word


def arb_key(arb: int, rr_key, fl_prio, vft):
    """Arbiter key (lower = served first) from the cyclic RR key; the
    compiled reference fuses each product into its add."""
    if arb == ARB_PRIORITY:
        return fma32(-fl_prio, 1e6, rr_key)
    if arb in (ARB_WRR, ARB_WFQ):
        return fma32(float(np.float32(1e-6)), rr_key, vft)
    return rr_key


# Single elements are read and written through [B, 1]-shaped index tensors
# with gather / scatter_ on per-element flat views: indexing with a 0-dim
# tensor would read it back to the host, and advanced indexing /
# index_put_ cost several launches (sorting, bounds asserts) per element on
# the GPU.


def put_at(x: torch.Tensor, row: torch.Tensor, col: torch.Tensor, ok, v):
    """x[b, row[b], col[b]] = v[b] where ``ok[b]`` (else unchanged), for
    [B, 1] indices into a [B, R, C] tensor."""
    flat = row * x.shape[2] + col
    xv = x.view(x.shape[0], -1)
    old = xv.gather(1, flat)
    xv.scatter_(1, flat, torch.where(ok, v, old))


def grant_tick_plain(cfg, args: dict, c: dict, budget: torch.Tensor,
                     t_idx: torch.Tensor) -> None:
    """Stages 1 and 4 of the tick whose index in its window is ``t_idx``
    (a [1] int32 tensor on the carry's device, read there), in plain
    PyTorch ops (any device), in place on the batched carry ``c`` (every
    leaf [B, ...]) and the [B, 2] link ``budget``: every flow's token-bucket
    timers, then ``k_grant`` sequential grants in each element.  No carry
    tensor changes identity or address.

    The refill may run after stages 2 and 3 (as here): they read neither
    the bucket state nor ``sw_pend``.  A grant charges its cost as
    ``tokens - cost``: after the refill every bucket holds at most its size
    and ``cyc < interval``, so the zero-cycle step with admission the
    engine used to call changes no other bit."""
    fl_accel, fl_in_dir = args["fl_accel"], args["fl_in_dir"]
    ovh, credits = args["ovh"], args["credits"]
    iota_n, iota_l = args["iota_n"], args["iota_l"]
    N = iota_n.shape[0]
    modes, arbs = args["modes"], args["arbs"]
    sw = word_is(modes, args["mode"], SHAPING_SW)
    unshaped = word_is(modes, args["mode"], SHAPING_NONE)
    st = c["tb"]

    # -- 1. token-bucket timers ---------------------------------------------
    # host descheduled (software shaping): refills deferred, catch up on
    # wakeup; hardware shaping and unshaped systems tick every cycle
    if sw is not False:
        stall = args["stall"]
        # [B or 1, 1]: each element's stall bit, gathered on the device
        is_stall = stall.gather(1, t_idx.long().expand(stall.shape[0], 1))
        if sw is not True:
            is_stall = is_stall & sw
        pend = c["sw_pend"] + cfg.tick_cycles
        elapsed = torch.where(is_stall, 0, pend)
        if sw is not True:
            elapsed = torch.where(sw, elapsed, cfg.tick_cycles)
        c["sw_pend"].copy_(torch.where(is_stall, pend, 0))
    else:
        elapsed = args["e_tick"]
        c["sw_pend"].zero_()
    new, _ = token_bucket_step_plain(st, elapsed)
    st.tokens.copy_(new.tokens)
    st.cyc.copy_(new.cyc)

    # -- 4. shaper + arbiter grants (sequential argmin loop) ----------------
    b = budget
    wrr = word_is(arbs, args["arb"], ARB_WRR)
    if wrr is not False:
        vft_unit = 1.0 / args["fl_w"]
    if arbs != (0,):
        # the tie-break term of the other arbiters counts modulo the
        # element's active flows (RR cycles modulo N: a mid-table hole
        # then keeps every active lane's place)
        n_act = torch.clamp(args["fl_mask"].sum(1, keepdim=True,
                                                dtype=torch.int32), min=1)
    gbps = st.mode == tb.MODE_GBPS     # registers are fixed in a tick
    for _ in range(cfg.k_grant):
        head = c["q_head"].long()[:, :, None]
        head_sz = c["q_sz"].gather(2, head)[:, :, 0]
        head_at = c["q_at"].gather(2, head)[:, :, 0]
        cost = torch.where(gbps, head_sz, 1)
        elig = ((c["q_cnt"] > 0)
                & (c["aq_cnt"].gather(1, fl_accel) < cfg.aq_len)
                & (c["aq_bytes"].gather(1, fl_accel) + head_sz
                   <= cfg.aq_byte_cap)
                & (c["credits_used"][:, None] < credits)
                & args["fl_mask"])
        if unshaped is False:
            elig &= st.tokens >= cost
        elif unshaped is not True:
            elig &= (st.tokens >= cost) | unshaped
        # a message may start whenever the link has *any* budget left; it
        # then drives the budget negative (its serialization time)
        bud_f = torch.where(args["fl_in_off"], BIG,
                            b.gather(1, args["fl_in01"]))
        elig &= bud_f > 0.0
        if sw is not False:
            elig &= ~is_stall
        # arbiter key (lower = served first): lanes in cyclic order after
        # the last grant, under priority or virtual finish time for the
        # other arbiters
        d = iota_n - c["rr_ptr"][:, None] - 1
        key = None
        for arb in arbs:
            k_arb = arb_key(arb, torch.remainder(
                d, N if arb == 0 else n_act).float(), args["fl_prio"],
                c["vft"])
            key = k_arb if key is None else torch.where(
                args["arb"] == arb, k_arb, key)
        key = torch.where(elig, key, BIG)
        g = torch.argmin(key, dim=1, keepdim=True)          # [B, 1]
        ok = elig.gather(1, g)
        sz = head_sz.gather(1, g)
        at = head_at.gather(1, g)
        onehot = (iota_l == g) & ok
        onehot_i, ok_i, g_i = (x.to(torch.int32) for x in (onehot, ok, g))
        szf = sz.float()
        # consume tokens (transparent unshaped)
        if unshaped is not True:
            pay = onehot if unshaped is False else onehot & ~unshaped
            st.tokens.sub_(torch.where(pay, cost, 0))
        # pop flow queue
        c["q_head"].add_(onehot_i).remainder_(cfg.qlen)
        c["q_cnt"] -= onehot_i
        # link budget + credits (per-message fabric overhead included)
        spend = torch.where((fl_in_dir.gather(1, g) != 2) & ok, szf + ovh,
                            0.0)
        b = b - torch.where(args["ar2"] == args["fl_in01"].gather(1, g),
                            spend, 0.0)
        c["credits_used"] += ok_i[:, 0]
        # accel queue push
        a = fl_accel.gather(1, g)
        slot = ((c["aq_head"].gather(1, a) + c["aq_cnt"].gather(1, a))
                % cfg.aq_len).long()
        put_at(c["aq_sz"], a, slot, ok, sz)
        put_at(c["aq_fl"], a, slot, ok, g_i)
        put_at(c["aq_at"], a, slot, ok, at)
        c["aq_cnt"].scatter_add_(1, a, ok_i)
        c["aq_bytes"].scatter_add_(1, a, torch.where(ok, sz, 0))
        # arbiter state (WRR message-granular, WFQ byte-granular)
        c["rr_ptr"].copy_(torch.where(ok, g_i, c["rr_ptr"][:, None])[:, 0])
        vft_inc = szf / args["fl_w"]
        if wrr is not False:
            vft_inc = vft_unit if wrr is True else torch.where(
                wrr, vft_unit, vft_inc)
        c["vft"].add_(torch.where(onehot, vft_inc, 0.0))
        # counters
        c["c_adm_msgs"] += onehot_i
        lo = c["c_adm_b_lo"] + torch.where(onehot, sz, 0)
        c["c_adm_b_hi"] += lo >> 20
        c["c_adm_b_lo"].copy_(lo & 0xFFFFF)
    budget.copy_(b)


class GrantTickArgs(ctypes.Structure):
    """The kernel's argument block, field for field as ``struct
    GrantTickArgs`` in ``csrc/token_bucket.cu``: pointers to the batched
    carry's and the window's tensors (the tick's index among them, so that
    one block serves every tick of a window), then the window's shapes."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "tokens", "cyc", "refill", "bkt", "interval", "mode", "sw_pend",
        "q_head", "q_cnt", "q_sz", "q_at", "vft", "fl_w", "fl_prio",
        "fl_accel", "fl_in_dir", "fl_mask", "rr_ptr", "credits_used",
        "budget", "aq_head", "aq_cnt", "aq_bytes", "aq_sz", "aq_fl", "aq_at",
        "c_adm_msgs", "c_adm_b_lo", "c_adm_b_hi", "shaping", "arbiter",
        "credits", "ovh", "stall", "t_idx")] + [
        (name, ctypes.c_int) for name in (
            "n", "n_accel", "qlen", "aq_len", "aq_byte_cap", "k_grant",
            "tick_cycles", "stall_stride")]


def _grant_launcher():
    global _GRANT_FN
    if _GRANT_FN is None:
        fn = _build.build("token_bucket", _SRC).tb_grant_tick_launch
        fn.argtypes = [ctypes.POINTER(GrantTickArgs), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _GRANT_FN = fn
    return _GRANT_FN


def _grant_struct(cfg, args: dict, c: dict, budget: torch.Tensor,
                  t_idx: torch.Tensor) -> GrantTickArgs:
    """The checked argument block of one launch."""
    st = c["tb"]
    dev = st.tokens.device
    if st.tokens.ndim != 2:
        raise ValueError("grant_tick: tokens must be a [B, N] tensor (got "
                         f"{tuple(st.tokens.shape)})")
    B, N = st.tokens.shape
    A = c["aq_cnt"].shape[-1]
    stall = args["stall"]
    i32, f32 = torch.int32, torch.float32
    flow = (B, N)
    shapes = dict(
        tokens=(st.tokens, flow, i32), cyc=(st.cyc, flow, i32),
        refill=(st.refill_rate, flow, i32), bkt=(st.bkt_size, flow, i32),
        interval=(st.interval, flow, i32), mode=(st.mode, flow, i32),
        sw_pend=(c["sw_pend"], flow, i32), q_head=(c["q_head"], flow, i32),
        q_cnt=(c["q_cnt"], flow, i32),
        q_sz=(c["q_sz"], (B, N, cfg.qlen), i32),
        q_at=(c["q_at"], (B, N, cfg.qlen), i32), vft=(c["vft"], flow, f32),
        fl_w=(args["fl_w"], flow, f32), fl_prio=(args["fl_prio"], flow, f32),
        fl_accel=(args["fl_accel"], flow, torch.long),
        fl_in_dir=(args["fl_in_dir"], flow, i32),
        fl_mask=(args["fl_mask"], flow, torch.bool),
        rr_ptr=(c["rr_ptr"], (B,), i32),
        credits_used=(c["credits_used"], (B,), i32),
        budget=(budget, (B, 2), f32),
        aq_head=(c["aq_head"], (B, A), i32), aq_cnt=(c["aq_cnt"], (B, A), i32),
        aq_bytes=(c["aq_bytes"], (B, A), i32),
        aq_sz=(c["aq_sz"], (B, A, cfg.aq_len), i32),
        aq_fl=(c["aq_fl"], (B, A, cfg.aq_len), i32),
        aq_at=(c["aq_at"], (B, A, cfg.aq_len), i32),
        c_adm_msgs=(c["c_adm_msgs"], flow, i32),
        c_adm_b_lo=(c["c_adm_b_lo"], flow, i32),
        c_adm_b_hi=(c["c_adm_b_hi"], flow, i32),
        shaping=(args["mode"], (B, 1), i32), arbiter=(args["arb"], (B, 1), i32),
        credits=(args["credits"], (B, 1), i32), ovh=(args["ovh"], (B, 1), f32),
        stall=(stall, (B if stall.shape[0] == B else 1, stall.shape[-1]),
               torch.bool),
        t_idx=(t_idx, (1,), i32))
    s = GrantTickArgs()
    for name, (x, shape, dtype) in shapes.items():
        _check(name, x, shape, dtype, dev, "grant_tick")
        setattr(s, name, x.data_ptr())
    s.n, s.n_accel, s.qlen, s.aq_len = N, A, cfg.qlen, cfg.aq_len
    s.aq_byte_cap, s.k_grant, s.tick_cycles = (cfg.aq_byte_cap, cfg.k_grant,
                                               cfg.tick_cycles)
    # one stall row serves every element: stride 0
    s.stall_stride = stall.shape[-1] if stall.shape[0] == B > 1 else 0
    return s


def grant_tick(cfg, args: dict, c: dict, budget: torch.Tensor,
               t_idx: torch.Tensor) -> None:
    """Stages 1 and 4 of the tick whose index in its window is ``t_idx``
    ([1] int32 on the carry's device) in place on the batched carry ``c``
    (B elements, every leaf [B, ...]) and the [B, 2] float32 link
    ``budget``.

    On a CUDA carry: one launch of ``tb_grant_tick_kernel`` on the current
    stream, one CTA an element (no host sync, no allocation, legal under
    stream capture), or an error; the kernel reads ``t_idx`` and each
    element's ``stall[b, t_idx]`` on the card.  The caller keeps ``t_idx``
    inside the stall mask (the engine checks it once a window).  On a CPU
    carry: ``grant_tick_plain``."""
    dev = c["tb"].tokens.device
    if dev.type == "cpu":
        grant_tick_plain(cfg, args, c, budget, t_idx)
        return
    if dev.type != "cuda":
        raise ValueError(f"grant_tick: unsupported device {dev}")
    N = c["tb"].tokens.shape[-1]
    if not 1 <= N <= MAX_GRANT_FLOWS:
        raise ValueError(f"grant_tick: {N} flows; the kernel holds 1.."
                         f"{MAX_GRANT_FLOWS}")
    global LAUNCHES
    s = _grant_struct(cfg, args, c, budget, t_idx)
    err = _grant_launcher()(ctypes.byref(s), c["tb"].tokens.shape[0],
                            torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"token_bucket grant_tick kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_PATH["grant_tick"] += 1
