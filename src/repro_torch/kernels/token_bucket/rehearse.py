"""Short first call on the card for the token-bucket grant-tick kernel.

    PYTHONPATH=src python -m repro_torch.kernels.token_bucket.rehearse

Builds ``csrc/token_bucket.cu``, prints ptxas's registers and spills for
each instantiation, runs ``grant_tick`` against ``grant_tick_plain`` once
on each random valid carry of ``CASES`` (every shaping mode and arbiter,
N in ``GRANT_NS``, ``k_grant`` 1, 4 and 8) and on batches of
``BATCH_SIZES`` elements (``check_batch``: ragged flows with mid-table
holes, mixed modes and arbiters, per-element and shared stall rows) under
a watchdog (a kernel that never finishes ends the process after 20 s
instead of holding the card), then times the kernel at N = 2, 3 and 1025
(``time_grant_tick``) and at each batch size (``time_grant_tick_batch``).  Exits
non-zero on a build failure, a hang or any differing bit.
``chip_smoke.py`` is the full check; this is the rehearsal before it.

``random_grant_inputs`` / ``random_batch_inputs`` make the carries;
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` use them too.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.kernels.token_bucket import ops

GRANT_NS = (1, 2, 3, 33, 1025)
GRANT_K = (1, 4, 8)
SHAPINGS = (ops.SHAPING_NONE, ops.SHAPING_HW, ops.SHAPING_SW)
ARBITERS = (0, 1, 2, 3)          # RR, WRR, PRIORITY, WFQ
#: (n, shaping, arbiter, k_grant): every combination
CASES = list(itertools.product(GRANT_NS, SHAPINGS, ARBITERS, GRANT_K))
TIMED_NS = (2, 3, 1025)
#: the batched kernel's batch sizes (one CTA an element)
BATCH_SIZES = (1, 6, 64)
HBM_BYTES_PER_S = 3.35e12
#: the leaves of the carry the grant tick writes
GRANT_LEAVES = ("sw_pend", "q_head", "q_cnt", "vft", "rr_ptr",
                "credits_used", "aq_cnt", "aq_bytes", "aq_sz", "aq_fl",
                "aq_at", "c_adm_msgs", "c_adm_b_lo", "c_adm_b_hi")


def _element(n: int, rng, *, shaping: int, arbiter: int, k_grant: int,
             n_accel: int, qlen: int, aq_len: int, n_ticks: int) -> dict:
    """One element's random valid tick, as numpy arrays (see
    ``random_grant_inputs``)."""
    aq_byte_cap = aq_len * 2048
    refill = rng.integers(1, 5000, n)
    bkt = rng.integers(512, 1 << 16, n)
    interval = rng.integers(1, 64, n)
    big = rng.random(n) < 0.25
    refill[big], bkt[big], interval[big] = 2**30, 2**30, 1
    tokens = np.minimum(rng.integers(-4096, 1 << 16, n), bkt)
    cyc = rng.integers(0, 64, n) % interval
    credits = 64
    fl_accel = rng.integers(0, n_accel, n)
    el = dict(fl_accel=fl_accel, fl_in_dir=rng.integers(0, 3, n),
              fl_prio=rng.integers(0, 4, n),
              fl_w=np.maximum(rng.integers(1, 8, n) * 0.5, 1e-3),
              stall=rng.random(n_ticks) < 0.4, ovh=100, credits=credits,
              shaping=shaping, arbiter=arbiter)
    aq_cnt = rng.integers(0, aq_len + 1, n_accel)
    aq_cnt[0] = aq_len if n_accel > 1 else aq_cnt[0]   # one full queue
    el.update(
        tb=(tokens, cyc, refill, bkt, interval, rng.integers(0, 2, n)),
        sw_pend=rng.integers(0, 2000, n),
        q_head=rng.integers(0, qlen, n),
        q_cnt=np.where(rng.random(n) < 0.2, 0,
                       rng.integers(1, qlen + 1, n)),
        q_sz=rng.integers(64, 9000, (n, qlen)),
        q_at=rng.integers(0, 1 << 20, (n, qlen)),
        vft=rng.integers(0, 6, n) * 0.25,
        rr_ptr=rng.integers(0, n),
        credits_used=credits - rng.integers(1, 2 * k_grant + 2),
        aq_head=rng.integers(0, aq_len, n_accel),
        aq_cnt=aq_cnt,
        aq_bytes=rng.integers(0, aq_byte_cap, n_accel),
        aq_sz=rng.integers(0, 9000, (n_accel, aq_len)),
        aq_fl=rng.integers(0, n, (n_accel, aq_len)),
        aq_at=rng.integers(0, 1 << 20, (n_accel, aq_len)),
        c_adm_msgs=rng.integers(0, 1000, n),
        c_adm_b_lo=rng.integers(0, 1 << 20, n),
        c_adm_b_hi=rng.integers(0, 100, n),
        budget=rng.integers(-2000, 60000, 2),
        t_idx=rng.integers(0, n_ticks))
    return el


#: an element's per-flow arrays (padded lanes of a ragged batch get random
#: values of their own: the mask, not their contents, keeps them inert)
_FLOW_KEYS = ("fl_accel", "fl_in_dir", "fl_prio", "fl_w", "sw_pend",
              "q_head", "q_cnt", "q_sz", "q_at", "vft", "c_adm_msgs",
              "c_adm_b_lo", "c_adm_b_hi")


def _pad_element(el: dict, n_max: int, rng, qlen: int) -> dict:
    """An element padded to ``n_max`` lanes with random lane contents."""
    n = el["q_cnt"].shape[0]
    if n == n_max:
        return el
    ref = _element(n_max - n, rng, shaping=el["shaping"],
                   arbiter=el["arbiter"], k_grant=1,
                   n_accel=el["aq_cnt"].shape[0], qlen=qlen,
                   aq_len=el["aq_sz"].shape[1], n_ticks=el["stall"].shape[0])
    out = dict(el)
    for k in _FLOW_KEYS:
        out[k] = np.concatenate([el[k], ref[k]])
    out["tb"] = tuple(np.concatenate([a, b]) for a, b in
                      zip(el["tb"], ref["tb"]))
    return out


def random_batch_inputs(ns, seed: int, device, *, shapings, arbiters,
                        k_grant: int, holes=(), n_accel: int = 3,
                        qlen: int = 16, aq_len: int = 32, n_ticks: int = 8,
                        shared_stall: bool = False):
    """A random valid tick of a batch for ``grant_tick``: ``(cfg, args,
    carry, budget, t_idx)`` with the grant's carry leaves only, every leaf
    [B, ...]: element b has ``ns[b]`` flows (padded to ``max(ns)`` with
    random inactive lanes), shaping ``shapings[b]`` and arbiter
    ``arbiters[b]``; each ``(b, lane)`` of ``holes`` is an inactive lane
    in the middle of element b's table.  With ``shared_stall`` every
    element reads element 0's stall row.  Every eligibility test fails for
    some flows (empty queues, short buckets, a full accelerator queue, a
    link in debt, credits running out, stalled ticks), arbiter keys tie
    (coarse virtual finish times and priorities), and a quarter of the
    buckets hold the unshaped profiling registers, whose refill wraps
    int32."""
    from repro_torch.core import token_bucket as tb
    from repro_torch.core.engine import SimConfig
    rng = np.random.default_rng(seed)
    els = [_element(n, rng, shaping=sh, arbiter=ar, k_grant=k_grant,
                    n_accel=n_accel, qlen=qlen, aq_len=aq_len,
                    n_ticks=n_ticks)
           for n, sh, ar in zip(ns, shapings, arbiters)]
    n_max = max(ns)
    pad_rng = np.random.default_rng(seed + 1)
    els = [_pad_element(el, n_max, pad_rng, qlen) for el in els]
    mask = np.arange(n_max)[None, :] < np.asarray(ns)[:, None]
    for b, lane in holes:
        mask[b, lane] = False
    cfg = SimConfig(n_ticks=n_ticks, qlen=qlen, aq_len=aq_len,
                    aq_byte_cap=aq_len * 2048, k_grant=k_grant)
    i32 = lambda k: torch.as_tensor(np.stack(  # noqa: E731
        [np.asarray(e[k]) for e in els]).astype(np.int32), device=device)
    stack = lambda k: np.stack([e[k] for e in els])  # noqa: E731
    stall = stack("stall")
    args = ops.grant_args(
        stack("fl_accel"), stack("fl_in_dir"), stack("fl_prio"),
        stack("fl_w"), mask, ovh=stack("ovh"), credits=stack("credits"),
        shaping=stack("shaping"), arbiter=stack("arbiter"),
        tick_cycles=cfg.tick_cycles,
        stall=stall[:1] if shared_stall else stall, device=device)
    carry = {k: i32(k) for k in (
        "sw_pend", "q_head", "q_cnt", "q_sz", "q_at", "rr_ptr",
        "credits_used", "aq_head", "aq_cnt", "aq_bytes", "aq_sz", "aq_fl",
        "aq_at", "c_adm_msgs", "c_adm_b_lo", "c_adm_b_hi")}
    carry["vft"] = torch.as_tensor(stack("vft").astype(np.float32),
                                   device=device)
    carry["tb"] = tb.TBState(*(
        torch.as_tensor(np.stack([e["tb"][i] for e in els]).astype(
            np.int32), device=device) for i in range(6)))
    budget = torch.as_tensor(stack("budget").astype(np.float32),
                             device=device)
    # one tick index for the batch (the engine's clock is shared)
    t_idx = torch.as_tensor(np.asarray([els[0]["t_idx"]], np.int32),
                            device=device)
    return cfg, args, carry, budget, t_idx


def random_grant_inputs(n: int, seed: int, device, *, shaping: int,
                        arbiter: int, k_grant: int, n_accel: int = 3,
                        qlen: int = 16, aq_len: int = 32, n_ticks: int = 8):
    """A random valid tick of one element (a batch of one, leaves
    [1, ...]): ``random_batch_inputs`` with ``ns = (n,)``."""
    return random_batch_inputs((n,), seed, device, shapings=(shaping,),
                               arbiters=(arbiter,), k_grant=k_grant,
                               n_accel=n_accel, qlen=qlen, aq_len=aq_len,
                               n_ticks=n_ticks)


def copy_inputs(carry: dict, budget: torch.Tensor):
    """Fresh copies of a carry (registers shared) and a budget."""
    c = {k: v.clone() for k, v in carry.items() if k != "tb"}
    c["tb"] = carry["tb"]._replace(tokens=carry["tb"].tokens.clone(),
                                   cyc=carry["tb"].cyc.clone())
    return c, budget.clone()


def _bits(x: torch.Tensor) -> torch.Tensor:
    x = x.detach().to("cpu")
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def differing_leaves(c1: dict, b1, c2: dict, b2) -> list[str]:
    """The names of the grant's leaves (and the budget) whose bits differ
    between two results."""
    pairs = [("tb.tokens", c1["tb"].tokens, c2["tb"].tokens),
             ("tb.cyc", c1["tb"].cyc, c2["tb"].cyc), ("budget", b1, b2)]
    pairs += [(k, c1[k], c2[k]) for k in GRANT_LEAVES]
    return [name for name, x, y in pairs
            if x.shape != y.shape or not torch.equal(_bits(x), _bits(y))]


def grants_made(c_before: dict, c_after: dict) -> int:
    """Messages the tick granted (its admission counters' growth)."""
    return int((c_after["c_adm_msgs"] - c_before["c_adm_msgs"]).sum())


def check_case(case, dev, seed: int | None = None) -> dict:
    """``grant_tick`` on the card against ``grant_tick_plain`` on the same
    inputs; returns the grants made and any differing leaves."""
    n, shaping, arbiter, k = case
    cfg, args, carry, budget, t_idx = random_grant_inputs(
        n, n * 100 + shaping * 10 + arbiter + k * 1000
        if seed is None else seed, dev, shaping=shaping, arbiter=arbiter,
        k_grant=k)
    ck, bk = copy_inputs(carry, budget)
    cp, bp = copy_inputs(carry, budget)
    before = ops.LAUNCHES_BY_PATH["grant_tick"]
    ops.grant_tick(cfg, args, ck, bk, t_idx)
    launched = ops.LAUNCHES_BY_PATH["grant_tick"] - before
    ops.grant_tick_plain(cfg, args, cp, bp, t_idx)
    return dict(case=list(case), launches=launched,
                grants=grants_made(carry, cp),
                differ=differing_leaves(ck, bk, cp, bp))


def _event_ms(fn, calls: int) -> float:
    """Mean ms a call of ``fn`` over ``calls`` back-to-back calls (CUDA
    events, after five warm-up calls)."""
    for _ in range(5):
        fn()
    _finish_or_exit("warm-up")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    _finish_or_exit("timing")
    return start.elapsed_time(stop) / calls


def grant_bound_ms(n: int, n_accel: int, grants: int,
                   k_grant: int) -> tuple[float, str]:
    """Least time of one grant tick, in ms, and what bounds it.  Bytes:
    each flow's state read once (six bucket words, sw_pend, queue head and
    count, vft, weight, priority, int64 accelerator, direction, three
    counters: 72 B) and written once (tokens, cyc, sw_pend, head, count,
    vft, counters: 36 B), its head entry read (8 B), each grant's next
    entry read (8 B) and accelerator-queue entry written (12 B), each
    accelerator's head, count and bytes read (12 B) and count and bytes
    written (8 B), the budgets, credits and RR pointer (24 B), the tick's
    index (4 B) and its stall word.  Operations: about 30 a flow per grant iteration, against the
    67 TFLOP/s rate of the cores outside the tensor cores."""
    n_bytes = n * (72 + 36 + 8) + grants * (8 + 12) + n_accel * 20 + 29
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = 30 * n * max(k_grant, 1) / 67e12
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def grant_launch_us(carry, budget, launch, calls: int = 50,
                    attempts: int = 3) -> list[float]:
    """Device µs of each of ``calls`` grant-tick launches, each ``launch(c,
    b)`` on a fresh copy of ``carry`` and ``budget`` (``torch.profiler``).
    The profiler's trace now and then misses a launch; a trace that does
    not show every launch is taken again, up to ``attempts`` times, and
    raises after the last."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        fresh = [copy_inputs(carry, budget) for _ in range(calls)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for c, b in fresh:
                launch(c, b)
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "tb_grant_tick" in e.name]
        if len(us) == calls:
            return us
    raise AssertionError(f"profile shows {len(us)} grant-tick launches of "
                         f"{calls} in each of {attempts} traces")


def time_grant_tick(n: int, dev, calls: int = 200) -> dict:
    """At ``n`` flows (hardware shaping, RR, ``k_grant`` 4, the first
    random carry whose tick grants four messages): the wrapper's ms a call and the plain version's (CUDA events over back-to-back calls
    on one carry, whose queues and budget drain over the calls), and the
    kernel's device ms a launch (``torch.profiler`` over 50 calls, each on
    a fresh copy of the inputs, so every launch grants as the first did),
    with the bound of that first tick."""
    for seed in range(100):        # the first carry whose tick grants 4
        cfg, args, carry, budget, t_idx = random_grant_inputs(
            n, seed, dev, shaping=ops.SHAPING_HW, arbiter=0, k_grant=4)
        c, b = copy_inputs(carry, budget)
        ops.grant_tick(cfg, args, c, b, t_idx)
        grants = grants_made(carry, c)
        if grants == 4:
            break

    c, b = copy_inputs(carry, budget)
    ms = _event_ms(lambda: ops.grant_tick(cfg, args, c, b, t_idx), calls)
    c, b = copy_inputs(carry, budget)
    plain_ms = _event_ms(
        lambda: ops.grant_tick_plain(cfg, args, c, b, t_idx), calls)
    us = grant_launch_us(
        carry, budget, lambda c, b: ops.grant_tick(cfg, args, c, b, t_idx))
    bound, by = grant_bound_ms(n, carry["aq_cnt"].shape[-1], grants, 4)
    return dict(n=n, k_grant=4, grants=grants, ms=ms, plain_ms=plain_ms,
                device_ms=sum(us) / len(us) / 1e3, bound_ms=bound,
                bound_by=by)


def batch_case(B: int, seed: int = 0, k_grant: int = 4):
    """The batched kernel's inputs at B elements (``random_batch_inputs``):
    ragged flow counts 1..33 (a second warp in some elements), the shaping
    modes and arbiters cycled so that a batch of 12 or more holds every
    pair, a mid-table hole in every other element of three flows or more,
    and at B = 1 software shaping with WFQ and a hole."""
    rng = np.random.default_rng(1000 + B + seed)
    if B == 1:
        ns, sh, ar = [9], [ops.SHAPING_SW], [3]
    else:
        ns = rng.integers(1, 34, B).tolist()
        sh = [SHAPINGS[b % 3] for b in range(B)]
        ar = [ARBITERS[(b // 3) % 4] for b in range(B)]
    holes = [(b, n // 2) for b, n in enumerate(ns) if n >= 3 and b % 2 == 0]
    return dict(ns=ns, shapings=sh, arbiters=ar, holes=holes,
                k_grant=k_grant, seed=seed + B)


def check_batch(B: int, dev, seed: int = 0, shared_stall: bool = False
                ) -> dict:
    """The batched ``grant_tick`` (one launch, B CTAs) on the card against
    ``grant_tick_plain`` on fresh copies of the same inputs; returns the
    grants made and any differing leaves."""
    case = batch_case(B, seed)
    cfg, args, carry, budget, t_idx = random_batch_inputs(
        case["ns"], case["seed"], dev, shapings=case["shapings"],
        arbiters=case["arbiters"], k_grant=case["k_grant"],
        holes=case["holes"], shared_stall=shared_stall)
    ck, bk = copy_inputs(carry, budget)
    cp, bp = copy_inputs(carry, budget)
    before = ops.LAUNCHES_BY_PATH["grant_tick"]
    ops.grant_tick(cfg, args, ck, bk, t_idx)
    launched = ops.LAUNCHES_BY_PATH["grant_tick"] - before
    ops.grant_tick_plain(cfg, args, cp, bp, t_idx)
    granted = (cp["c_adm_msgs"] - carry["c_adm_msgs"]).cpu()
    return dict(batch=B, flows=case["ns"] if B <= 8 else sum(case["ns"]),
                shared_stall=shared_stall, launches=launched,
                grants=int(granted.sum()),
                hole_grants=int(sum(int(granted[b, lane])
                                    for b, lane in case["holes"])),
                differ=differing_leaves(ck, bk, cp, bp))


def time_grant_tick_batch(B: int, dev, calls: int = 50) -> dict:
    """At B elements (``batch_case``): the wrapper's ms a call and the
    plain version's (CUDA events over back-to-back calls on one carry), the
    kernel's device ms a launch (``torch.profiler`` over ``calls``
    launches, each on a fresh copy of the inputs), and the bound of that
    tick: every element's bytes (``grant_bound_ms``) over the card's
    memory rate."""
    case = batch_case(B)
    cfg, args, carry, budget, t_idx = random_batch_inputs(
        case["ns"], case["seed"], dev, shapings=case["shapings"],
        arbiters=case["arbiters"], k_grant=case["k_grant"],
        holes=case["holes"])
    c, b = copy_inputs(carry, budget)
    ops.grant_tick(cfg, args, c, b, t_idx)
    per_el = (c["c_adm_msgs"] - carry["c_adm_msgs"]).sum(1).tolist()
    ms = _event_ms(lambda: ops.grant_tick(cfg, args, c, b, t_idx), 200)
    c, b = copy_inputs(carry, budget)
    plain_ms = _event_ms(
        lambda: ops.grant_tick_plain(cfg, args, c, b, t_idx), 20)
    us = grant_launch_us(
        carry, budget, lambda c, b: ops.grant_tick(cfg, args, c, b, t_idx),
        calls)
    n_accel = carry["aq_cnt"].shape[-1]
    bound = sum(grant_bound_ms(n, n_accel, g, case["k_grant"])[0]
                for n, g in zip(case["ns"], per_el))
    t_ops = sum(30 * n * case["k_grant"] for n in case["ns"]) / 67e12 * 1e3
    return dict(batch=B, flows=sum(case["ns"]), grants=int(sum(per_el)),
                ms=ms, plain_ms=plain_ms,
                device_ms=sum(us) / len(us) / 1e3, bound_ms=bound,
                bound_by="bytes" if bound >= t_ops else "operations")


def _finish_or_exit(tag: str, limit_s: float = 20.0) -> None:
    """Wait for the card's queue, ending the process if it does not drain
    within ``limit_s`` (a kernel that never finishes)."""
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.perf_counter()
    while not ev.query():
        if time.perf_counter() - t0 > limit_s:
            print(f"HANG {tag}", flush=True)
            os._exit(3)
        time.sleep(0.001)


def main() -> int:
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("rehearse: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    ops.build()
    print(json.dumps({"build_s": time.perf_counter() - t0, "ptxas": [
        ln.strip() for ln in _build.PTXAS_INFO.get("token_bucket", "")
        .splitlines() if "registers" in ln or "spill" in ln
        or "Compiling" in ln]}), flush=True)
    bad = 0
    for case in CASES:
        row = check_case(case, dev)
        _finish_or_exit(str(case))
        bad += bool(row["differ"]) or row["launches"] != 1
        if row["differ"] or case[0] in (2, 1025):
            print(json.dumps(row), flush=True)
    print(json.dumps({"cases": len(CASES), "failed": bad}), flush=True)
    for B in BATCH_SIZES:
        for shared in (False, True):
            row = check_batch(B, dev, shared_stall=shared)
            _finish_or_exit(f"batch {B}")
            bad += bool(row["differ"]) or row["launches"] != 1
            print(json.dumps(row), flush=True)
    for n in TIMED_NS:
        print(json.dumps(time_grant_tick(n, dev)), flush=True)
    for B in BATCH_SIZES:
        print(json.dumps(time_grant_tick_batch(B, dev)), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
