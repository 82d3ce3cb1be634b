"""Short first call on the card for the token-bucket grant-tick kernel.

    PYTHONPATH=src python -m repro_torch.kernels.token_bucket.rehearse

Builds ``csrc/token_bucket.cu``, prints ptxas's registers and spills for
each instantiation, runs ``grant_tick`` against ``grant_tick_plain`` once
on each random valid carry of ``CASES`` (every shaping mode and arbiter,
N in ``GRANT_NS``, ``k_grant`` 1, 4 and 8) under a watchdog (a kernel that
never finishes ends the process after 20 s instead of holding the card),
then times the kernel at N = 2, 3 and 1025 (``time_grant_tick``).  Exits
non-zero on a build failure, a hang or any differing bit.
``chip_smoke.py`` is the full check; this is the rehearsal before it.

``random_grant_inputs`` makes the carries; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` use it too.
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
HBM_BYTES_PER_S = 3.35e12
#: the leaves of the carry the grant tick writes
GRANT_LEAVES = ("sw_pend", "q_head", "q_cnt", "vft", "rr_ptr",
                "credits_used", "aq_cnt", "aq_bytes", "aq_sz", "aq_fl",
                "aq_at", "c_adm_msgs", "c_adm_b_lo", "c_adm_b_hi")


def random_grant_inputs(n: int, seed: int, device, *, shaping: int,
                        arbiter: int, k_grant: int, n_accel: int = 3,
                        qlen: int = 16, aq_len: int = 32, n_ticks: int = 8):
    """A random valid tick for ``grant_tick``: ``(cfg, args, carry, budget,
    t_idx)`` with the grant's carry leaves only, ``t_idx`` the tick's index
    in its window ([1] int32 on ``device``).  Every eligibility test
    fails for some flows (empty queues, short buckets, a full accelerator
    queue, a link in debt, credits running out, stalled ticks), arbiter
    keys tie (coarse virtual finish times and priorities), and a quarter
    of the buckets hold the unshaped profiling registers, whose refill
    wraps int32."""
    from repro_torch.core import token_bucket as tb
    from repro_torch.core.engine import SimConfig
    rng = np.random.default_rng(seed)
    cfg = SimConfig(n_ticks=n_ticks, qlen=qlen, aq_len=aq_len,
                    aq_byte_cap=aq_len * 2048, k_grant=k_grant,
                    shaping=shaping, arbiter=arbiter)
    i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=device)  # noqa: E731
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    refill = rng.integers(1, 5000, n)
    bkt = rng.integers(512, 1 << 16, n)
    interval = rng.integers(1, 64, n)
    big = rng.random(n) < 0.25
    refill[big], bkt[big], interval[big] = 2**30, 2**30, 1
    tokens = np.minimum(rng.integers(-4096, 1 << 16, n), bkt)
    cyc = rng.integers(0, 64, n) % interval
    credits = 64
    fl_accel = rng.integers(0, n_accel, n)
    args = ops.grant_args(
        fl_accel, rng.integers(0, 3, n), rng.integers(0, 4, n),
        np.maximum(rng.integers(1, 8, n) * 0.5, 1e-3), ovh=100,
        credits=credits, tick_cycles=cfg.tick_cycles,
        stall=rng.random(n_ticks) < 0.4, device=device)
    aq_cnt = rng.integers(0, aq_len + 1, n_accel)
    aq_cnt[0] = aq_len if n_accel > 1 else aq_cnt[0]   # one full queue
    carry = dict(
        tb=tb.TBState(i32(tokens), i32(cyc), i32(refill), i32(bkt),
                      i32(interval), i32(rng.integers(0, 2, n))),
        sw_pend=i32(rng.integers(0, 2000, n)),
        q_head=i32(rng.integers(0, qlen, n)),
        q_cnt=i32(np.where(rng.random(n) < 0.2, 0,
                           rng.integers(1, qlen + 1, n))),
        q_sz=i32(rng.integers(64, 9000, (n, qlen))),
        q_at=i32(rng.integers(0, 1 << 20, (n, qlen))),
        vft=f32(rng.integers(0, 6, n) * 0.25),
        rr_ptr=i32(rng.integers(0, n)),
        credits_used=i32(credits - rng.integers(1, 2 * k_grant + 2)),
        aq_head=i32(rng.integers(0, aq_len, n_accel)),
        aq_cnt=i32(aq_cnt),
        aq_bytes=i32(rng.integers(0, cfg.aq_byte_cap, n_accel)),
        aq_sz=i32(rng.integers(0, 9000, (n_accel, aq_len))),
        aq_fl=i32(rng.integers(0, n, (n_accel, aq_len))),
        aq_at=i32(rng.integers(0, 1 << 20, (n_accel, aq_len))),
        c_adm_msgs=i32(rng.integers(0, 1000, n)),
        c_adm_b_lo=i32(rng.integers(0, 1 << 20, n)),
        c_adm_b_hi=i32(rng.integers(0, 100, n)))
    budget = f32(rng.integers(-2000, 60000, 2))
    t_idx = i32([rng.integers(0, n_ticks)])
    return cfg, args, carry, budget, t_idx


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


def time_grant_tick(n: int, dev, calls: int = 200) -> dict:
    """At ``n`` flows (hardware shaping, RR, ``k_grant`` 4, the first
    random carry whose tick grants four messages): the wrapper's ms a call and the plain version's (CUDA events over back-to-back calls
    on one carry, whose queues and budget drain over the calls), and the
    kernel's device ms a launch (``torch.profiler`` over 50 calls, each on
    a fresh copy of the inputs, so every launch grants as the first did),
    with the bound of that first tick."""
    from torch.profiler import ProfilerActivity, profile
    for seed in range(100):        # the first carry whose tick grants 4
        cfg, args, carry, budget, t_idx = random_grant_inputs(
            n, seed, dev, shaping=ops.SHAPING_HW, arbiter=0, k_grant=4)
        c, b = copy_inputs(carry, budget)
        ops.grant_tick(cfg, args, c, b, t_idx)
        grants = grants_made(carry, c)
        if grants == 4:
            break

    def event_ms(fn) -> float:
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
    c, b = copy_inputs(carry, budget)
    ms = event_ms(lambda: ops.grant_tick(cfg, args, c, b, t_idx))
    c, b = copy_inputs(carry, budget)
    plain_ms = event_ms(lambda: ops.grant_tick_plain(cfg, args, c, b, t_idx))
    fresh = [copy_inputs(carry, budget) for _ in range(50)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c, b in fresh:
            ops.grant_tick(cfg, args, c, b, t_idx)
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "tb_grant_tick" in e.name]
    if len(us) != len(fresh):
        raise AssertionError(f"profile shows {len(us)} grant-tick launches "
                             f"of {len(fresh)}")
    bound, by = grant_bound_ms(n, carry["aq_cnt"].shape[0], grants, 4)
    return dict(n=n, k_grant=4, grants=grants, ms=ms, plain_ms=plain_ms,
                device_ms=sum(us) / len(us) / 1e3, bound_ms=bound,
                bound_by=by)


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
    for n in TIMED_NS:
        print(json.dumps(time_grant_tick(n, dev)), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
