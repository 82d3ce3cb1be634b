"""Short first call on the card for a changed decode-attention kernel.

    PYTHONPATH=src python -m repro_torch.kernels.decode_attention.rehearse

Builds the kernel, prints ptxas's registers and spills for each
instantiation, runs each case once against the plain version under a
watchdog (a kernel that deadlocks ends the process after 20 s instead of
holding the card), then times gemma3-12b's three decode shapes: the
wrapper's ms a call (CUDA events over back-to-back calls), the kernel's
device ms a launch (``torch.profiler``; also with the L2 flushed before
each call), the bound and the share of it
reached, and ``scaled_dot_product_attention`` on the same inputs; with
``--plans``, also the device time of other launch plans.  Exits
non-zero on a build failure, a hang or an error past its tolerance.
``chip_smoke.py`` is the full check; this is the rehearsal before it.
"""
from __future__ import annotations

import os
import sys
import time

# B, H, KvH, D, S, window, q dtype, cache dtype, lengths (None: drawn in
# [S // 4, S]): the chip smoke's cases, then the kernel's edges (empty and
# short sequences, windows inside a CTA's share, lengths past S, G = 5 and
# 16, D = 80 and 96, every dtype pair)
CASES = [
    (8, 16, 8, 256, 256, 0, "bfloat16", "float32", (13, 81)),
    (8, 16, 8, 256, 1024, 0, "bfloat16", "float32", (1024, 1025)),
    (8, 16, 8, 256, 2048, 0, "bfloat16", "float32", (1536, 1569)),
    (2, 16, 8, 128, 1024, 0, "float32", "float32", None),
    (1, 8, 1, 64, 512, 0, "float32", "float32", None),
    (3, 12, 2, 80, 777, 0, "float32", "float32", None),
    (2, 16, 8, 128, 2048, 256, "bfloat16", "bfloat16", None),
    (1, 40, 8, 128, 4096, 1024, "float32", "float32", None),
    (2, 16, 16, 96, 300, 0, "bfloat16", "bfloat16", None),
    (1, 24, 2, 128, 640, 128, "float32", "float32", None),
    (4, 8, 2, 64, 64, 0, "float32", "float32", (0, 4)),
    (4, 8, 2, 64, 256, 37, "float32", "bfloat16", (100, 257)),
    (3, 10, 2, 96, 200, 0, "bfloat16", "bfloat16", (150, 400)),
    (2, 32, 2, 80, 300, 0, "float32", "bfloat16", None),
    (2, 5, 1, 256, 130, 0, "bfloat16", "float32", None),
]
TIMED = 3           # the first three: gemma3-12b's decode shapes
HBM_BYTES_PER_S = 3.35e12


def _finish_or_exit(tag: str, limit_s: float = 20.0) -> None:
    """Wait for the card's queue, ending the process if it does not drain
    within ``limit_s`` (a kernel that never finishes)."""
    import torch
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.perf_counter()
    while not ev.query():
        if time.perf_counter() - t0 > limit_s:
            print(f"HANG {tag}", flush=True)
            os._exit(3)
        time.sleep(0.001)


def _time_ms(fn, iters: int = 200) -> float:
    import torch
    for _ in range(5):
        fn()
    _finish_or_exit("warm-up")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    _finish_or_exit("timing")
    return start.elapsed_time(stop) / iters


def device_ms(fn, pattern: str, calls: int = 50, flush=None) -> float:
    """Device time a launch of the kernels whose name holds ``pattern``,
    from ``torch.profiler`` over ``calls`` calls of ``fn``; with ``flush``
    (a tensor larger than the 50 MB L2) zeroed before each call, so that
    ``fn`` finds its inputs in device memory, as between a model's
    layers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and pattern in e.name]
    if not us:
        raise AssertionError(f"the profile shows no kernel named *{pattern}*")
    return sum(us) / len(us) / 1e3


def inputs(case, seed: int, dev):
    """q, k, v and lengths of ``case`` on ``dev``."""
    import numpy as np
    import torch
    B, H, KvH, D, S, _, qn, cn, lrange = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, D), generator=g, device=dev).to(getattr(torch, qn))
    k, v = (torch.randn((B, S, KvH, D), generator=g, device=dev)
            .to(getattr(torch, cn)) for _ in range(2))
    lo, hi = lrange or (max(1, S // 4), S + 1)
    rng = np.random.default_rng(seed)
    ln = torch.as_tensor(rng.integers(lo, hi, B).astype(np.int32), device=dev)
    return q, k, v, ln


def bound_ms(q, k, ln, window: int) -> float:
    """Least time for one call: every valid K and V row, q, the output and
    the lengths moved once at HBM rate (the 4 G flops an element read are
    far below the card's rate)."""
    import torch
    S = k.shape[1]
    lo = (ln - window).clamp_min(0) if window else torch.zeros_like(ln)
    rows = int((torch.clamp(ln, max=S) - lo).clamp_min(0).sum())
    n = (2 * rows * k.shape[2] * k.shape[3] * k.element_size()
         + 2 * q.numel() * q.element_size() + 4 * ln.numel())
    return n / HBM_BYTES_PER_S * 1e3


def _plans(ops, q, k, v, ln, w, gc) -> list:
    """Device ms a launch and occupancy of other clusters and tile rows on
    the same inputs (``--plans``)."""
    import torch
    out = torch.empty_like(q)
    rows = []
    want = ops.decode_attention(q, k, v, ln, window=w)
    for cluster in (2, 3, 4, 5, 6, 8):
        for tile_rows in (4, 8, 16):
            plan = (gc, cluster, tile_rows)
            ms = device_ms(
                lambda: ops._launch(q, k, v, ln, out, None, w, plan),
                "decode_attention_cluster")
            err = float((out.float() - want.float()).abs().max())
            rows.append((plan, round(ms * 1e3, 2),
                         ops.occupancy(q.dtype, k.dtype, plan, q.shape[2]),
                         err))
    return rows


def main() -> int:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops
    if not torch.cuda.is_available():
        print("rehearse: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        ops.build()
    except RuntimeError as e:
        print(f"BUILD FAILED\n{e}", flush=True)
        return 1
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    info = _build.PTXAS_INFO.get(ops.NAME, "").splitlines()
    for i, ln in enumerate(info):
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            regs = next((x.strip() for x in info[i:i + 6]
                         if "registers" in x), "")
            spill = next((x.strip() for x in info[i:i + 6]
                          if "spill" in x), "")
            print(name[:70], "|", spill, "|", regs, flush=True)
    dev = torch.device("cuda", 0)
    worst = 0.0
    for n, case in enumerate(CASES):
        B, H, KvH, D, S, w, qn, cn, _ = case
        q, k, v, ln = inputs(case, n, dev)
        before = ops.LAUNCHES
        got = ops.decode_attention(q, k, v, ln, window=w)
        _finish_or_exit(str(case))
        want = ops.decode_attention_plain(q, k, v, ln, window=w)
        tol = 2e-2 if "bfloat16" in (qn, cn) else 2e-5
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, err / tol)
        row = dict(case=case, plan=ops.launch_plan(
            B, KvH, H // KvH, S, D * k.element_size()), max_abs_err=err,
            tol=tol, launches=ops.LAUNCHES - before)
        if n < TIMED:
            mask = ((torch.arange(S, device=dev)[None, :] < ln[:, None])
                    [:, None, None, :])
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)

            def call():
                return ops.decode_attention(q, k, v, ln, window=w)
            row["ms"] = _time_ms(call)
            row["device_ms"] = device_ms(call, "decode_attention_cluster")
            row["device_ms_l2_flushed"] = device_ms(
                call, "decode_attention_cluster",
                flush=torch.empty(64 * 2**20, device=dev))
            row["bound_ms"] = bound_ms(q, k, ln, w)
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            row["sdpa_ms"] = _time_ms(
                lambda: F.scaled_dot_product_attention(
                    q.to(k.dtype)[:, :, None], kt, vt, attn_mask=mask,
                    enable_gqa=True))
            row["occupancy"] = ops.occupancy(q.dtype, k.dtype, row["plan"],
                                             D)
            # the same bytes read by one torch reduction: what the card's
            # memory gives a plain streaming read
            kv = torch.cat([k.flatten(), v.flatten()])
            row["read_ceiling_share"] = bound_ms(q, k, torch.full_like(
                ln, S), 0) / device_ms(lambda: kv.sum(), "reduce")
            del kv
            if "--plans" in sys.argv:
                row["plans"] = _plans(ops, q, k, v, ln, w, row["plan"][0])
        print(row, flush=True)
    print(f"worst error over its tolerance {worst}", flush=True)
    return 0 if worst < 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
