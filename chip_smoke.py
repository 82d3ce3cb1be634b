#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (one ``nvcc`` each, all
at once), holds each against its plain PyTorch version on the card, and
drives the port's paths through the kernels:

  * the batched dataplane (``run_window_batch`` -> ``simulate_batch`` ->
    ``run_system_batch`` / ``profile_contexts``, one grant-tick launch a
    tick with one CTA an element): the batched kernel against its plain
    version at B = 1, 6 and 64; a ragged mixed-mode batch of four
    (``batch_parity``) CUDA against CPU, graph against eager body, and each
    element against its serial run; Fig. 6 / Table 3's six elements
    (three systems, two load points) as one ``run_system_batch`` of 60,000
    ticks held against a digest of the JAX reference's run
    (``fig6_batch``); sim_perf's eight heterogeneous profiler contexts
    against eight serial ``profile_context`` calls (``profile_batch8``);
  * the dataplane (the quickstart server: ``ArcusRuntime`` admission +
    ``run_managed``, Algorithm 1), one token-bucket grant-tick launch a
    simulated tick, every window a replay of its compile-cache entry's
    CUDA graph of one tick (``cache_info()`` steady across the managed
    windows; the eager body's µs a tick beside it), with CUDA windows
    (hardware shaping with round robin, software shaping with WFQ) checked
    bitwise against the same windows on the CPU, and graph windows (those
    two, and a resumed one with a register write) bitwise against the
    eager body on the card (``graph_parity``);
  * serving (``ServingEngine`` + ``ArcusScheduler``, every decode step a
    replay of the engine's CUDA graph, held against its eager body in
    ``graph_parity``) of gemma3-12b at full width and depth with random
    weights: the launcher's request mix, a
    long-prompt mix that crosses the 1024-token window, and, at one period
    of depth (6 layers), both mixes through the kernels against the same
    mixes through the plain versions;
  * the same serving of mamba2-780m (48 ``ssd`` layers, every prefill
    through the SSD-scan kernel) at full width and depth: the launcher's
    mix, four 2000-token prompts, and, at 4 layers, both mixes through the
    kernel against the plain scan (each call's logits against the plain
    versions on a copy of the same cache: a recurrent state carries any
    rounding difference forward, so two independent runs drift apart).

Flash prefill and the SSD scan have two kernels each, chosen by operand
type: bf16 (what the models pass) on the tensor cores, float32 on the CUDA
cores; their phases check each call's path, and the serving phases check
that every flash-prefill and SSD-scan launch took the tensor-core path.

Cuts against earlier versions of this script: none; the mamba2 paths run
more scheduler rounds than the launcher's 2000 (MAMBA_ROUNDS) so that
their mixes reach 3 s of virtual time.  ``fig6_batch`` runs fig6's quick
tick count (60,000; the benchmark's full run is 400,000).

Each phase prints one JSON line; any failure raises and the script exits
non-zero.  The last three lines are the kernel table, the card's
``nvidia-smi`` name and power limit, and the ``ok`` line.

Imports torch and the port only.  Without a CUDA device, or run from a
directory that holds nothing else of the repository, it fails without
printing a result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# main-path cuts (the quickstart runs ProfileTable(n_ticks=60_000) and
# run_managed(total_ticks=120_000, window_ticks=30_000)); cut further than
# in the first slice (4_000 and 8_000 / 2_000) to leave time for serving
PROFILE_TICKS = 2_000
TOTAL_TICKS = 6_000
WINDOW_TICKS = 2_000
PARITY_TICKS = 2_000
PROFILE_WINDOW = 100
# eager windows beside the graph's (``engine._run_window_eager``, about
# 9 ms a tick): the main path's comparison window and graph_parity's
EAGER_TICKS = 300
GRAPH_PARITY_TICKS = 500
# graph_parity's serving decode: steps after three prompts
DECODE_PARITY_STEPS = 8

# H100 SXM peaks (NVIDIA data sheet, dense): 3.35 TB/s of HBM; the table
# has no int32 entry, so integer work is held against the 67 TFLOP/s
# float32 rate of the cores outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# attention products: bf16 operands at the tensor cores' dense bf16 peak,
# float32 operands at the float32 rate outside the tensor cores
PEAK_FLOPS = {"bfloat16": 989.4e12, "float32": 67e12}

# serving: gemma3-12b at full width (48 layers, d_model 3840, vocab 262144)
SERVE_ARCH = "gemma3-12b"
SERVE_SEED = 0
LONG_PROMPT, LONG_NEW, LONG_REQUESTS = 1536, 32, 4
PARITY_LAYERS = 6          # one period: 5 local layers and 1 global
# serving: mamba2-780m at full width (48 ssd layers, d_model 1536, vocab
# 50280); 2000 is a multiple of no power of two above 16, so the scan's last
# chunk is ragged
MAMBA_ARCH = "mamba2-780m"
MAMBA_LONG_PROMPT = 2000
MAMBA_PARITY_LAYERS = 4
# the launcher runs 3 s of virtual time in at most 2000 rounds; an idle round
# advances 0.1 ms and a mamba2 step far less than a gemma3 one, so its mixes
# take about 29,000 rounds to reach 3 s (every request done by then)
MAMBA_ROUNDS = 40_000
# kernel vs plain logits in bf16: about one bf16 ulp of their scale
LOGIT_RTOL, LOGIT_ATOL = 1e-2, 0.0625


T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line for ``phase``, with the seconds since the start."""
    print(json.dumps({"phase": phase, **kw,
                      "at_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


def cuda_time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms_per_launch(fn, kind: str, calls: int = 50) -> float:
    """Device time of one launch of ``kind``'s kernels (KERNEL_KINDS), from
    ``torch.profiler`` over ``calls`` calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and any(p in e.name for p in KERNEL_KINDS[kind])]
    if not us:
        raise AssertionError(f"the profile shows no {kind} kernel")
    return sum(us) / len(us) / 1e3


def auto_time_ms(fn, budget_s: float = 0.2, max_iters: int = 200) -> float:
    """``cuda_time_ms`` with as many calls as fit in about ``budget_s``."""
    once = cuda_time_ms(fn, 3)
    return cuda_time_ms(fn, max(3, min(max_iters,
                                       int(budget_s * 1e3 / max(once,
                                                                1e-3)))))


def tb_inputs(n: int, seed: int, dev):
    """Random bucket registers with the edge cases of the CPU tests: the
    unshaped profiling registers (refill = bkt = 2^30, interval 1, which
    overflow int32 on refill), intervals of 1, IOPS and GBPS modes."""
    import numpy as np
    import torch
    from repro_torch.core import token_bucket as tb
    rng = np.random.default_rng(seed)
    refill = rng.integers(1, 5000, n).astype(np.int32)
    bkt = rng.integers(512, 1 << 20, n).astype(np.int32)
    interval = rng.integers(1, 1024, n).astype(np.int32)
    mode = rng.integers(0, 2, n).astype(np.int32)
    big = rng.random(n) < 0.25
    refill[big], bkt[big], interval[big] = 2**30, 2**30, 1
    tokens = np.where(big, 2**30, rng.integers(-(1 << 20), 1 << 20, n)
                      ).astype(np.int32)
    cyc = (rng.integers(0, 1024, n) % interval).astype(np.int32)
    st = tb.TBState(*(torch.as_tensor(x, device=dev) for x in
                      (tokens, cyc, refill, bkt, interval, mode)))
    cost = torch.as_tensor(rng.integers(1, 8192, n).astype(np.int32),
                           device=dev)
    want = torch.as_tensor(rng.random(n) < 0.8, device=dev)
    return st, cost, want


def tb_bound(n: int, per_flow_e: bool, admit: bool) -> tuple[float, str]:
    """Least time for one call, in ms, and what bounds it: every input read
    once and every output written once at HBM rate, against ~16 integer
    operations a flow."""
    read = 6 * 4 * n + (4 * n if per_flow_e else 4)
    read += (4 * n + n) if admit else 0
    written = 8 * n + (n if admit else 0)
    t_bytes = (read + written) / HBM_BYTES_PER_S
    t_ops = 16 * n / SCALAR_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernel(dev) -> dict:
    """CUDA token-bucket kernel vs its plain version, bitwise, both with
    fresh outputs and in place (outputs aliased to the inputs, as the
    engine calls it); times."""
    import torch
    from repro_torch.kernels.token_bucket import ops
    worst = 0
    for n in (1, 2, 3, 1000, 1025, 1 << 16, 1 << 20):
        st, cost, want = tb_inputs(n, n, dev)
        e_flow = torch.randint(0, 10**7, (n,), dtype=torch.int32, device=dev)
        for elapsed in (0, 8, 10**7, e_flow):
            for c, w in ((None, None), (cost, want)):
                ref, adm_r = ops.token_bucket_step_plain(st, elapsed, c, w)
                got, adm = ops.token_bucket_step(st, elapsed, c, w)
                own = st._replace(tokens=st.tokens.clone(),
                                  cyc=st.cyc.clone())
                inp, adm_i = ops.token_bucket_step(
                    own, elapsed, c, w, out=(own.tokens, own.cyc))
                torch.cuda.synchronize()
                pairs = [(got.tokens, ref.tokens), (got.cyc, ref.cyc),
                         (inp.tokens, ref.tokens), (inp.cyc, ref.cyc)]
                if w is not None:
                    pairs += [(adm, adm_r), (adm_i, adm_r)]
                for x, y in pairs:
                    bad = int((x != y).sum())
                    worst = max(worst, int((x.long() - y.long()).abs().max()))
                    if bad:
                        raise AssertionError(
                            f"token_bucket kernel != plain at n={n}: {bad}")
    times = {}
    for n in (2, 3, 1 << 20):
        st, cost, want = tb_inputs(n, 7, dev)
        e0 = torch.zeros(1, dtype=torch.int32, device=dev)
        iters = 2000 if n < 1024 else 200
        bound_ms, bound_by = tb_bound(n, False, True)
        times[n] = dict(
            ms=cuda_time_ms(lambda: ops.token_bucket_step(
                st, e0, cost, want), iters),
            plain_ms=cuda_time_ms(lambda: ops.token_bucket_step_plain(
                st, e0, cost, want), iters),
            bound_ms=bound_ms, bound_by=bound_by)
    emit("kernel", name="token_bucket", bitwise=True, max_abs_err=worst,
         times={str(k): v for k, v in times.items()})
    return dict(max_abs_err=worst, times=times)


def phase_kernel_grant_tick(dev) -> dict:
    """The token bucket's grant-tick kernel (one launch: every flow's
    refill, then k_grant shaper + arbiter grants) against its plain version
    on random valid carries, bitwise on every leaf it writes: N = 1, 2, 3,
    33 and 1025 flows, every shaping mode and arbiter, k_grant 1, 4 and 8
    (``rehearse.CASES``); then its times at N = 2, 3 and 1025 (ms a call,
    device ms a launch, plain ms, bound)."""
    from repro_torch.kernels.token_bucket import rehearse
    grants = 0
    for case in rehearse.CASES:
        row = rehearse.check_case(case, dev)
        if row["launches"] != 1 or row["differ"]:
            raise AssertionError(f"grant_tick kernel != plain: {row}")
        grants += row["grants"]
    times = {n: rehearse.time_grant_tick(n, dev) for n in rehearse.TIMED_NS}
    emit("kernel_grant_tick", name="token_bucket/grant_tick", bitwise=True,
         cases=len(rehearse.CASES), grants=grants,
         times={str(k): v for k, v in times.items()})
    return dict(max_abs_err=0, times=times)


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------


def attn_bound(n_bytes: float, flops: float, dtype_name: str
               ) -> tuple[float, str]:
    """Least time in ms: bytes at HBM rate against the products' flops at
    the peak rate of their operands' type; and which of the two bounds."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# B, H, KvH, D, S, window, q dtype, cache dtype, lengths: the cases of
# tests/test_kernels.py:43-51 (lengths drawn there), then gemma3-12b's
# decode: a float32 cache under bf16 activations, at the serve mix's cache
# (S = 256, lengths 13..80), the long mix's local and global caches
# (S = 1024 full; S = 2048, lengths 1536..1568)
DA_CASES = [
    (2, 16, 8, 128, 1024, 0, "float32", "float32", None),
    (1, 8, 1, 64, 512, 0, "float32", "float32", None),
    (3, 12, 2, 80, 777, 0, "float32", "float32", None),
    (2, 16, 8, 128, 2048, 256, "bfloat16", "bfloat16", None),
    (1, 40, 8, 128, 4096, 1024, "float32", "float32", None),
    (2, 16, 16, 96, 300, 0, "bfloat16", "bfloat16", None),
    (1, 24, 2, 128, 640, 128, "float32", "float32", None),
    (8, 16, 8, 256, 256, 0, "bfloat16", "float32", (13, 81)),
    (8, 16, 8, 256, 1024, 0, "bfloat16", "float32", (1024, 1025)),
    (8, 16, 8, 256, 2048, 0, "bfloat16", "float32", (1536, 1569)),
]
DA_MAIN = 7                 # the serve mix's shape: the table's row (then
                            # the long mix's two caches)


def phase_kernel_decode_attention(dev) -> dict:
    """CUDA decode attention vs its plain version on the card (2e-5 for
    float32, 2e-2 where bf16 is involved, as the JAX tests), then times of
    the kernel, the plain version and SDPA at gemma3-12b's shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops
    rows = []
    for i, (B, H, KvH, D, S, w, qn, cn, lrange) in enumerate(DA_CASES):
        qdt, cdt = getattr(torch, qn), getattr(torch, cn)
        g = torch.Generator(device=dev).manual_seed(100 + i)
        q = torch.randn((B, H, D), generator=g, device=dev).to(qdt)
        k = torch.randn((B, S, KvH, D), generator=g, device=dev).to(cdt)
        v = torch.randn((B, S, KvH, D), generator=g, device=dev).to(cdt)
        rng = np.random.default_rng(i)
        lo, hi = lrange or (max(1, S // 4), S + 1)
        ln = torch.as_tensor(rng.integers(lo, hi, B).astype(np.int32),
                             device=dev)
        got = ops.decode_attention(q, k, v, ln, window=w)
        want = ops.decode_attention_plain(q, k, v, ln, window=w)
        torch.cuda.synchronize()
        tol = 2e-2 if "bfloat16" in (qn, cn) else 2e-5
        err = _max_err(got, want)
        row = dict(shape=[B, H, KvH, D, S], window=w, q=qn, cache=cn,
                   max_abs_err=err, tol=tol)
        if not err < tol:
            emit("kernel_decode_attention", failed=row)
            raise AssertionError(f"decode_attention kernel != plain: {row}")
        if lrange is not None:
            lo_pos = (ln - w).clamp_min(0) if w else torch.zeros_like(ln)
            valid = (torch.minimum(ln, torch.tensor(S, device=dev))
                     - lo_pos).sum().item()
            n_bytes = (2 * valid * KvH * D * k.element_size()
                       + 2 * q.numel() * q.element_size() + 4 * B)
            flops = 4 * valid * H * D
            row["bound_ms"], row["bound_by"] = attn_bound(n_bytes, flops,
                                                          "float32")
            idx = torch.arange(S, device=dev)
            mask = ((idx[None, :] < ln[:, None])
                    & (idx[None, :] >= ln[:, None] - (w or S + 1)))
            mask = mask[:, None, None, :]
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)

            def lib():
                return F.scaled_dot_product_attention(
                    q.to(cdt)[:, :, None], kt, vt, attn_mask=mask,
                    enable_gqa=True)
            lib_err = _max_err(lib()[:, :, 0], want)
            if not lib_err < tol:
                raise AssertionError(f"SDPA yardstick != plain: {lib_err}")
            def call():
                return ops.decode_attention(q, k, v, ln, window=w)
            row["ms"] = auto_time_ms(call)
            row["device_ms"] = device_ms_per_launch(call, "decode_attention")
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            row["plain_ms"] = auto_time_ms(
                lambda: ops.decode_attention_plain(q, k, v, ln, window=w))
            row["library_ms"] = auto_time_ms(lib)
            row["lengths"] = ln.tolist()
            row["plan"] = ops.launch_plan(B, KvH, H // KvH, S,
                                          D * k.element_size())
        rows.append(row)
    emit("kernel_decode_attention", cases=rows,
         worst_err_over_tol=max(r["max_abs_err"] / r["tol"] for r in rows))
    return dict(rows=rows, main=rows[DA_MAIN], long=rows[DA_MAIN + 1:],
                max_abs_err=max(r["max_abs_err"] for r in rows))


# B, S, H, KvH, D, window, chunk, dtype: the cases of
# tests/test_flash_prefill_kernel.py:10-17, then gemma3-12b's prefill in
# bf16: the serve mix's prompts (12 and 64 tokens) and the long mix's
# (1536), each through a local layer (window 1024) and a global one
FP_CASES = [
    (2, 128, 4, 2, 64, 0, 0, "float32"),
    (1, 256, 8, 8, 128, 0, 0, "float32"),
    (1, 200, 4, 1, 80, 0, 0, "float32"),
    (2, 256, 4, 2, 64, 64, 0, "float32"),
    (1, 256, 4, 2, 64, 0, 64, "float32"),
    (1, 256, 8, 4, 128, 128, 0, "bfloat16"),
    (1, 12, 16, 8, 256, 1024, 0, "bfloat16"),
    (1, 64, 16, 8, 256, 1024, 0, "bfloat16"),
    (1, 64, 16, 8, 256, 0, 0, "bfloat16"),
    (1, 1536, 16, 8, 256, 1024, 0, "bfloat16"),
    (1, 1536, 16, 8, 256, 0, 0, "bfloat16"),
]
FP_FIRST_TIMED = 6
FP_MAIN = 7                 # the serve mix's background prompt: the table's
FP_LONG = 9                 # the long mix's prompt (local, then global)


def _prefill_mask(S: int, w: int, ck: int, dev):
    import torch
    qi = torch.arange(S, device=dev)[:, None]
    ki = torch.arange(S, device=dev)[None, :]
    mask = qi >= ki
    if w:
        mask &= qi - ki < w
    if ck:
        mask &= (qi // ck) == (ki // ck)
    return mask


def phase_kernel_flash_prefill(dev) -> dict:
    """CUDA flash prefill vs its plain version on the card (2e-5 for
    float32, 2e-2 for bf16; bf16 operands go to the tensor-core kernel,
    float32 ones to the CUDA-core kernel), then times of the kernel, the
    plain version and SDPA at gemma3-12b's shapes: SDPA with the explicit
    mask (``library_ms``) and, where the mask is the plain causal one, SDPA
    with ``is_causal`` (its flash backend, ``library_causal_ms``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import ops
    rows = []
    for i, (B, S, H, KvH, D, w, ck, dn) in enumerate(FP_CASES):
        dt = getattr(torch, dn)
        g = torch.Generator(device=dev).manual_seed(200 + i)
        q = torch.randn((B, S, H, D), generator=g, device=dev).to(dt)
        k = torch.randn((B, S, KvH, D), generator=g, device=dev).to(dt)
        v = torch.randn((B, S, KvH, D), generator=g, device=dev).to(dt)
        path = ops.kernel_path(q.dtype, k.dtype)
        by_path = dict(ops.LAUNCHES_BY_PATH)
        got = ops.flash_prefill(q, k, v, window=w, chunk_size=ck)
        by_path[path] += 1
        if ops.LAUNCHES_BY_PATH != by_path:
            raise AssertionError(f"flash_prefill: {dn} call not on the "
                                 f"{path} path: {ops.LAUNCHES_BY_PATH}")
        want = ops.flash_prefill_plain(q, k, v, window=w, chunk_size=ck)
        torch.cuda.synchronize()
        tol = 2e-2 if dn == "bfloat16" else 2e-5
        err = _max_err(got, want)
        row = dict(shape=[B, S, H, KvH, D], window=w, chunk=ck, dtype=dn,
                   path=path, max_abs_err=err, tol=tol)
        if not err < tol:
            emit("kernel_flash_prefill", failed=row)
            raise AssertionError(f"flash_prefill kernel != plain: {row}")
        if i >= FP_FIRST_TIMED:
            mask = _prefill_mask(S, w, ck, dev)
            pairs = int(mask.sum())
            # q, k, v read once and the output (q's size) written once
            n_bytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            flops = 4 * B * H * D * pairs
            row["reachable_pairs"] = pairs
            row["bound_ms"], row["bound_by"] = attn_bound(n_bytes, flops, dn)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
            lib_err = _max_err(lib().transpose(1, 2), want)
            if not lib_err < tol:
                raise AssertionError(f"SDPA yardstick != plain: {lib_err}")
            row["ms"] = auto_time_ms(
                lambda: ops.flash_prefill(q, k, v, window=w, chunk_size=ck))
            row["plain_ms"] = auto_time_ms(
                lambda: ops.flash_prefill_plain(q, k, v, window=w,
                                                chunk_size=ck))
            row["library_ms"] = auto_time_ms(lib)
            row["library_causal_ms"] = None
            if not ck and (not w or S <= w):

                def lib_causal():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True)
                lib_err = _max_err(lib_causal().transpose(1, 2), want)
                if not lib_err < tol:
                    raise AssertionError(f"SDPA is_causal yardstick != "
                                         f"plain: {lib_err}")
                row["library_causal_ms"] = auto_time_ms(lib_causal)
            row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
            row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
    emit("kernel_flash_prefill", cases=rows,
         worst_err_over_tol=max(r["max_abs_err"] / r["tol"] for r in rows))
    return dict(rows=rows, main=rows[FP_MAIN], long=rows[FP_LONG:],
                max_abs_err=max(r["max_abs_err"] for r in rows))


# Bsz, L, H, P, G, N, dtype: the cases of tests/test_kernels.py:88-94, then
# mamba2-780m's prefills in bf16: the serve mix's prompts (12 and 64 tokens)
# and the long mix's (2000), then bf16 at Bsz = 2 and at G = 2 with N = 256
SSD_CASES = [
    (2, 256, 4, 64, 1, 128, "float32"),
    (1, 100, 3, 32, 1, 64, "float32"),
    (2, 128, 8, 64, 2, 128, "float32"),
    (1, 512, 4, 64, 1, 128, "bfloat16"),
    (1, 12, 48, 64, 1, 128, "bfloat16"),
    (1, 64, 48, 64, 1, 128, "bfloat16"),
    (1, MAMBA_LONG_PROMPT, 48, 64, 1, 128, "bfloat16"),
    (2, 300, 8, 64, 1, 128, "bfloat16"),
    (1, 300, 8, 64, 2, 256, "bfloat16"),
]
SSD_TIMED = (4, 5, 6)       # mamba2's 12-, 64- and 2000-token prefills
SSD_MAIN = 6                # the long mix's prefill: the table's row
SSD_REF_CHUNK = 128         # the reference kernel's chunk (ops.py:18)
# the tensor-core kernel against its chunked mirror (ref.ssd_scan_chunked,
# the same rounding points): float32 summation order and the bf16 roundings
# it flips, a few bf16 ulps of the output's max-abs
SSD_MIRROR_TOL = 2e-2


def ssd_bound(Bz: int, L: int, H: int, P: int, G: int, N: int,
              dtype_name: str) -> tuple[float, str]:
    """Least time in ms of one scan, in ``attn_bound``'s convention: x, a,
    B, C read once, y and the final state written once, against the
    products of the chunked form at the reference's chunk of SSD_REF_CHUNK
    tokens: C B^T once per (batch, group, chunk), and for each token and
    head M x over the chunk, C S^T and the state update, at the peak rate
    of the operands' type."""
    isz = 2 if dtype_name == "bfloat16" else 4
    n_bytes = (2 * Bz * L * H * P * isz + 4 * Bz * L * H
               + 2 * Bz * L * G * N * isz + 4 * Bz * H * P * N)
    flops = 2 * Bz * L * (H * (SSD_REF_CHUNK * P + 2 * N * P)
                          + G * SSD_REF_CHUNK * N)
    return attn_bound(n_bytes, flops, dtype_name)


def phase_kernel_ssd_scan(dev) -> dict:
    """CUDA SSD scan vs its plain (sequential) version on the card: max-abs
    error over the output's max-abs, on y and the final state, within the
    JAX test's limits (2e-3 float32, 1e-1 bf16); bf16 operands go to the
    tensor-core kernel (also held against its chunked mirror within
    SSD_MIRROR_TOL), float32 ones to the CUDA-core kernel, checked per call
    through ``ops.LAUNCHES_BY_PATH``.  Then, at mamba2-780m's shapes, times
    of the kernel, of the CUDA-core kernel on the same bf16 inputs through
    the same wrapper (``cuda_core_ms``), of the plain version, and the
    bound."""
    import torch
    from repro_torch.kernels.ssd_scan import ops, ref
    rows = []
    for i, (Bz, L, H, P, G, N, dn) in enumerate(SSD_CASES):
        dt = getattr(torch, dn)
        g = torch.Generator(device=dev).manual_seed(300 + i)
        x = (0.5 * torch.randn((Bz, L, H, P), generator=g, device=dev)
             ).to(dt)
        a = 0.7 + 0.299 * torch.rand((Bz, L, H), generator=g, device=dev)
        B = (0.3 * torch.randn((Bz, L, G, N), generator=g, device=dev)
             ).to(dt)
        C = (0.3 * torch.randn((Bz, L, G, N), generator=g, device=dev)
             ).to(dt)
        path = ops.kernel_path(x.dtype, B.dtype)
        by_path = dict(ops.LAUNCHES_BY_PATH)
        y, st = ops.ssd_scan(x, a, B, C)
        by_path[path] += 1
        if ops.LAUNCHES_BY_PATH != by_path:
            raise AssertionError(f"ssd_scan: {dn} call not on the {path} "
                                 f"path: {ops.LAUNCHES_BY_PATH}")
        yr, sr = ops.ssd_scan_plain(x, a, B, C)
        torch.cuda.synchronize()
        tol = 1e-1 if dn == "bfloat16" else 2e-3
        rel = [float((u.float() - w.float()).abs().max()
                     / (w.float().abs().max() + 1e-9))
               for u, w in ((y, yr), (st, sr))]
        row = dict(shape=[Bz, L, H, P, G, N], dtype=dn, path=path,
                   rel_err_y=rel[0], rel_err_state=rel[1], tol=tol,
                   max_abs_err=max(_max_err(y, yr), _max_err(st, sr)))
        ok = max(rel) < tol and bool(torch.isfinite(y.float()).all())
        if path == "tensor_core":
            ym, sm = ref.ssd_scan_chunked(x, a, B, C)
            row["mirror_rel_err"] = [
                float((u.float() - w.float()).abs().max()
                      / (w.float().abs().max() + 1e-9))
                for u, w in ((y, ym), (st, sm))]
            row["mirror_tol"] = SSD_MIRROR_TOL
            ok = ok and max(row["mirror_rel_err"]) < SSD_MIRROR_TOL
        if not ok:
            emit("kernel_ssd_scan", failed=row)
            raise AssertionError(f"ssd_scan kernel != plain: {row}")
        if i in SSD_TIMED:
            row["bound_ms"], row["bound_by"] = ssd_bound(Bz, L, H, P, G, N,
                                                         dn)
            row["ms"] = auto_time_ms(lambda: ops.ssd_scan(x, a, B, C))
            # the CUDA-core kernel on the same bf16 inputs, through the
            # same wrapper, in the same run: the time this PR replaces
            kernel_path = ops.kernel_path
            ops.kernel_path = lambda *_: "cuda_core"
            try:
                row["cuda_core_ms"] = auto_time_ms(
                    lambda: ops.ssd_scan(x, a, B, C))
            finally:
                ops.kernel_path = kernel_path
            row["plain_ms"] = auto_time_ms(
                lambda: ops.ssd_scan_plain(x, a, B, C), budget_s=0.5,
                max_iters=5)
            row["library_ms"] = None    # no single PyTorch call scans
            row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
    emit("kernel_ssd_scan", cases=rows,
         worst_err_over_tol=max(max(r["rel_err_y"], r["rel_err_state"])
                                / r["tol"] for r in rows))
    return dict(rows=rows, main=rows[SSD_MAIN],
                timed=[rows[i] for i in SSD_TIMED],
                max_abs_err=max(r["max_abs_err"] for r in rows))


def phase_interp(dev) -> None:
    """interp_grid on CUDA vs CPU over every size 1..2^20 (and above)."""
    import torch
    from repro_torch.core import accelerator as acc
    m = torch.cat([torch.arange(1, 2**20 + 1, dtype=torch.float32),
                   torch.tensor([2**20 + 1, 3e6, 2**31 - 1],
                                dtype=torch.float32)])
    tab = acc.AccelTable.build(list(acc.CATALOG.values()))
    bad = int((acc.log2(m.to(dev)).cpu().view(torch.int32)
               != acc.log2(m).view(torch.int32)).sum())
    for t in (tab.service_cycles, tab.egress_bytes):
        t_cpu = torch.as_tensor(t)
        t_dev = t_cpu.to(dev)
        for a in range(tab.n):
            x = acc.interp_grid(t_dev, a, m.to(dev)).cpu()
            y = acc.interp_grid(t_cpu, a, m)
            bad += int((x.view(torch.int32) != y.view(torch.int32)).sum())
    if bad:
        raise AssertionError(f"interp_grid CUDA != CPU at {bad} points")
    emit("interp", sizes=int(m.numel()), accelerators=tab.n, bitwise=True)


def quickstart_specs():
    from repro_torch.core import SLO, FlowSpec, Path, TrafficPattern
    return [FlowSpec(i, vm_id=i, path=Path.FUNCTION_CALL, accel_id=0,
                     pattern=TrafficPattern(1500, load=0.9),
                     slo=SLO.gbps(slo))
            for i, slo in enumerate((10.0, 20.0, 10.0))]


def _counting_eager_body():
    """Count calls of the dataplane's eager window body (``_run_core``):
    the main path must make none on the card.  Returns the count (a list)
    and the function that restores the body."""
    from repro_torch.core import engine
    calls, core = [0], engine._run_core

    def counted(*a):
        calls[0] += 1
        return core(*a)
    engine._run_core = counted
    return calls, lambda: setattr(engine, "_run_core", core)


def _eager_window_us(dev, n_ticks: int) -> float:
    """Synchronised wall µs a tick of one window of the two admitted
    quickstart tenants through the eager body (``_run_window_eager``)."""
    import torch
    from repro_torch.core import engine, token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import FlowSet
    from repro_torch.core.interconnect import LinkSpec
    from repro_torch.core.sim import SimConfig, gen_arrivals
    flows = FlowSet.build(quickstart_specs()[:2])
    cfg = SimConfig(n_ticks=n_ticks)
    arr = gen_arrivals(flows, cfg, load_ref_gbps={0: 32.0, 1: 32.0})
    tbs = tb.pack([tb.params_for_gbps(10.0), tb.params_for_gbps(20.0)])
    atab = AccelTable.build([CATALOG["ipsec32"]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine._run_window_eager(flows, atab, LinkSpec(), cfg, tbs, *arr,
                             device=dev)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_ticks * 1e6


def phase_main_path(dev) -> dict:
    """The quickstart server through ArcusRuntime on the card: every window
    through its entry's CUDA graph (no eager window body), ``cache_info()``
    steady across the managed windows; beside it the eager body's µs a
    tick on the same tenants."""
    import math

    import torch
    from repro_torch.core import engine, runtime
    from repro_torch.core.accelerator import CATALOG
    from repro_torch.core.profiler import ProfileTable
    from repro_torch.core.runtime import ArcusRuntime
    from repro_torch.kernels.token_bucket import ops
    rt = ArcusRuntime([CATALOG["ipsec32"]],
                      profile_table=ProfileTable(n_ticks=PROFILE_TICKS,
                                                 device=dev), device=dev)
    infos = []
    simulate = runtime.simulate

    def windowed(*a, **k):
        out = simulate(*a, **k)
        infos.append(engine.cache_info())
        return out
    runtime.simulate = windowed
    eager_calls, restore = _counting_eager_body()
    _reset_launch_counts()
    torch.cuda.synchronize()
    try:
        t0 = time.perf_counter()
        admitted = [rt.register(s) for s in quickstart_specs()]
        t1 = time.perf_counter()
        res, reports = rt.run_managed(total_ticks=TOTAL_TICKS,
                                      window_ticks=WINDOW_TICKS,
                                      load_ref_gbps={0: 32.0, 1: 32.0})
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        runtime.simulate = simulate
        restore()
    launches = ops.LAUNCHES
    by_path = dict(ops.LAUNCHES_BY_PATH)
    eager_us = _eager_window_us(dev, EAGER_TICKS)
    profiled = len(rt.profile.entries) * PROFILE_TICKS
    ticks = profiled + TOTAL_TICKS
    expect = ticks          # one grant-tick launch a tick
    emit("reduced", what="tick counts only",
         profile_ticks=[PROFILE_TICKS, 60_000],
         total_ticks=[TOTAL_TICKS, 120_000],
         window_ticks=[WINDOW_TICKS, 30_000])
    rates = [{str(k): v for k, v in r.measured.items()} for r in reports]
    emit("main_path", admitted=admitted, window_rates_gbps=rates,
         violated=[r.violated for r in reports],
         profiled_contexts=len(rt.profile.entries),
         simulated_ticks=ticks,
         us_per_tick_admission=(t1 - t0) / profiled * 1e6,
         us_per_tick_managed=(t2 - t1) / TOTAL_TICKS * 1e6,
         us_per_tick=(t2 - t0) / ticks * 1e6,
         eager_us_per_tick=eager_us, eager_ticks=EAGER_TICKS,
         eager_window_bodies=eager_calls[0],
         cache_info_by_window=infos, cache_info=engine.cache_info(),
         tb_launches=launches, tb_launches_expected=expect,
         tb_launches_by_path=by_path)
    if eager_calls[0]:
        raise AssertionError(f"main path ran the eager window body "
                             f"{eager_calls[0]} times")
    if len(set(map(str, infos[-len(reports):]))) != 1:
        raise AssertionError(f"cache_info() moved across the managed "
                             f"windows: {infos}")
    if admitted != [True, True, False]:
        raise AssertionError(f"admission {admitted} != [True, True, False]")
    if launches != expect or by_path != dict(step=0, grant_tick=expect):
        raise AssertionError(f"token_bucket launches {launches} "
                             f"({by_path}) != ticks = {expect}, all "
                             "grant_tick")
    if len(reports) != TOTAL_TICKS // WINDOW_TICKS or not all(
            math.isfinite(v) and v >= 0 for r in reports
            for v in r.measured.values()):
        raise AssertionError(f"bad window reports: {rates}")
    done, adm = res.counters["c_done_msgs"], res.counters["c_adm_msgs"]
    if not ((done <= adm).all() and done.sum() > 0):
        raise AssertionError(f"counters inconsistent: done={done} adm={adm}")
    return dict(launches=launches, by_path=by_path)


def phase_parity(dev) -> None:
    """simulate windows CUDA vs CPU, bitwise on every counter and the
    completion ring: the two admitted tenants under hardware shaping and
    round robin, and three tenants of weights 1, 2 and 3 under software
    shaping (host-descheduling stalls, deferred refills, host delays) and
    weighted fair queueing."""
    import dataclasses

    import numpy as np
    from repro_torch.core import baselines as bl, token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import FlowSet
    from repro_torch.core.interconnect import ARB_WFQ, LinkSpec
    from repro_torch.core.sim import (SHAPING_SW, SimConfig, gen_arrivals,
                                      gen_stall_mask, simulate)
    atab = AccelTable.build([CATALOG["ipsec32"]])
    plans = [tb.params_for_gbps(g) for g in (10.0, 20.0, 10.0)]
    hw_cfg = SimConfig(n_ticks=PARITY_TICKS)
    sw_cfg = SimConfig(n_ticks=PARITY_TICKS, shaping=SHAPING_SW,
                       arbiter=ARB_WFQ)
    sw_specs = [dataclasses.replace(s, weight=1.0 + i)
                for i, s in enumerate(quickstart_specs())]
    windows = {
        "hw_rr": (FlowSet.build(quickstart_specs()[:2]), hw_cfg,
                  tb.pack(plans[:2]), None),
        "sw_wfq": (FlowSet.build(sw_specs), sw_cfg,
                   bl.make_tb_state(bl.HOST_TS_REFLEX, plans),
                   gen_stall_mask(sw_cfg, seed=1, stall_rate_hz=500_000.0,
                                  stall_us=(0.2, 1.0)))}
    report = {}
    for name, (flows, cfg, tbs, stall) in windows.items():
        arr = gen_arrivals(flows, cfg, load_ref_gbps={
            i: 32.0 for i in range(flows.n)})
        out = [simulate(flows, atab, LinkSpec(), cfg, tbs, *arr, stall,
                        device=d) for d in (dev, "cpu")]
        for k in out[0].counters:
            a, b = out[0].counters[k], out[1].counters[k]
            if a.tobytes() != b.tobytes():
                raise AssertionError(f"{name}: CUDA != CPU counter {k}: {a} "
                                     f"vs {b}")
        for k in ("comp_flow", "comp_lat_s", "comp_t_s", "comp_sz"):
            if not np.array_equal(getattr(out[0], k), getattr(out[1], k)):
                raise AssertionError(f"{name}: CUDA != CPU completion ring "
                                     f"{k}")
        if not len(out[0].comp_flow):
            raise AssertionError(f"{name}: no completions")
        report[name] = dict(
            flows=flows.n, completions=int(len(out[0].comp_flow)),
            stalled_ticks=0 if stall is None else int(np.sum(stall)))
    emit("parity", ticks=PARITY_TICKS, windows=report,
         counters_bitwise=True, ring_bitwise=True)


def _results_equal(name: str, a, b) -> None:
    """Two SimResults bitwise on every counter and the completion ring."""
    import numpy as np
    for k in a.counters:
        if a.counters[k].tobytes() != b.counters[k].tobytes():
            raise AssertionError(f"{name}: counter {k}: {a.counters[k]} vs "
                                 f"{b.counters[k]}")
    for k in ("comp_flow", "comp_lat_s", "comp_t_s", "comp_sz"):
        x, y = getattr(a, k), getattr(b, k)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{name}: completion ring {k} differs")
    if not len(a.comp_flow):
        raise AssertionError(f"{name}: no completions")


def phase_graph_parity(dev) -> None:
    """Windows through the entries' CUDA graphs against the same windows
    through the eager body on the card, bitwise on every counter and the
    completion ring: the two admitted tenants under hardware shaping and
    round robin; three tenants under software shaping and WFQ; and the
    first, resumed (t0 > 0) with a register write."""
    import dataclasses

    import numpy as np
    from repro_torch.core import baselines as bl, token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import FlowSet
    from repro_torch.core.interconnect import ARB_WFQ, LinkSpec
    from repro_torch.core.sim import (SHAPING_SW, SimConfig, gen_arrivals,
                                      gen_stall_mask, simulate)
    n = GRAPH_PARITY_TICKS
    atab = AccelTable.build([CATALOG["ipsec32"]])
    plans = [tb.params_for_gbps(g) for g in (10.0, 20.0, 10.0)]
    hw_cfg = SimConfig(n_ticks=n)
    sw_cfg = SimConfig(n_ticks=n, shaping=SHAPING_SW, arbiter=ARB_WFQ)
    sw_specs = [dataclasses.replace(s, weight=1.0 + i)
                for i, s in enumerate(quickstart_specs())]
    hw_flows = FlowSet.build(quickstart_specs()[:2])
    rewrite = tb.pack([tb.params_for_gbps(3.0), tb.params_for_gbps(30.0)])
    # name: flows, cfg, [(t0, registers)] (a resumed window's first runs
    # from 0), stall mask
    windows = {
        "hw_rr": (hw_flows, hw_cfg, [(0, tb.pack(plans[:2]))], None),
        "sw_wfq": (FlowSet.build(sw_specs), sw_cfg,
                   [(0, bl.make_tb_state(bl.HOST_TS_REFLEX, plans))],
                   gen_stall_mask(sw_cfg, seed=1, stall_rate_hz=500_000.0,
                                  stall_us=(0.2, 1.0))),
        "hw_rr_resumed": (hw_flows, hw_cfg, [(0, tb.pack(plans[:2])),
                                             (n, rewrite)], None)}
    report = {}
    for name, (flows, cfg, steps, stall) in windows.items():
        full = dataclasses.replace(cfg, n_ticks=n * len(steps))
        arr = gen_arrivals(flows, full, load_ref_gbps={
            i: 32.0 for i in range(flows.n)})
        out = []
        for eager in (False, True):
            carry = res = None
            with _eager_windows() if eager else contextlib.nullcontext():
                for t0, regs in steps:
                    res, carry = simulate(flows, atab, LinkSpec(), cfg,
                                          regs, *arr, stall, t0_ticks=t0,
                                          carry=carry, return_carry=True,
                                          device=dev)
            out.append(res)
        _results_equal(f"graph_parity {name}", *out)
        report[name] = dict(
            flows=flows.n, windows=len(steps), t0=[t for t, _ in steps],
            completions=int(len(out[0].comp_flow)),
            stalled_ticks=0 if stall is None else int(np.sum(stall)))
    emit("graph_parity", path="dataplane", ticks=n, windows=report,
         counters_bitwise=True, ring_bitwise=True)


def _decode_graph_parity(arch: str, model, dev, layers: int) -> None:
    """The serving decode step through the engine's CUDA graph against its
    eager body at ``layers`` of depth: three prompts, then
    DECODE_PARITY_STEPS steps, each step's logits and the cache it leaves
    against the eager body run on a copy of the cache the step started
    from; and each replay's decode-attention launches counted (one a
    layer).  Bitwise, or else the same tokens within LOGIT_RTOL /
    LOGIT_ATOL, recorded."""
    import numpy as np
    import torch
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    cut = model.first_layers(layers)
    n_attn = layers - cut.cfg.layer_kinds().count("ssd")
    eng = ServingEngine(cut.cfg, cut, max_batch=4, max_len=256, device=dev)
    graph = eng._decode
    rows = []

    def decode(tok, ln, cache):
        snap = [tuple(t.clone() for t in kv) for kv in cache]
        n0 = da.LAUNCHES
        out = graph(tok, ln, cache)
        launched = da.LAUNCHES - n0
        want = eng._decode_eager(tok, ln, snap)
        same_cache = all(torch.equal(a, b) for kv, sv in zip(cache, snap)
                         for a, b in zip(kv, sv))
        rows.append((out, want, same_cache, launched))
        return out
    eng._decode = decode
    rng = np.random.default_rng(3)
    for i, n in enumerate((80, 12, 40)):
        eng.admit(Request(i, 0, list(rng.integers(0, cut.cfg.vocab, n)),
                          2 * DECODE_PARITY_STEPS))
    for _ in range(DECODE_PARITY_STEPS):
        eng.step()
    bitwise = all(torch.equal(a, b) and c for a, b, c, _ in rows)
    worst = max(float((a.float() - b.float()).abs().max())
                for a, b, _, _ in rows)
    tokens = all(torch.equal(a.argmax(-1), b.argmax(-1))
                 for a, b, _, _ in rows)
    launches = [n for *_, n in rows]
    emit("graph_parity", path=f"{arch} decode", layers=layers,
         steps=len(rows), logits_and_cache_bitwise=bitwise,
         tokens_equal=tokens, max_abs_logit_diff=worst,
         decode_attention_launches_per_replay=launches)
    if len(rows) != DECODE_PARITY_STEPS or launches != [n_attn] * len(rows):
        raise AssertionError(f"{arch} decode graph: {len(rows)} steps, "
                             f"decode-attention launches {launches}")
    if not bitwise:
        _logits_within(f"{arch} decode graph",
                       [("decode", a, b) for a, b, _, _ in rows])
        if not tokens:
            raise AssertionError(f"{arch} decode graph: tokens differ")


def _is_host_wait(name: str) -> bool:
    """A profiler event at which the host waits for the device: the CUDA
    runtime's stream/device/event synchronisations and blocking copies,
    and the scalar read-backs that lead to them."""
    return ("Synchronize" in name or name == "cudaMemcpy"
            or name in ("aten::item", "aten::_local_scalar_dense"))


@contextlib.contextmanager
def _eager_windows():
    """Within: ``simulate`` runs the dataplane's eager body
    (``engine._run_window_eager``) instead of the compiled entry, for the
    graph-against-eager comparisons."""
    from repro_torch.core import engine
    run = engine.run_window
    engine.run_window = engine._run_window_eager
    try:
        yield
    finally:
        engine.run_window = run


def _profile_window(dev, n_ticks: int, eager: bool = False) -> dict:
    """torch.profiler over one simulate window of ``n_ticks`` ticks of the
    two admitted tenants (through the entry's graph, or with ``eager`` the
    eager body; an unprofiled window first captures the graph): host wall
    time, device busy time, device kernels, the token-bucket kernel's
    launches and device time, host waits by name, and the host time of the
    costliest ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import FlowSet
    from repro_torch.core.interconnect import LinkSpec
    from repro_torch.core.sim import SimConfig, gen_arrivals, simulate
    flows = FlowSet.build(quickstart_specs()[:2])
    cfg = SimConfig(n_ticks=n_ticks)
    arr = gen_arrivals(flows, cfg, load_ref_gbps={0: 32.0, 1: 32.0})
    tbs = tb.pack([tb.params_for_gbps(10.0), tb.params_for_gbps(20.0)])
    atab = AccelTable.build([CATALOG["ipsec32"]])
    with _eager_windows() if eager else contextlib.nullcontext():
        simulate(flows, atab, LinkSpec(), cfg, tbs, *arr, device=dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            simulate(flows, atab, LinkSpec(), cfg, tbs, *arr, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    dev_us = kernels = tb_us = tb_n = 0
    waits: dict[str, int] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us += e.time_range.elapsed_us()     # one stream: no overlap
            kernels += 1
            if any(pat in e.name for pat in KERNEL_KINDS["token_bucket"]):
                tb_us += e.time_range.elapsed_us()
                tb_n += 1
        elif _is_host_wait(e.name):
            waits[e.name] = waits.get(e.name, 0) + 1
    top = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")),
                 key=lambda e: -e.cpu_time_total)[:6]
    return dict(wall=wall, dev_us=dev_us, kernels=kernels, waits=waits,
                tb_us=tb_us, tb_launches=tb_n,
                top={e.key: e.cpu_time_total / n_ticks for e in top})


def _window_row(p: dict, n: int) -> dict:
    return dict(host_us_per_tick=p["wall"] / n * 1e6,
                device_busy_us_per_tick=p["dev_us"] / n,
                device_kernels_per_tick=p["kernels"] / n,
                device_idle_share=max(0.0, 1.0 - p["dev_us"]
                                      / (p["wall"] * 1e6)),
                token_bucket_launches=p["tb_launches"],
                token_bucket_device_us_per_launch=p["tb_us"] / max(
                    p["tb_launches"], 1),
                top_host_ops_us_per_tick=p["top"])


def phase_profile(dev) -> dict:
    """Where one window's time goes, through the entry's graph and through
    the eager body, and through the batch entry's graph at fig6's
    configuration with B = 1 and BATCH_PROFILE_SIZES elements (kernels and
    device µs a tick as B grows; one grant-tick launch a tick each), and a
    check that the tick never makes the host wait:
    graph windows of PROFILE_WINDOW and 2 x PROFILE_WINDOW ticks must show
    the same host waits (the window's setup and result copies).  Also the
    launch floor: the device time of the smallest kernel the card runs (a
    one-element in-place add) under the same profiler.  Returns the
    token-bucket kernel's device ms per launch and the floor."""
    import torch
    from repro_torch.core import engine
    n = PROFILE_WINDOW
    p1, p2 = _profile_window(dev, n), _profile_window(dev, 2 * n)
    pe = _profile_window(dev, n, eager=True)
    one = torch.zeros(1, device=dev)
    floor_ms = device_ms_per_launch(lambda: one.add_(1), "elementwise", 200)
    grown = {k: (p1["waits"].get(k, 0), v) for k, v in p2["waits"].items()
             if v > p1["waits"].get(k, 0)}
    batched = [_profile_batch_window(dev, B, n)
               for B in (1, *BATCH_PROFILE_SIZES)]
    emit("profile", ticks=n, **_window_row(p1, n),
         eager=_window_row(pe, n), launch_floor_ms=floor_ms,
         host_waits_per_window={str(n): p1["waits"], str(2 * n): p2["waits"]},
         batched_fig6_config=batched, cache_info=engine.cache_info())
    for row in batched:
        if row["token_bucket_launches"] != n:
            raise AssertionError(f"batched profile window: {row}")
    if not p1["waits"]:
        raise AssertionError("profiler recorded no host wait at all (the "
                             "window's result copy is one): cannot check")
    if grown:
        raise AssertionError(f"host waits grow with ticks: {grown}")
    if not p1["tb_launches"]:
        raise AssertionError("profiled window shows no token-bucket kernel")
    return dict(tb_device_ms_per_launch=p1["tb_us"] / p1["tb_launches"]
                / 1e3, launch_floor_ms=floor_ms, batched=batched)


# ---------------------------------------------------------------------------
# the batched dataplane: run_window_batch -> simulate_batch ->
# run_system_batch / profile_contexts
# ---------------------------------------------------------------------------

# Fig. 6 / Table 3 (benchmarks/fig6_throughput_cdf.py:48-87), rebuilt from
# the port: two 4096 B Poisson users at SLOs of 300K / 200K IOPS on
# nvme_raid0, Arcus and the two software shapers at load points 1.5 and
# 0.9 (B = 6), LinkSpec(credits=256), seed 3, the benchmark's overrides;
# 60,000 ticks is its quick setting (quick=False runs 400,000)
FIG6_TICKS = 60_000
FIG6_SERIAL_TICKS = 2_000
FIG6_B = 6
FIG6_SYSTEMS = ("Arcus", "Host_TS_reflex", "Host_TS_firecracker")
FIG6_LOADS = (1.5, 0.9)
FIG6_SLOS = (300_000.0, 200_000.0)
FIG6_OVERRIDES = dict(tick_cycles=64, comp_cap=1 << 17, k_grant=8, k_srv=8,
                      k_eg=8, qlen=512, lmax=64)
# result_digest of each element of the JAX reference's run of this batch on
# the CPU at FIG6_TICKS (tests/_torch_parity.fig6_batch_digests)
FIG6_DIGESTS = [
    "9e0b084bcf369c24d7197a02ed34a4a412aa3840178be9cc0715b727a74df3ab",
    "596ed6b4f18b86451e20e8bcb8cca7fb99e9c0047759e3a11d669c3594c3dce3",
    "005ffd88655190d6821e8e8c351d46ad049df82e1588cfed0b68a31aefd44935",
    "0f6e5f494874af72adee08c82d5cfbe1b984e8275be502e908c083483cc10857",
    "1e1b5f410f126e3e31d49ce2fa0a6e234d98530402a153d3d912e88f8519aa68",
    "f45997bc8431b8f7ce8107033e24b741c9b4bd728620c2d2bb8e016f0492275f",
]
# benchmarks/sim_perf.py:180-211: the profiler's eight heterogeneous
# contexts, entries held against serial profile_context calls at the quick
# setting, the batched call timed alone at the full one
PROFILE8_TICKS = (6_000, 30_000)
# batch_parity: windows of the ragged B = 4 batch
BATCH_PARITY_TICKS = 300
# the profile phase's batched rows (fig6's configuration)
BATCH_PROFILE_SIZES = (6, 64)


def result_digest(res) -> str:
    """sha256 of one SimResult's counters (by sorted key) and completion
    ring (flow, latency, time, size), each array's bytes in turn (as
    tests/_torch_parity.result_digest)."""
    import hashlib

    import numpy as np
    h = hashlib.sha256()
    for k in sorted(res.counters):
        h.update(np.ascontiguousarray(res.counters[k]).tobytes())
    for k in ("comp_flow", "comp_lat_s", "comp_t_s", "comp_sz"):
        h.update(np.ascontiguousarray(getattr(res, k)).tobytes())
    return h.hexdigest()


def phase_kernel_grant_tick_batch(dev) -> dict:
    """The batched grant tick (one launch, one CTA an element) against its
    plain version on fresh copies, bitwise on every leaf it writes, at
    B = 1, 6 and 64 (``rehearse.batch_case``: ragged flows 1..33 with
    mid-table holes, every shaping mode and arbiter, stalls), with
    per-element and shared stall rows; then its device ms a launch
    (``torch.profiler``) and bound at each B."""
    from repro_torch.kernels.token_bucket import rehearse
    rows = []
    for B in rehearse.BATCH_SIZES:
        for shared in (False, True):
            row = rehearse.check_batch(B, dev, shared_stall=shared)
            if row["launches"] != 1 or row["differ"] or row["hole_grants"]:
                raise AssertionError(f"batched grant tick != plain: {row}")
            rows.append(row)
    times = {B: rehearse.time_grant_tick_batch(B, dev)
             for B in rehearse.BATCH_SIZES}
    emit("kernel_grant_tick_batch", name="token_bucket/grant_tick",
         bitwise=True, cases=[{k: r[k] for k in ("batch", "shared_stall",
                                                 "grants")} for r in rows],
         times={str(k): v for k, v in times.items()})
    return dict(times=times)


def _batch_elements(n_ticks: int):
    """batch_parity's ragged batch, B = 4, built with the port as the CPU
    tests build it (``tests/_engine_cases.BATCH_ELEMENTS``): flows 1-3,
    accelerators 1-2; HW + RR, SW + WFQ with stalls, NONE + PRIORITY, HW +
    WRR.  (flows, tables, configs, registers, traces, stall masks, the
    second window's registers)."""
    import numpy as np
    from repro_torch.core import baselines as bl, token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import (SLO, FlowSet, FlowSpec, Path,
                                       TrafficPattern)
    from repro_torch.core.interconnect import (ARB_PRIORITY, ARB_RR, ARB_WFQ,
                                               ARB_WRR)
    from repro_torch.core.sim import (SHAPING_HW, SHAPING_NONE, SHAPING_SW,
                                      SimConfig, gen_arrivals,
                                      gen_stall_mask, stack_arrivals)
    system = {SHAPING_NONE: bl.HOST_NO_TS, SHAPING_HW: bl.ARCUS,
              SHAPING_SW: bl.HOST_TS_REFLEX}
    els = [(SHAPING_HW, ARB_RR, 1, ("ipsec32",)),
           (SHAPING_SW, ARB_WFQ, 3, ("ipsec32", "aes256")),
           (SHAPING_NONE, ARB_PRIORITY, 2, ("ipsec32",)),
           (SHAPING_HW, ARB_WRR, 3, ("synthetic50", "sha3_512"))]
    paths = (Path.FUNCTION_CALL, Path.INLINE_NIC_RX)
    out = [[] for _ in range(7)]
    for shaping, arb, n, accels in els:
        slos = [SLO.gbps(8.0 * (i + 1)) for i in range(n)]
        flows = FlowSet.build([
            FlowSpec(i, i, paths[i % 2], i % len(accels),
                     TrafficPattern(1500, load=0.9, process="poisson"),
                     slos[i], priority=i, weight=1.0 + i)
            for i in range(n)])
        sw = dict(sw_host_delay_cycles=100, sw_jitter_cycles=800) \
            if shaping == SHAPING_SW else {}
        cfg = SimConfig(n_ticks=n_ticks, shaping=shaping, arbiter=arb, **sw)
        stall = (gen_stall_mask(cfg, seed=1, stall_rate_hz=500_000.0,
                                stall_us=(0.2, 1.0))
                 if shaping == SHAPING_SW else np.zeros(n_ticks, bool))
        for lst, v in zip(out, (
                flows, AccelTable.build([CATALOG[a] for a in accels]), cfg,
                bl.make_tb_state(system[shaping], [
                    tb.params_for_gbps(s.target) for s in slos]),
                gen_arrivals(flows, cfg, seed=3,
                             load_ref_gbps={i: 40.0 for i in range(n)}),
                stall,
                bl.make_tb_state(system[shaping], [
                    tb.params_for_gbps(4.0 * (i + 1)) for i in range(n)]))):
            lst.append(v)
    flows, tabs, cfgs, regs, arrs, stalls, regs2 = out
    return (flows, tabs, cfgs, regs, stack_arrivals(arrs), np.stack(stalls),
            regs2)


def phase_batch_parity(dev) -> None:
    """The ragged B = 4 batch three ways, bitwise on every carry leaf or
    result: (1) three windows through the batch entry's CUDA graph against
    the same windows on the CPU: a first window with a mid-table
    ``fl_masks`` hole; a resumed window with a recycled lane and register
    writes; a resumed window after a released lane with
    ``tb_states=None``; (2) the same three windows through the eager body
    on the card against the graph's; (3) each element of a
    ``simulate_batch`` window on the card against its own serial
    ``simulate`` on the card."""
    import dataclasses

    import numpy as np
    from repro_torch.core import engine
    from repro_torch.core.interconnect import LinkSpec
    from repro_torch.core.sim import simulate, simulate_batch
    from repro_torch.kernels.token_bucket import ops
    n = BATCH_PARITY_TICKS
    flows, tabs, cfgs, regs, arr, stall, regs2 = _batch_elements(3 * n)
    wins = [dataclasses.replace(c, n_ticks=n) for c in cfgs]
    masks = [np.arange(3) < f.n for f in flows]
    masks[3][1] = False                 # the hole
    steps = [(None, [m.copy() for m in masks], regs),
             ("recycle", [np.arange(3) < f.n for f in flows], regs2),
             ("release", [np.arange(3) < f.n for f in flows], None)]
    steps[2][1][1][2] = False

    def run(fn, device) -> list:
        carry, out = None, []
        for w, (surgery, m, r) in enumerate(steps):
            if surgery == "recycle":
                carry = engine.recycle_flow_lane(carry, 3, 1)
            elif surgery == "release":
                carry = engine.release_flow_lane(carry, 1, 2)
            carry = fn(flows, tabs, LinkSpec(), wins, r, *arr, stall,
                       t0_ticks=w * n, carry=carry, fl_masks=m,
                       device=device)
            out.append(engine.carry_to_numpy(carry))
        return out

    engine.cache_clear()
    n0 = ops.LAUNCHES_BY_PATH["grant_tick"]
    graph = run(engine.run_window_batch, dev)
    launched = ops.LAUNCHES_BY_PATH["grant_tick"] - n0
    info = engine.cache_info()
    cpu = run(engine.run_window_batch, "cpu")
    eager = run(engine._run_window_batch_eager, dev)
    for w, (g, c, e) in enumerate(zip(graph, cpu, eager)):
        for k, v in c.items():
            for a, b, x in zip(*((t[k] if k == "tb" else (t[k],))
                                 for t in (c, g, e))):
                if a.tobytes() != b.tobytes():
                    raise AssertionError(f"batch_parity window {w}: CUDA "
                                         f"graph != CPU on {k}")
                if b.tobytes() != x.tobytes():
                    raise AssertionError(f"batch_parity window {w}: graph "
                                         f"!= eager body on {k}")
    if launched != 3 * n or info != {"entries": 1, "traces": 1}:
        raise AssertionError(f"batch_parity: {launched} grant-tick launches "
                             f"for {3 * n} ticks, cache {info}")
    batch = simulate_batch(flows, tabs, LinkSpec(), wins, regs, *arr,
                           stall, device=dev)
    for b, f in enumerate(flows):
        serial = simulate(f, tabs[b], LinkSpec(), wins[b], regs[b],
                          arr[0][b, :f.n], arr[1][b, :f.n], stall[b],
                          device=dev)
        _results_equal(f"batch_parity element {b} vs serial", serial,
                       batch[b])
    last = cpu[-1]
    emit("batch_parity", batch=len(flows), ticks=n, windows=3,
         flows=[f.n for f in flows], accelerators=[t.n for t in tabs],
         modes=[[c.shaping, c.arbiter] for c in cfgs],
         admitted=last["c_adm_msgs"].tolist(),
         completions=last["comp_n"].tolist(), cache_info=info,
         grant_tick_launches=launched, cuda_vs_cpu_bitwise=True,
         graph_vs_eager_bitwise=True, elements_vs_serial_bitwise=True)
    if not (last["comp_n"] > 0).all():
        raise AssertionError(f"batch_parity: an element completed nothing: "
                             f"{last['comp_n']}")


def fig6_inputs(n_ticks: int, B: int = 6):
    """fig6's batch with the port: ``run_system_batch``'s arguments for
    Arcus, Host_TS_reflex and Host_TS_firecracker at load points 1.5 and
    0.9 (element 2 s + l), cycled to ``B`` elements."""
    from repro_torch.core import baselines as bl, token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import (SLO, FlowSet, FlowSpec, Path,
                                       TrafficPattern)
    from repro_torch.core.interconnect import LinkSpec
    from repro_torch.core.sim import gen_arrivals

    def flows(load_x):
        return FlowSet.build([
            FlowSpec(i, i, Path.FUNCTION_CALL, 0,
                     TrafficPattern(4096, rate_mps=slo * load_x,
                                    process="poisson"), SLO.iops(slo))
            for i, slo in enumerate(FIG6_SLOS)])
    cfg0 = bl.make_sim_config(bl.ALL[FIG6_SYSTEMS[0]], n_ticks,
                              **FIG6_OVERRIDES)
    arrs_lp = [gen_arrivals(flows(x), cfg0, seed=3) for x in FIG6_LOADS]
    plans = [tb.params_for_iops(s) for s in FIG6_SLOS]
    six = [(bl.ALL[name], a) for name in FIG6_SYSTEMS for a in arrs_lp]
    els = [six[b % len(six)] for b in range(B)]
    return dict(systems=[s for s, _ in els], flows=flows(1.0),
                accels=AccelTable.build([CATALOG["nvme_raid0"]]),
                link=LinkSpec(credits=256),
                tb_states=[bl.make_tb_state(s, plans) for s, _ in els],
                arr=[a for _, a in els])


def deviation_percentiles(res, flow_id: int, target: float,
                          window: int = 500) -> dict:
    """Table 3's p25/p50/p75/p99 throughput deviation from the SLO, in
    percent (benchmarks/fig6_throughput_cdf.py:90-99)."""
    import numpy as np
    samp = res.throughput_samples(flow_id, window_msgs=window, kind="iops",
                                  warmup_s=0.15 * res.seconds)
    if len(samp) == 0:
        return {}
    qs = {q: float(np.percentile(samp, q)) for q in (25, 50, 75, 99)}
    return {f"p{q}_dev_pct": 100 * (v - target) / target
            for q, v in qs.items()}


def phase_fig6_batch(dev) -> dict:
    """The slice's path at full size: fig6's six elements (three systems,
    two load points, mixed shaping modes and stall masks) as ONE
    ``run_system_batch`` of FIG6_TICKS ticks, every tick one replay of the
    batch entry's graph with one grant-tick launch; each element's counters
    and completion ring against the JAX reference's digest; µs a batched
    tick and element-ticks a second, beside one element's serial µs a tick
    (FIG6_SERIAL_TICKS through its graph); Table 3's deviations."""
    import math

    import numpy as np
    import torch
    from repro_torch.core import baselines as bl, engine
    from repro_torch.core.sim import simulate
    from repro_torch.kernels.token_bucket import ops
    inp = fig6_inputs(FIG6_TICKS)
    B = len(inp["systems"])
    engine.cache_clear()
    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    res = bl.run_system_batch(
        inp["systems"], inp["flows"], inp["accels"], inp["link"],
        FIG6_TICKS, tb_states=inp["tb_states"], arr=inp["arr"],
        cfg_overrides=FIG6_OVERRIDES, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_path = ops.LAUNCHES, dict(ops.LAUNCHES_BY_PATH)
    info = engine.cache_info()
    digests = [result_digest(r) for r in res]
    # one element (Arcus, load 1.5) alone through its serial graph
    cfg = bl.make_sim_config(inp["systems"][0], FIG6_SERIAL_TICKS,
                             **FIG6_OVERRIDES)
    sargs = (inp["flows"], inp["accels"], inp["link"], cfg,
             inp["tb_states"][0], *inp["arr"][0])
    simulate(*sargs, device=dev)                  # captures its graph
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    simulate(*sargs, device=dev)
    torch.cuda.synchronize()
    serial_us = (time.perf_counter() - t1) / FIG6_SERIAL_TICKS * 1e6
    batch_us = wall / FIG6_TICKS * 1e6
    table3 = {}
    for i, r in enumerate(res):
        name = f"{inp['systems'][i].name}@{FIG6_LOADS[i % 2]}"
        table3[name] = {f"user{u + 1}": deviation_percentiles(r, u, slo)
                        for u, slo in enumerate(FIG6_SLOS)}
    emit("fig6_batch", batch=B, ticks=FIG6_TICKS,
         reduced=dict(ticks=[FIG6_TICKS, 400_000]),
         systems=[s.name for s in inp["systems"]], loads=list(FIG6_LOADS),
         wall_s=wall, us_per_batched_tick=batch_us,
         element_ticks_per_s=B * FIG6_TICKS / wall,
         serial_us_per_tick=serial_us, serial_ticks=FIG6_SERIAL_TICKS,
         serial_element_ticks_per_s=1e6 / serial_us,
         grant_tick_launches=launches, launches_by_path=by_path,
         cache_info=info, completions=[int(len(r.comp_flow)) for r in res],
         admitted=[r.counters["c_adm_msgs"].tolist() for r in res],
         digests_match_reference=digests == FIG6_DIGESTS,
         table3_deviation_pct=table3)
    if digests != FIG6_DIGESTS:
        bad = [i for i, (a, b) in enumerate(zip(digests, FIG6_DIGESTS))
               if a != b]
        raise AssertionError(f"fig6_batch: elements {bad} differ from the "
                             f"JAX reference's run: {digests}")
    if launches != FIG6_TICKS or by_path != dict(step=0,
                                                 grant_tick=FIG6_TICKS):
        raise AssertionError(f"fig6_batch: token-bucket launches {by_path} "
                             f"!= {FIG6_TICKS} grant ticks")
    if info != {"entries": 1, "traces": 1}:
        raise AssertionError(f"fig6_batch: cache {info}")
    if not all(len(r.comp_flow) and math.isfinite(
            float(np.sum(r.counters["c_lat_sum"]))) for r in res):
        raise AssertionError("fig6_batch: an element completed nothing")
    return dict(launches=launches, by_path=by_path)


def _profile8_contexts():
    from repro_torch.core.accelerator import CATALOG
    from repro_torch.core.flow import Path
    fc, rx = Path.FUNCTION_CALL, Path.INLINE_NIC_RX
    return [
        (CATALOG["ipsec32"], [(fc, 64, 0.9)]),
        (CATALOG["ipsec32"], [(fc, 1500, 0.9)] * 2),
        (CATALOG["ipsec32"], [(fc, 64, 0.9), (fc, 1500, 0.9)]),
        (CATALOG["synthetic50"], [(fc, 512, 0.9)] * 3),
        (CATALOG["synthetic50"], [(fc, 4096, 0.9)]),
        (CATALOG["aes256"], [(fc, 1024, 0.9)] * 2),
        (CATALOG["sha3_512"], [(rx, 256, 0.9)] * 2),
        (CATALOG["compress"], [(fc, 4096, 0.9), (fc, 64, 0.9),
                               (fc, 1024, 0.9)])]


def phase_profile_batch8(dev) -> dict:
    """sim_perf's eight heterogeneous contexts (ragged 1-3 flows on
    ipsec32 / synthetic50 / aes256 / sha3_512 / compress) through
    ``ProfileTable.profile_contexts``: at PROFILE8_TICKS[0], entries equal
    to eight serial ``profile_context`` calls on the card and exactly one
    new batch entry; at PROFILE8_TICKS[1], the batched call timed alone
    with its launches counted."""
    import dataclasses

    import torch
    from repro_torch.core import engine, profiler
    from repro_torch.kernels.token_bucket import ops
    ctxs = _profile8_contexts()
    quick, full = PROFILE8_TICKS
    engine.cache_clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = [profiler.ProfileTable(n_ticks=quick, device=dev)
              .profile_context(a, f) for a, f in ctxs]
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    before = engine.cache_info()["entries"]
    profiler.profiling_stats_clear()
    batch = profiler.ProfileTable(n_ticks=quick, device=dev) \
        .profile_contexts(ctxs)
    new_entries = engine.cache_info()["entries"] - before
    same = [dataclasses.asdict(e) for e in serial] == \
        [dataclasses.asdict(e) for e in batch]
    stats = profiler.profiling_stats()
    engine.cache_clear()
    torch.cuda.synchronize()
    _reset_launch_counts()
    t1 = time.perf_counter()
    full_entries = profiler.ProfileTable(n_ticks=full, device=dev) \
        .profile_contexts(ctxs)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t1
    launches, by_path = ops.LAUNCHES, dict(ops.LAUNCHES_BY_PATH)
    emit("profile_batch8", contexts=len(ctxs),
         flows=[len(f) for _, f in ctxs], ticks=[quick, full],
         entries_match_serial=same, new_batch_entries=new_entries,
         profiling_stats=stats, serial_wall_s=serial_s,
         batched_wall_s=full_s,
         us_per_batched_tick=full_s / full * 1e6,
         element_ticks_per_s=len(ctxs) * full / full_s,
         grant_tick_launches=launches,
         capacity_gbps=[e.capacity_gbps for e in full_entries])
    if not same:
        raise AssertionError("profile_batch8: batched entries != serial "
                             "profile_context entries")
    if new_entries != 1 or stats["sim_batches"] != 1:
        raise AssertionError(f"profile_batch8: {new_entries} new entries, "
                             f"stats {stats}")
    if launches != full or by_path != dict(step=0, grant_tick=full):
        raise AssertionError(f"profile_batch8: token-bucket launches "
                             f"{by_path} != {full} grant ticks")
    return dict(launches=launches, by_path=by_path)


def _profile_batch_window(dev, B: int, n_ticks: int) -> dict:
    """One window of ``n_ticks`` ticks of fig6's batch cycled to ``B``
    elements through the batch entry's graph (a first window captures it):
    timed alone (µs a tick, element-ticks a second), then under
    torch.profiler as ``_profile_window`` does for the serial one (a trace
    that misses a grant-tick launch is taken again, up to three times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import baselines as bl
    inp = fig6_inputs(n_ticks, B)

    def window():
        bl.run_system_batch(
            inp["systems"], inp["flows"], inp["accels"], inp["link"],
            n_ticks, tb_states=inp["tb_states"], arr=inp["arr"],
            cfg_overrides=FIG6_OVERRIDES, device=dev)
    window()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    unprofiled = time.perf_counter() - t0
    for _ in range(3):          # a trace that misses a grant tick: again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            window()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev_us = kernels = tb_us = tb_n = 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev_us += e.time_range.elapsed_us()
                kernels += 1
                if any(pat in e.name
                       for pat in KERNEL_KINDS["token_bucket"]):
                    tb_us += e.time_range.elapsed_us()
                    tb_n += 1
        if tb_n == n_ticks:
            break
    return dict(batch=B, us_per_tick=unprofiled / n_ticks * 1e6,
                element_ticks_per_s_unprofiled=B * n_ticks / unprofiled,
                host_us_per_tick=wall / n_ticks * 1e6,
                device_busy_us_per_tick=dev_us / n_ticks,
                device_kernels_per_tick=kernels / n_ticks,
                device_idle_share=max(0.0, 1.0 - dev_us / (wall * 1e6)),
                element_ticks_per_s=B * n_ticks / wall,
                token_bucket_launches=tb_n,
                token_bucket_device_us_per_launch=tb_us / max(tb_n, 1))


# ---------------------------------------------------------------------------
# serving: gemma3-12b at full width
# ---------------------------------------------------------------------------


def _kernel_ops() -> dict:
    """The wrapper module of each kernel, by the kernel table's name."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.token_bucket import ops as tb
    return dict(token_bucket=tb, decode_attention=da, flash_prefill=fp,
                ssd_scan=ssd)


def _launch_counts() -> dict:
    return {name: m.LAUNCHES for name, m in _kernel_ops().items()}


def _reset_launch_counts() -> None:
    for m in _kernel_ops().values():
        m.LAUNCHES = 0
        for path in getattr(m, "LAUNCHES_BY_PATH", {}):
            m.LAUNCHES_BY_PATH[path] = 0


def _instrument(engine, keep_logits: bool = False) -> dict:
    """Count and time (synchronised wall clock) the engine's prefill and
    decode calls, check their logits are finite, and optionally keep a
    copy of every call's logits."""
    import torch
    rec = dict(prefills=0, decodes=0, prefill_s=0.0, decode_s=0.0,
               finite=True, logits=[])
    pre, dec = engine._prefill, engine._decode

    def timed(kind, fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        logits = out[0] if kind == "prefill" else out
        rec["finite"] &= bool(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        rec[kind + "_s"] += time.perf_counter() - t0
        rec[kind + "s"] += 1
        if keep_logits:
            rec["logits"].append((kind, logits.clone()))
        return out
    engine._prefill = lambda *a: timed("prefill", pre, *a)
    engine._decode = lambda *a: timed("decode", dec, *a)
    return rec


def _scheduler(model, dev, *, arch, max_batch, max_len, mix, plain=False,
               keep_logits=False, long_prompt=LONG_PROMPT, shadow=None):
    """An ArcusScheduler (token-bucket kernel on) over a fresh engine, with
    ``mix`` submitted: ``"serve"`` is ``launch/serve.py``'s mix (two
    reserved tenants of 1200 and 800 tokens/s, an opportunistic background
    tenant), ``"long"`` is LONG_REQUESTS prompts of ``long_prompt`` tokens
    for one opportunistic tenant.  The clock is ``arch``'s full config's
    cost model on one H100 (``HardwareSpec()``), whatever the depth run, as
    the launcher clocks its reduced model by the full config.  ``shadow``
    (a list) receives, for every prefill and decode call, the call's logits
    and those of the plain versions run on a copy of the cache the call
    started from (``_shadow_plain``)."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve as S
    from repro_torch.serving.costmodel import HardwareSpec, StepCostModel
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ArcusScheduler
    engine = ServingEngine(model.cfg, model, max_batch=max_batch,
                           max_len=max_len, device=dev,
                           plain_kernels=plain)
    rec = _instrument(engine, keep_logits)
    if shadow is not None:
        _shadow_plain(engine, shadow)
    cost = StepCostModel(get_config(arch), HardwareSpec())
    if mix == "serve":
        sched = ArcusScheduler(engine, S.make_tenants([1200.0, 800.0], True),
                               cost, use_kernel=True)
        n = S.submit_mix(sched, model.cfg.vocab, 2, 3.0, True)
    else:
        sched = ArcusScheduler(engine, S.make_tenants([], True), cost,
                               use_kernel=True)
        rng = np.random.default_rng(1)
        for n in range(LONG_REQUESTS):
            sched.submit(Request(n, 0, list(rng.integers(
                0, model.cfg.vocab, long_prompt)), LONG_NEW))
        n = LONG_REQUESTS
    rounds = [0]
    step = sched.step

    def counted_step():
        rounds[0] += 1
        return step()
    sched.step = counted_step
    return sched, rec, rounds, n


def _shadow_plain(engine, pairs: list) -> None:
    """Wrap the engine's prefill and decode so that each call also runs the
    model's plain versions on a copy of the cache it starts from, and
    append (kind, logits, plain logits) to ``pairs``: the kernels against
    their plain versions on the same inputs at every call.  The plain calls
    launch no kernel."""
    from repro_torch.models import transformer as T
    model = engine.params
    pre, dec = engine._prefill, engine._decode

    def copy(cache):
        return [tuple(t.clone() for t in layer) for layer in cache]

    def prefill(tok, cache):
        snap = copy(cache)
        out = pre(tok, cache)
        pairs.append(("prefill", out[0],
                      T.prefill(model, tok, snap, plain=True)[0]))
        return out

    def decode(tok, ln, cache):
        snap = copy(cache)
        out = dec(tok, ln, cache)
        pairs.append(("decode", out,
                      T.decode_step(model, tok, ln, snap, plain=True)))
        return out
    engine._prefill, engine._decode = prefill, decode


def _logits_within(name, pairs) -> float:
    """Every (kind, a, b) within LOGIT_RTOL / LOGIT_ATOL; the largest
    difference."""
    worst = 0.0
    for i, (kind, a, b) in enumerate(pairs):
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()))
        bad = diff > LOGIT_ATOL + LOGIT_RTOL * b.abs()
        if bool(bad.any()):
            raise AssertionError(
                f"{name}: {kind} call {i}: {int(bad.sum())} logits differ, "
                f"max {float(diff.max())}")
    return worst


def _run_path(name, model, dev, **kw) -> dict:
    """Drive one serving path with the launch counts set to 0 just before
    and read just after; check every request finished, the logits were
    finite and each kernel launched once for each layer of its kind in each
    call: decode attention per decode step and flash prefill per prefill
    for each attention layer, the SSD scan per prefill for each ``ssd``
    layer, the token bucket once per prefill and once per round."""
    import numpy as np
    import torch
    max_rounds = kw.pop("max_rounds", 2000)
    sched, rec, rounds, n_req = _scheduler(model, dev, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    sched.run(3.0, max_rounds=max_rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    fp_paths = dict(_kernel_ops()["flash_prefill"].LAUNCHES_BY_PATH)
    ssd_paths = dict(_kernel_ops()["ssd_scan"].LAUNCHES_BY_PATH)
    tb_paths = dict(_kernel_ops()["token_bucket"].LAUNCHES_BY_PATH)
    L = model.cfg.n_layers
    kinds = model.cfg.layer_kinds()
    n_ssd = kinds.count("ssd")
    n_attn = L - n_ssd
    expect = dict(token_bucket=rec["prefills"] + rounds[0],
                  decode_attention=rec["decodes"] * n_attn,
                  flash_prefill=rec["prefills"] * n_attn,
                  ssd_scan=rec["prefills"] * n_ssd)
    finished = sum(st.finished for st in sched.stats.values())
    stats = {str(t): dict(served_tokens=st.served_tokens,
                          finished=st.finished,
                          p99_ttft_ms=(float(np.percentile(st.ttft, 99)) * 1e3
                                       if st.ttft else None))
             for t, st in sorted(sched.stats.items())}
    out = dict(layers=L, requests=n_req, finished=finished,
               rounds=rounds[0], virtual_s=sched.now_s,
               prefills=rec["prefills"], decode_steps=rec["decodes"],
               wall_s=wall,
               ms_per_prefill=rec["prefill_s"] / max(rec["prefills"], 1)
               * 1e3,
               ms_per_decode_step=rec["decode_s"] / max(rec["decodes"], 1)
               * 1e3,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, launches_expected=expect,
               flash_prefill_paths=fp_paths, ssd_scan_paths=ssd_paths,
               token_bucket_paths=tb_paths,
               longest_sequence=int(sched.engine.lengths.max()),
               tenants=stats)
    plain = kw.get("plain", False)
    if plain:
        expect.update(decode_attention=0, flash_prefill=0, ssd_scan=0)
    if not rec["finite"]:
        raise AssertionError(f"{name}: non-finite logits")
    if finished != n_req:
        raise AssertionError(f"{name}: {finished} of {n_req} requests "
                             "finished")
    if launches != expect or not all(
            v > 0 for k, v in launches.items() if expect[k]):
        raise AssertionError(f"{name}: launches {launches} != {expect}")
    # the scheduler's buckets take the step kernel, never the grant tick
    if tb_paths != dict(step=launches["token_bucket"], grant_tick=0):
        raise AssertionError(f"{name}: token-bucket launches {tb_paths}")
    # the models' q, k, v and x, B, C are bf16: every flash-prefill and
    # SSD-scan launch is the tensor-core kernel's
    if model.cfg.dtype == "bfloat16":
        for kname, paths in (("flash_prefill", fp_paths),
                             ("ssd_scan", ssd_paths)):
            if paths["tensor_core"] != launches[kname]:
                raise AssertionError(f"{name}: {kname} off the tensor-core "
                                     f"path: {paths}")
    out["sched"], out["rec"] = sched, rec
    return out


def _public(run: dict) -> dict:
    return {k: v for k, v in run.items() if k not in ("sched", "rec")}


#: kernel-name patterns of each kind in a profile (cuBLAS's Hopper GEMMs
#: are named nvjet_*)
KERNEL_KINDS = {
    "decode_attention": ("decode_attention_cluster",),
    "flash_prefill": ("flash_prefill",),
    "ssd_scan": ("ssd_scan", "ssd_chunk_kernel", "ssd_state_pass_kernel",
                 "ssd_output_kernel"),
    "token_bucket": ("tb_step", "tb_grant_tick"),
    "gemm": ("nvjet", "gemm", "gemv", "cutlass", "xmma", "splitK"),
    "elementwise": ("elementwise", "vectorized", "unrolled"),
    "reduce": ("reduce",),
    "copy": ("copy", "Memcpy", "Memset", "scatter", "gather", "index"),
}


def _profile(fn, calls: int) -> dict:
    """torch.profiler over ``calls`` calls of ``fn``: wall and device busy
    ms a call, the device's idle share, device ms a call by kind of kernel
    and the costliest kernels by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kind: dict[str, float] = {}
    by_name: dict[str, float] = {}
    busy = kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3 / calls
            busy += ms
            kernels += 1
            kind = next((k for k, pats in KERNEL_KINDS.items()
                         if any(p in e.name for p in pats)), "other")
            by_kind[kind] = by_kind.get(kind, 0.0) + ms
            by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + ms
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return dict(calls=calls, wall_ms=wall / calls * 1e3,
                device_busy_ms=busy, device_idle_share=max(
                    0.0, 1.0 - busy / (wall / calls * 1e3)),
                device_kernels=kernels / calls, device_ms_by_kind=by_kind,
                top_kernels_ms=top)


def _profile_serving(model, dev, long_prompt=LONG_PROMPT) -> dict:
    """Where a decode step and a prefill spend their time: 4 decode steps
    of a full batch (8 requests with 64-token prompts, max_len 256) through
    the engine's decode graph, then 4 through its eager body, and the
    prefill of one ``long_prompt``-token prompt (max_len 2048)."""
    import numpy as np
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(2)
    engine = ServingEngine(model.cfg, model, max_batch=8, max_len=256,
                           device=dev)
    for i in range(8):
        engine.admit(Request(i, 0, list(rng.integers(0, model.cfg.vocab,
                                                     64)), 64))
    engine.step()
    decode = _profile(engine.step, 4)
    engine._decode = engine._decode_eager
    engine.step()
    decode_eager = _profile(engine.step, 4)
    del engine
    engine = ServingEngine(model.cfg, model, max_batch=1, max_len=2048,
                           device=dev)
    prompt = list(rng.integers(0, model.cfg.vocab, long_prompt))

    def prefill():
        engine.active[:] = False
        engine.admit(Request(0, 0, prompt, 2))
    prefill()
    return {"decode_step": decode, "decode_step_eager": decode_eager,
            f"prefill_{long_prompt}": _profile(prefill, 2)}


def phase_serve(dev) -> tuple:
    """gemma3-12b at full width and depth, random weights drawn on the card:
    the launcher's mix through ArcusScheduler(use_kernel=True)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import module, transformer as T
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    model = T.init_model(SERVE_SEED, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gib = sum(p.numel() * p.element_size()
                      for p in model.parameters()) / 2**30
    run = _run_path("serve", model, dev, arch=SERVE_ARCH, max_batch=8,
                    max_len=256, mix="serve")
    prof = _profile_serving(model, dev)
    emit("serve", arch=SERVE_ARCH, n_layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab,
         params=module.param_count(model), weights_gib=weights_gib,
         init_s=init_s, max_batch=8, max_len=256, **_public(run),
         profile=prof)
    return model, run, prof


def phase_serve_long(dev, model) -> dict:
    """The same model over prompts longer than the 1024-token window: the
    prefill keeps the last 1024 positions in the local caches and decode
    wraps their rolling slots."""
    run = _run_path("serve_long", model, dev, arch=SERVE_ARCH,
                    max_batch=LONG_REQUESTS, max_len=2048, mix="long")
    if run["longest_sequence"] <= model.cfg.window:
        raise AssertionError(f"serve_long stayed inside the window: "
                             f"{run['longest_sequence']}")
    emit("serve_long", prompt=LONG_PROMPT, new_tokens=LONG_NEW,
         window=model.cfg.window, max_batch=LONG_REQUESTS, max_len=2048,
         **_public(run))
    return run


def _kernels_vs_plain(name, cut, dev, arch, long_prompt, max_rounds=2000,
                      same_inputs=False) -> dict:
    """Both mixes through the kernels and through their plain versions on
    ``cut``: the same tokens, equal stats and virtual time, and logits
    within one bf16 ulp of their scale (LOGIT_RTOL / LOGIT_ATOL) at every
    prefill and decode.  With ``same_inputs`` the logits of each call are
    held against the plain versions run on a copy of the cache that call
    started from (``_shadow_plain``), and the drift between the two
    independent runs is reported, not held: a model with a recurrent state
    carries any rounding difference forward, and two runs that differ only
    in the order of float32 sums drift apart at small logits."""
    import dataclasses
    import torch
    report = {}
    for mix, max_batch, max_len in (("serve", 8, 256),
                                    ("long", LONG_REQUESTS, 2048)):
        shadow = [] if same_inputs else None
        runs = [_run_path(f"{name}/{mix}", cut, dev, arch=arch,
                          max_batch=max_batch, max_len=max_len, mix=mix,
                          plain=plain, keep_logits=True,
                          long_prompt=long_prompt, max_rounds=max_rounds,
                          shadow=None if plain else shadow)
                for plain in (False, True)]
        (k, p) = runs
        kl, pl = k["rec"]["logits"], p["rec"]["logits"]
        if [a for a, _ in kl] != [b for b, _ in pl]:
            raise AssertionError(f"{name}/{mix}: call sequences differ")
        independent = [(kind, a, b) for (kind, a), (_, b) in zip(kl, pl)]
        row = dict(calls=len(kl))
        if same_inputs:
            row["max_abs_logit_diff"] = _logits_within(f"{name}/{mix}",
                                                       shadow)
            drift = [float((a.float() - b.float()).abs().max())
                     for _, a, b in independent]
            row["independent_runs"] = dict(
                max_abs_logit_diff=max(drift),
                calls_beyond_tol=sum(
                    bool(((a.float() - b.float()).abs() > LOGIT_ATOL
                          + LOGIT_RTOL * b.float().abs()).any())
                    for _, a, b in independent))
        else:
            row["max_abs_logit_diff"] = _logits_within(f"{name}/{mix}",
                                                       independent)
        ks, ps = k["sched"], p["sched"]
        toks = [r.generated for r in ks.all_reqs.values()] == \
            [r.generated for r in ps.all_reqs.values()]
        stats = all(dataclasses.asdict(ks.stats[t]) ==
                    dataclasses.asdict(ps.stats[t]) for t in ks.stats)
        if not (toks and stats and ks.now_s == ps.now_s):
            raise AssertionError(f"{name}/{mix}: tokens equal {toks}, "
                                 f"stats equal {stats}")
        report[mix] = dict(row, tokens_equal=toks, stats_equal=stats,
                           kernel_launches=k["launches"],
                           plain_launches=p["launches"])
        del runs, k, p, kl, pl, independent, shadow
        torch.cuda.empty_cache()
    return report


def phase_serve_parity(dev, model) -> None:
    """At full width and one period of depth, the decode graph against its
    eager body (``_decode_graph_parity``), then both mixes through the
    kernels and through their plain versions (``_kernels_vs_plain``)."""
    _decode_graph_parity(SERVE_ARCH, model, dev, PARITY_LAYERS)
    cut = model.first_layers(PARITY_LAYERS)
    report = _kernels_vs_plain("serve_parity", cut, dev, SERVE_ARCH,
                               LONG_PROMPT)
    emit("serve_parity", layers=PARITY_LAYERS, d_model=cut.cfg.d_model,
         logit_rtol=LOGIT_RTOL, logit_atol=LOGIT_ATOL, mixes=report)


# ---------------------------------------------------------------------------
# serving: mamba2-780m at full width
# ---------------------------------------------------------------------------


def phase_serve_mamba2(dev) -> tuple:
    """mamba2-780m at full width and depth, random weights drawn on the
    card: the launcher's mix through ArcusScheduler(use_kernel=True), every
    prefill through the SSD-scan kernel (48 launches), decode in plain
    torch."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import module, transformer as T
    cfg = get_config(MAMBA_ARCH)
    t0 = time.perf_counter()
    model = T.init_model(SERVE_SEED, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gib = sum(p.numel() * p.element_size()
                      for p in model.parameters()) / 2**30
    run = _run_path("serve_mamba2", model, dev, arch=MAMBA_ARCH, max_batch=8,
                    max_len=256, mix="serve", max_rounds=MAMBA_ROUNDS)
    prof = _profile_serving(model, dev, MAMBA_LONG_PROMPT)
    emit("serve_mamba2", arch=MAMBA_ARCH, n_layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab,
         params=module.param_count(model), weights_gib=weights_gib,
         init_s=init_s, max_batch=8, max_len=256, **_public(run),
         profile=prof)
    return model, run, prof


def phase_serve_mamba2_long(dev, model) -> dict:
    """The same model over four 2000-token prompts: each prefill's scan
    crosses 31 full chunks and a ragged one."""
    run = _run_path("serve_mamba2_long", model, dev, arch=MAMBA_ARCH,
                    max_batch=LONG_REQUESTS, max_len=2048, mix="long",
                    long_prompt=MAMBA_LONG_PROMPT, max_rounds=MAMBA_ROUNDS)
    if run["longest_sequence"] < MAMBA_LONG_PROMPT:
        raise AssertionError(f"serve_mamba2_long: longest sequence "
                             f"{run['longest_sequence']}")
    emit("serve_mamba2_long", prompt=MAMBA_LONG_PROMPT, new_tokens=LONG_NEW,
         max_batch=LONG_REQUESTS, max_len=2048, **_public(run))
    return run


def phase_serve_mamba2_parity(dev, model) -> None:
    """At full width and 4 layers, both mamba2 mixes through the SSD-scan
    kernel and through the plain scan (``_kernels_vs_plain``), the logits
    of each call held against the plain versions on the same cache; first
    the decode graph against its eager body (``_decode_graph_parity``)."""
    _decode_graph_parity(MAMBA_ARCH, model, dev, MAMBA_PARITY_LAYERS)
    cut = model.first_layers(MAMBA_PARITY_LAYERS)
    report = _kernels_vs_plain("serve_mamba2_parity", cut, dev, MAMBA_ARCH,
                               MAMBA_LONG_PROMPT, MAMBA_ROUNDS,
                               same_inputs=True)
    emit("serve_mamba2_parity", layers=MAMBA_PARITY_LAYERS,
         d_model=cut.cfg.d_model, logit_rtol=LOGIT_RTOL,
         logit_atol=LOGIT_ATOL, mixes=report)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 3
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_prefill import ops as fp_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.token_bucket import ops as tb_ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    t0 = time.perf_counter()
    seconds = _build.build_many([
        ("token_bucket", tb_ops._SRC), (da_ops.NAME, da_ops.SOURCE),
        (fp_ops.NAME, fp_ops.SOURCE), (ssd_ops.NAME, ssd_ops.SOURCE),
        (ssd_ops.TC_NAME, ssd_ops.TC_SOURCE)])
    emit("build", kernels=list(seconds), seconds=seconds,
         wall_s=time.perf_counter() - t0,
         ptxas={k: [ln.strip() for ln in v.splitlines()
                    if "registers" in ln or "spill" in ln]
                for k, v in _build.PTXAS_INFO.items()})
    k = phase_kernel(dev)
    gt = phase_kernel_grant_tick(dev)
    gtb = phase_kernel_grant_tick_batch(dev)
    da = phase_kernel_decode_attention(dev)
    fp = phase_kernel_flash_prefill(dev)
    ssd = phase_kernel_ssd_scan(dev)
    phase_interp(dev)
    main = phase_main_path(dev)
    phase_parity(dev)
    phase_graph_parity(dev)
    phase_batch_parity(dev)
    fig6 = phase_fig6_batch(dev)
    prof8 = phase_profile_batch8(dev)
    prof = phase_profile(dev)
    model, serve, _ = phase_serve(dev)
    long = phase_serve_long(dev, model)
    phase_serve_parity(dev, model)
    # the runs hold their schedulers, hence engines and weights: drop them
    serve, long = _public(serve), _public(long)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model, mserve, mprof = phase_serve_mamba2(dev)
    mlong = phase_serve_mamba2_long(dev, model)
    phase_serve_mamba2_parity(dev, model)
    n_ssd = model.cfg.layer_kinds().count("ssd")
    n_main = 2
    t = gt["times"][n_main]
    runs = dict(serve=serve, serve_long=long, serve_mamba2=mserve,
                serve_mamba2_long=mlong)
    by_path = {name: dict(main_path=0, **{p: r["launches"][name]
                                          for p, r in runs.items()})
               for name in serve["launches"]}
    # the token bucket's by kernel: the dataplane's grant ticks, the
    # serving scheduler's steps
    by_path["token_bucket"] = dict(
        main_path=main["by_path"], fig6_batch=fig6["by_path"],
        profile_batch8=prof8["by_path"],
        **{p: r["token_bucket_paths"] for p, r in runs.items()})
    tb_src = "src/repro_torch/kernels/token_bucket/csrc/token_bucket.cu"
    step = k["times"][n_main]
    rows = [{
        "name": "token_bucket", "route": "cuda", "source": tb_src,
        "sources": {"grant_tick": f"{tb_src}::tb_grant_tick_kernel",
                    "step": f"{tb_src}::tb_step_kernel"},
        "replaces": "src/repro/kernels/token_bucket/kernel.py:41",
        "launches": main["launches"],
        "max_abs_err": max(k["max_abs_err"], gt["max_abs_err"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "shape": f"grant tick: [{n_main}] flows, k_grant 4",
        "device_ms_per_launch": prof["tb_device_ms_per_launch"],
        "device_ms_per_launch_alone": t["device_ms"],
        "launch_floor_ms": prof["launch_floor_ms"],
        "grant_tick_times": {str(n): v for n, v in gt["times"].items()},
        "batched_fig6_config": [
            {k: r[k] for k in ("batch", "token_bucket_device_us_per_launch",
                               "device_kernels_per_tick",
                               "device_busy_us_per_tick", "us_per_tick")}
            for r in prof["batched"]],
        "step": dict(step, shape=f"[{n_main}] flows (admission call)"),
        "launches_by_path": by_path["token_bucket"]}, {
        # the same kernel launched over a grid of batch elements: its
        # numbers at fig6's batch size, its launches on fig6_batch
        "name": "token_bucket/grant_tick_batch", "route": "cuda",
        "source": f"{tb_src}::tb_grant_tick_kernel",
        "replaces": "src/repro/kernels/token_bucket/kernel.py:41",
        "launches": fig6["launches"], "max_abs_err": 0,
        **{k: gtb["times"][FIG6_B][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": f"grant tick over {FIG6_B} ragged elements "
                 f"({gtb['times'][FIG6_B]['flows']} flows), k_grant 4",
        "device_ms_per_launch": gtb["times"][FIG6_B]["device_ms"],
        "by_batch": {str(B): {k: v[k] for k in (
            "flows", "ms", "plain_ms", "device_ms", "bound_ms", "bound_by")}
            for B, v in gtb["times"].items()},
        "launches_by_path": dict(fig6_batch=fig6["launches"],
                                 profile_batch8=prof8["launches"])}]
    for name, res, src, rep, shape, run in (
            ("decode_attention", da,
             "src/repro_torch/kernels/decode_attention/csrc/"
             "decode_attention.cu",
             "src/repro/kernels/decode_attention/kernel.py:30",
             "q [8,16,256] bf16, k/v [8,256,8,256] f32, lengths 13..80",
             serve),
            ("flash_prefill", fp,
             "src/repro_torch/kernels/flash_prefill/csrc/flash_prefill.cu",
             "src/repro/kernels/flash_prefill/kernel.py:24",
             "q [1,64,16,256], k/v [1,64,8,256] bf16, window 1024", serve),
            ("ssd_scan", ssd,
             "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_tc.cu",
             "src/repro/kernels/ssd_scan/kernel.py:27",
             f"x [1,{MAMBA_LONG_PROMPT},48,64], B/C [1,{MAMBA_LONG_PROMPT},"
             "1,128] bf16, a f32", mserve)):
        m = res["main"]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": run["launches"][name],
            "max_abs_err": res["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "shape": shape, "launches_by_path": by_path[name]})
        if name == "decode_attention":
            rows[-1]["device_ms_per_launch"] = m["device_ms"]
            rows[-1]["bound_share"] = m["bound_share"]
            rows[-1]["plan"] = m["plan"]
            rows[-1]["long_cache"] = [
                {k: r[k] for k in ("shape", "lengths", "ms", "device_ms",
                                   "plain_ms", "library_ms", "bound_ms",
                                   "bound_by", "bound_share", "plan")}
                for r in res["long"]]
        if name == "flash_prefill":
            rows[-1]["kernel_paths"] = {
                p: r["flash_prefill_paths"] for p, r in (
                    ("serve", serve), ("serve_long", long))}
            rows[-1]["long_prompt"] = [
                {k: r[k] for k in ("shape", "window", "ms", "plain_ms",
                                   "library_ms", "library_causal_ms",
                                   "bound_ms", "bound_by", "bound_share",
                                   "tflops")} for r in res["long"]]
        if name == "ssd_scan":
            pre = mprof[f"prefill_{MAMBA_LONG_PROMPT}"]
            # one wrapper call (three kernels) a layer
            rows[-1]["device_ms_per_launch"] = \
                pre["device_ms_by_kind"].get("ssd_scan", 0.0) / n_ssd
            rows[-1]["kernel_paths"] = {
                p: r["ssd_scan_paths"] for p, r in (
                    ("serve_mamba2", mserve), ("serve_mamba2_long", mlong))}
            rows[-1]["prompts"] = [
                {k: r.get(k) for k in ("shape", "ms", "cuda_core_ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "bound_share")} for r in res["timed"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
