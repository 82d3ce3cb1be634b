"""Short first call on the card for a changed flash-prefill kernel.

    PYTHONPATH=src python -m repro_torch.kernels.flash_prefill.rehearse
    PYTHONPATH=src python -m repro_torch.kernels.flash_prefill.rehearse \
        --backward

Builds the kernels, prints ptxas's registers, spills and warnings for the
tensor-core kernel, runs each bf16 case once against the plain version
under a watchdog (a kernel that deadlocks ends the process after 20 s
instead of holding the card), and times gemma3-12b's 1536-token prefill
against ``scaled_dot_product_attention`` with the mask and with
``is_causal``.  Exits non-zero on a build failure, a hang or an error past
2e-2.  ``chip_smoke.py`` is the full check; this is the rehearsal before
it.

``--backward`` does the same for training's kernels: the forward's LSE
output (both kernels) and the backward kernel's dq, dk and dv against the
plain versions on the same inputs at ``BACKWARD_CASES`` (``check_backward``
and ``check_deterministic``, which ``chip_smoke.py`` and the card tests
call too), and times the backward at starcoder2-3b's 4096-token shape
(on its tensor-core kernels and on the CUDA-core ones) and at
gemma3-12b's, with the device ms of each kernel, and at other head
slicings of the dK / dV launch than ``ops.dkdv_splits`` picks.
"""
from __future__ import annotations

import collections
import os
import re
import sys
import time

# B, S, H, KvH, D, window, chunk, causal[, Sk]: gemma3-12b's prefills, then
# the kernel's edges (tile and panel boundaries, G = 1 .. 8 and 5, D
# padded), then non-causal rows over Sk keys (cross-attention to a memory:
# llama-3.2-vision-11b's 1600 rows, seamless-m4t-medium's 1024 and its
# encoder, 16 rows below one tile, Sk = 1000 not a multiple of it)
CASES = [
    (1, 1536, 16, 8, 256, 1024, 0, True),
    (1, 1536, 16, 8, 256, 0, 0, True),
    (1, 1536, 16, 8, 256, 0, 512, True),
    (1, 12, 16, 8, 256, 1024, 0, True),
    (1, 64, 16, 8, 256, 1024, 0, True),
    (1, 300, 16, 8, 256, 100, 0, True),
    (2, 65, 8, 2, 64, 0, 0, True),
    (1, 129, 4, 1, 80, 0, 0, True),
    (1, 63, 8, 8, 128, 0, 0, True),
    (1, 1, 8, 2, 128, 0, 0, True),
    (1, 300, 8, 2, 64, 0, 50, True),
    (1, 300, 8, 2, 64, 37, 0, True),
    (1, 200, 12, 4, 128, 0, 0, False),
    (1, 100, 10, 2, 72, 0, 0, True),
    (1, 70, 6, 1, 36, 0, 0, True),
    (1, 90, 4, 2, 96, 0, 0, True),
    (2, 77, 6, 3, 200, 20, 0, True),
    (1, 1536, 40, 8, 128, 0, 0, True),
    (1, 12, 32, 8, 128, 0, 0, False, 1600),
    (1, 1536, 32, 8, 128, 0, 0, False, 1600),
    (1, 1536, 16, 16, 64, 0, 0, False, 1024),
    (1, 1024, 16, 16, 64, 0, 0, False, 1024),
    (2, 40, 4, 1, 64, 0, 0, False, 16),
    (1, 300, 8, 2, 128, 0, 0, False, 1000),
]
TIMED = 3           # the first three: gemma3-12b's 1536-token prefill
TOL = 2e-2

# B, Sq, H, KvH, D, window, chunk, causal, Sk, dtype: training's attention
# shapes (starcoder2-3b at 4096 tokens, G = 12, window 4096; gemma3-12b's
# local layers; a chunked mask; a ragged 1000; seamless-m4t-medium's
# encoder, G = 1, D 64; a cross case with Sq != Sk; float32, the reduced
# configs' type), then the edges: rows that reach no key (Sq > Sk + window:
# LSE -inf and no gradient), D not a multiple of 8, G = 5; then the
# tensor-core design's edges in bf16: D 256 (column halves) off gemma3's
# shape with a window and a ragged length, D 80 and D 200 (zero columns
# from TMA's fill), G = 5 cut into head slices of 1, 2 and 2
# (``ops.dkdv_splits`` picks 3 at 27 key blocks of one query tile), B = 2,
# rows that reach no key, a chunk that is not a multiple of a tile
BACKWARD_CASES = [
    (1, 4096, 24, 2, 128, 4096, 0, True, 4096, "bfloat16"),
    (1, 1536, 16, 8, 256, 1024, 0, True, 1536, "bfloat16"),
    (1, 300, 8, 2, 64, 0, 50, True, 300, "bfloat16"),
    (1, 1000, 8, 2, 128, 0, 0, True, 1000, "bfloat16"),
    (1, 1024, 16, 16, 64, 0, 0, False, 1024, "bfloat16"),
    (1, 300, 8, 2, 128, 0, 0, False, 1000, "bfloat16"),
    (2, 200, 4, 2, 64, 64, 0, True, 200, "float32"),
    (1, 100, 4, 2, 64, 16, 0, True, 40, "float32"),
    (1, 77, 10, 2, 36, 0, 0, True, 77, "float32"),
    (1, 300, 8, 2, 256, 100, 0, True, 300, "bfloat16"),
    (1, 129, 4, 1, 80, 0, 0, True, 129, "bfloat16"),
    (1, 150, 6, 3, 200, 40, 0, True, 150, "bfloat16"),
    (1, 64, 10, 2, 64, 0, 0, False, 3456, "bfloat16"),
    (2, 200, 8, 2, 128, 64, 0, True, 200, "bfloat16"),
    (1, 100, 4, 2, 64, 16, 0, True, 40, "bfloat16"),
    (1, 400, 8, 4, 128, 0, 96, True, 400, "bfloat16"),
]
#: the forward's LSE against the plain one, by operand type (the
#: tensor-core kernel sums bf16-rounded probabilities); the gradients'
#: max-abs error as a share of the plain gradient's max-abs (bf16: about
#: one bf16 rounding of the largest entry; float32: summation order)
LSE_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
GRAD_RTOL = {"bfloat16": 1e-2, "float32": 1e-4}


def backward_inputs(case, dev, seed: int):
    """(q, k, v, do, kwargs) of a ``BACKWARD_CASES`` row, seeded."""
    import torch
    B, Sq, H, KvH, D, w, ck, causal, Sk, dn = case
    dt = getattr(torch, dn)
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((B, rows, h, D), generator=g, device=dev)
                   .to(dt) for rows, h in ((Sq, H), (Sk, KvH), (Sk, KvH),
                                            (Sq, H)))
    return q, k, v, do, dict(window=w, chunk_size=ck, causal=causal)


def check_backward(case, dev, seed: int) -> dict:
    """One ``BACKWARD_CASES`` row on the card: the forward kernel's output
    and LSE against ``flash_prefill_lse_plain``, then the backward kernel
    against ``flash_backward_plain`` on the same (q, k, v, o, lse, do).
    Returns the errors (``lse_err``; ``dq`` / ``dk`` / ``dv``: max-abs
    error over the plain gradient's max-abs; ``max_abs_err`` of each) and
    raises past the tolerances."""
    import torch
    from repro_torch.kernels.flash_prefill import ops
    q, k, v, do, kw = backward_inputs(case, dev, seed)
    dn = case[-1]
    o, lse = ops.flash_prefill_lse(q, k, v, **kw)
    o_p, lse_p = ops.flash_prefill_lse_plain(q, k, v, **kw)
    got = ops.flash_backward(q, k, v, o, lse, do, **kw)
    want = ops.flash_backward_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    finite = torch.isfinite(lse_p)
    row = dict(case=list(case), out_err=float((o.float() - o_p.float())
                                              .abs().max()),
               lse_err=float((lse - lse_p)[finite].abs().max())
               if finite.any() else 0.0,
               empty_rows=int((~finite).sum()),
               empty_rows_match=bool(torch.equal(torch.isfinite(lse),
                                                 finite)))
    row["max_abs_err"] = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = float((a.float() - b.float()).abs().max())
        row["max_abs_err"][name] = err
        row[name] = err / max(float(b.float().abs().max()), 1e-30)
        if a.dtype != b.dtype:
            raise AssertionError(f"flash_backward {name} dtype {a.dtype}")
    if row["empty_rows"]:
        # a row that reaches no key: zero output, zero dq
        rows = (~finite).transpose(1, 2)              # [B, Sq, H]
        row["empty_rows_zero"] = bool(
            (got[0][rows] == 0).all() and (o[rows] == 0).all())
    bad = (row["lse_err"] > LSE_TOL[dn] or row["out_err"] > TOL
           or not row["empty_rows_match"]
           or not row.get("empty_rows_zero", True)
           or max(row["dq"], row["dk"], row["dv"]) > GRAD_RTOL[dn])
    row["tol"] = dict(lse=LSE_TOL[dn], out=TOL, grad_rel=GRAD_RTOL[dn])
    if bad:
        raise AssertionError(f"flash backward != plain: {row}")
    return row


def check_deterministic(case, dev, seed: int) -> bool:
    """Two backward calls on the same inputs of a ``BACKWARD_CASES`` row
    give bitwise-equal dq, dk and dv (the tensor-core kernels sum in a
    fixed order, without atomics); raises otherwise."""
    import torch
    from repro_torch.kernels.flash_prefill import ops
    q, k, v, do, kw = backward_inputs(case, dev, seed)
    o, lse = ops.flash_prefill_lse(q, k, v, **kw)
    first = ops.flash_backward(q, k, v, o, lse, do, **kw)
    second = ops.flash_backward(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        if not torch.equal(a, b):
            raise AssertionError(f"flash_backward {case}: two calls give "
                                 f"different {name}")
    return True


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


def _time_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
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


def _device_ms_by_kernel(fn, calls: int = 5) -> dict:
    """Device ms a call of each kernel ``fn`` launches (``torch.profiler``
    over ``calls`` calls), by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            found = re.search(r"flash_\w+(<[^>]*>)?", e.name)
            name = found.group(0) if found else e.name[:60]
            by_name[name] = by_name.get(name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / calls
    return by_name


def backward_main(dev) -> int:
    """``--backward``: every ``BACKWARD_CASES`` row under the watchdog (and
    two calls of each bf16 row bitwise equal), then the backward's time and
    device ms by kernel at the first two rows' shapes (starcoder2-3b's and
    gemma3-12b's), at the first the CUDA-core kernels' time, and at both
    the time at other head slicings of the dK / dV launch."""
    from repro_torch.kernels.flash_prefill import ops
    for n, case in enumerate(BACKWARD_CASES):
        q, k, v, do, kw = backward_inputs(case, dev, n)
        ops.flash_backward(q, k, v, *ops.flash_prefill_lse(q, k, v, **kw),
                           do, **kw)
        _finish_or_exit(str(case))
        try:
            row = check_backward(case, dev, n)
            if case[-1] == "bfloat16":
                row["deterministic"] = check_deterministic(case, dev, n)
            print(row, flush=True)
        except AssertionError as e:
            print(f"FAILED {e}", flush=True)
            return 1
    for n in (0, 1):
        q, k, v, do, kw = backward_inputs(BACKWARD_CASES[n], dev, n)
        o, lse = ops.flash_prefill_lse(q, k, v, **kw)

        def call():
            return ops.flash_backward(q, k, v, o, lse, do, **kw)
        row = dict(case=BACKWARD_CASES[n], ms=_time_ms(call, iters=10),
                   device_ms_by_kernel=_device_ms_by_kernel(call),
                   forward_lse_ms=_time_ms(
                       lambda: ops.flash_prefill_lse(q, k, v, **kw)))
        if n == 0:
            path = ops.backward_path
            ops.backward_path = lambda *_: "cuda_core"
            try:
                row["cuda_core_ms"] = _time_ms(call, iters=3)
            finally:
                ops.backward_path = path
        print("backward", row, flush=True)
        # the dK / dV launch at other head slicings than dkdv_splits's
        G = BACKWARD_CASES[n][2] // BACKWARD_CASES[n][3]
        chosen = ops.dkdv_splits
        try:
            for s in sorted({1, 2, 3, 4, 6, G} & set(range(1, G + 1))):
                ops.dkdv_splits = lambda *_, s=s, **__: s
                print("  splits", s, dict(
                    ms=_time_ms(call, iters=10),
                    device_ms_by_kernel=_device_ms_by_kernel(call)),
                    flush=True)
        finally:
            ops.dkdv_splits = chosen
    return 0


def main() -> int:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_prefill import ops
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
    for name in (ops.NAME, ops.BWD_NAME):
        info = _build.PTXAS_INFO.get(name, "").splitlines()
        notes = [ln for ln in info if "(C7" in ln]
        print(name, "ptxas notes", dict(collections.Counter(
            ln.split(")")[0].split("(")[-1] for ln in notes)), notes[:2])
        for i, ln in enumerate(info):
            if "Function properties" in ln and (
                    "flash_prefill_tc_kernel" in ln or "backward" in ln):
                print(" ".join(x.strip() for x in info[i:i + 3]), flush=True)
    dev = torch.device("cuda", 0)
    if "--backward" in sys.argv[1:]:
        return backward_main(dev)
    worst = 0.0
    for n, (B, S, H, KvH, D, w, ck, causal, *sk) in enumerate(CASES):
        g = torch.Generator(device=dev).manual_seed(S)
        Sk = sk[0] if sk else S
        q, k, v = (torch.randn((B, rows, h, D), generator=g, device=dev)
                   .to(torch.bfloat16)
                   for rows, h in ((S, H), (Sk, KvH), (Sk, KvH)))
        kw = dict(window=w, chunk_size=ck, causal=causal)
        got = ops.flash_prefill(q, k, v, **kw)
        _finish_or_exit(str((B, S, H, KvH, D)))
        err = float((got.float() - ops.flash_prefill_plain(q, k, v, **kw)
                     .float()).abs().max())
        worst = max(worst, err)
        row = dict(case=(B, S, H, KvH, D, w, ck, causal, Sk), max_abs_err=err,
                   paths=dict(ops.LAUNCHES_BY_PATH))
        if n < TIMED:
            qi = torch.arange(S, device=dev)[:, None]
            ki = torch.arange(S, device=dev)[None, :]
            mask = qi >= ki
            if w:
                mask &= qi - ki < w
            if ck:
                mask &= qi // ck == ki // ck
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row["ms"] = _time_ms(lambda: ops.flash_prefill(q, k, v, **kw))
            row["sdpa_mask_ms"] = _time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True))
            row["sdpa_is_causal_ms"] = _time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
        print(row, flush=True)
    print(f"worst error {worst} (limit {TOL})", flush=True)
    return 0 if worst < TOL else 1


if __name__ == "__main__":
    sys.exit(main())
