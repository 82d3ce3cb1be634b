"""Short first call on the card for a changed flash-prefill kernel.

    PYTHONPATH=src python -m repro_torch.kernels.flash_prefill.rehearse

Builds the kernels, prints ptxas's registers, spills and warnings for the
tensor-core kernel, runs each bf16 case once against the plain version
under a watchdog (a kernel that deadlocks ends the process after 20 s
instead of holding the card), and times gemma3-12b's 1536-token prefill
against ``scaled_dot_product_attention`` with the mask and with
``is_causal``.  Exits non-zero on a build failure, a hang or an error past
2e-2.  ``chip_smoke.py`` is the full check; this is the rehearsal before
it.
"""
from __future__ import annotations

import collections
import os
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
    info = _build.PTXAS_INFO.get(ops.NAME, "").splitlines()
    notes = [ln for ln in info if "(C7" in ln]
    print("ptxas notes", dict(collections.Counter(
        ln.split(")")[0].split("(")[-1] for ln in notes)), notes[:2])
    for i, ln in enumerate(info):
        if "flash_prefill_tc_kernel" in ln and "Function properties" in ln:
            print(" ".join(x.strip() for x in info[i:i + 3]), flush=True)
    dev = torch.device("cuda", 0)
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
