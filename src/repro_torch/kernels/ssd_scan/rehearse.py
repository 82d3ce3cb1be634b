"""Short first call on the card for a changed SSD-scan kernel.

    PYTHONPATH=src python -m repro_torch.kernels.ssd_scan.rehearse

Builds both kernel libraries, prints ptxas's registers, spills and ``C75xx``
notes for the tensor-core kernels, runs each bf16 case once under a
watchdog (a kernel that deadlocks ends the process after 20 s instead of
holding the card) against the sequential plain version (limit 1e-1 of the
output's max-abs, the JAX test's) and the chunked CPU mirror
``ref.ssd_scan_chunked`` run on the card (limit 2e-2: the same rounding
points, so only float32 summation order and the bf16 roundings it flips
differ), checks each call's path, times mamba2-780m's 2000-, 64- and
12-token prefills against the CUDA-core kernel on the same bf16 inputs,
and profiles the three launches of the 2000- and 64-token calls.  Exits
non-zero on a build failure, a hang or an
error past a limit.  ``chip_smoke.py`` is the full check; this is the
rehearsal before it.
"""
from __future__ import annotations

import collections
import sys

from repro_torch.kernels.flash_prefill.rehearse import _finish_or_exit, \
    _time_ms

# Bsz, L, H, P, G, N, strong decay: mamba2-780m's prefills (2000, 64 and
# 12 tokens), then the kernel's edges: the JAX tests' shapes, Bsz = 2 with
# G = 2 and N = 256, P below and above one 64-column tile, N and P that are
# not multiples of 8 (plain loads), L = 0 and 1, strong decay
CASES = [
    (1, 2000, 48, 64, 1, 128, False),
    (1, 64, 48, 64, 1, 128, False),
    (1, 12, 48, 64, 1, 128, False),
    (1, 512, 4, 64, 1, 128, False),
    (2, 256, 4, 64, 1, 128, False),
    (2, 300, 8, 64, 2, 256, False),
    (1, 100, 3, 32, 1, 64, False),
    (1, 129, 4, 80, 2, 64, False),
    (1, 77, 6, 40, 3, 20, False),
    (1, 50, 2, 33, 1, 128, False),
    (3, 200, 6, 64, 3, 256, False),
    (1, 0, 4, 64, 1, 128, False),
    (1, 1, 4, 64, 1, 128, False),
    (1, 300, 4, 64, 2, 128, True),
]
TOL_PLAIN = 1e-1
TOL_MIRROR = 2e-2


def _inputs(case, dev):
    import torch
    Bz, L, H, P, G, N, strong = case
    g = torch.Generator(device=dev).manual_seed(L + 7 * N)
    x = (0.5 * torch.randn((Bz, L, H, P), generator=g, device=dev)
         ).bfloat16()
    a = 0.7 + 0.299 * torch.rand((Bz, L, H), generator=g, device=dev)
    if strong:
        a = torch.rand((Bz, L, H), generator=g, device=dev) ** 8
    B = (0.3 * torch.randn((Bz, L, G, N), generator=g, device=dev)
         ).bfloat16()
    C = (0.3 * torch.randn((Bz, L, G, N), generator=g, device=dev)
         ).bfloat16()
    return x, a, B, C


def _rel(got, want) -> float:
    want = want.float()
    if not want.numel():
        return 0.0
    return float((got.float() - want).abs().max()
                 / (want.abs().max() + 1e-9))


def _profile(fn, calls: int = 20) -> dict:
    """Device us a call by kernel (torch.profiler), and the host us a call
    takes to enqueue."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = next((k for k in ("chunk", "state_pass", "output")
                         if k in e.name), e.name[:40])
            dev[name] += e.time_range.elapsed_us() / calls
    return dict(host_us_per_call=host_us, device_us_per_call=dict(dev))


def main() -> int:
    import time

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ops, ref
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
    info = _build.PTXAS_INFO.get(ops.TC_NAME, "").splitlines()
    notes = [ln for ln in info if "(C7" in ln]
    print("ptxas notes", dict(collections.Counter(
        ln.split(")")[0].split("(")[-1] for ln in notes)), notes[:3])
    for i, ln in enumerate(info):
        if "Function properties" in ln and "ssd_" in ln:
            print(" ".join(x.strip() for x in info[i:i + 3]), flush=True)
    dev = torch.device("cuda", 0)
    worst = dict(plain=0.0, mirror=0.0)
    for case in CASES:
        x, a, B, C = _inputs(case, dev)
        by_path = dict(ops.LAUNCHES_BY_PATH)
        y, s = ops.ssd_scan(x, a, B, C)
        _finish_or_exit(str(case))
        by_path["tensor_core"] += 1
        yr, sr = ops.ssd_scan_plain(x, a, B, C)
        ym, sm = ref.ssd_scan_chunked(x, a, B, C)
        row = dict(case=case, path_ok=ops.LAUNCHES_BY_PATH == by_path,
                   finite=bool(torch.isfinite(y.float()).all()
                               and torch.isfinite(s).all()),
                   plain=(_rel(y, yr), _rel(s, sr)),
                   mirror=(_rel(y, ym), _rel(s, sm)))
        worst["plain"] = max(worst["plain"], *row["plain"])
        worst["mirror"] = max(worst["mirror"], *row["mirror"])
        if not (row["path_ok"] and row["finite"]):
            worst["plain"] = float("inf")
        print(row, flush=True)
    x, a, B, C = _inputs(CASES[0], dev)
    cc = ops._launchers()[2]

    def old():
        y = torch.empty_like(x)
        st = torch.empty((1, 48, 64, 128), dtype=torch.float32, device=dev)
        cc(1, 1, x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
           y.data_ptr(), st.data_ptr(), 1, x.shape[1], 48, 64, 1, 128,
           torch.cuda.current_stream(dev).cuda_stream)
    times = {"cuda_core": _time_ms(old),
             "tensor_core": _time_ms(lambda: ops.ssd_scan(x, a, B, C))}
    times["tensor_core again"] = _time_ms(lambda: ops.ssd_scan(x, a, B, C))
    times["cuda_core again"] = _time_ms(old)
    for n in (64, 12):
        xs, as_, Bs, Cs = (v[:, :n].contiguous() for v in (x, a, B, C))
        times[f"tensor_core L={n}"] = _time_ms(
            lambda: ops.ssd_scan(xs, as_, Bs, Cs))
    print("ms at [1, 2000, 48, 64] bf16:", times, flush=True)
    for n in (2000, 64):
        xs, as_, Bs, Cs = (v[:, :n].contiguous() for v in (x, a, B, C))
        print(f"L={n}:", _profile(lambda: ops.ssd_scan(xs, as_, Bs, Cs)),
              flush=True)
    print(f"worst error: plain {worst['plain']} (limit {TOL_PLAIN}), mirror "
          f"{worst['mirror']} (limit {TOL_MIRROR})", flush=True)
    return 0 if worst["plain"] < TOL_PLAIN and \
        worst["mirror"] < TOL_MIRROR else 1


if __name__ == "__main__":
    sys.exit(main())
