"""Short first call on the card for a changed SSD-scan kernel.

    PYTHONPATH=src python -m repro_torch.kernels.ssd_scan.rehearse
    PYTHONPATH=src python -m repro_torch.kernels.ssd_scan.rehearse --backward

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

``--backward`` does the same for training's kernels
(``csrc/ssd_scan_tc_bwd.cu`` for bf16 with N <= 128, ``csrc/ssd_scan_bwd.cu``
otherwise): ptxas's report of their kernels, then every ``BACKWARD_CASES``
row (``check_backward``: the forward writing S_prev, then the backward's
dx, da, dB and dC against ``ref.ssd_scan_chunked_backward`` with the
kernel's head slices on the same inputs and cotangents, at small L against
autograd of the sequential scan too, and two calls bitwise; ``chip_smoke.py``
and the card tests call it), then the times at mamba2-780m's training
shape [1, 4096, 48, 64], G = 1, N = 128 (``time_backward``: ms a call by
CUDA events, device ms by kernel, the slice count and workspace bytes, the
plain mirror's ms and the bound).
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

# Bsz, L, H, P, G, N, bf16, strong decay: the forward's card cases
# (tests/test_torch_cuda.py SSD_CASES: ragged chunks, G = 2 and 3, N = 256,
# L below one chunk), mamba2-780m's training shape and its reduced config's
# (float32), then strong decay (a^8 of a uniform: chunks that span more
# than 2^120, so the forward takes both decay forms) in both types
BACKWARD_CASES = [
    (2, 256, 4, 64, 1, 128, False, False),
    (1, 100, 3, 32, 1, 64, False, False),
    (2, 128, 8, 64, 2, 128, False, False),
    (1, 512, 4, 64, 1, 128, True, False),
    (1, 2000, 48, 64, 1, 128, True, False),
    (3, 77, 6, 40, 3, 256, False, False),
    (2, 300, 8, 64, 1, 128, True, False),
    (1, 300, 8, 64, 2, 256, True, False),
    (1, 64, 48, 64, 1, 128, True, False),
    (1, 4096, 48, 64, 1, 128, True, False),
    (2, 384, 16, 32, 1, 64, False, False),
    (1, 300, 4, 64, 2, 128, True, True),
    (1, 300, 4, 64, 2, 128, False, True),
    # the tensor-core backward's edges: P below one panel and not a
    # multiple of 8, N = 64 (one panel) and not a multiple of 8 (plain
    # loads), G = 3, a chunk of 1 token
    (2, 200, 6, 40, 3, 64, True, False),
    (1, 129, 4, 36, 2, 100, True, False),
]
# the head-slice kernel's edges (bf16): 30 heads in 8 slices on 132 SMs
# (slices that do not divide a group's heads), H = 48 and G = 1 at L = 257
# (a one-token last chunk) in several slices (24 on 132 SMs), and dy = 0
# with a nonzero d_state (the ninth field: u's share of d log a must be
# exactly zero, ``check_backward``)
SLICE_CASES = [
    (2, 1024, 30, 64, 1, 128, True, False),
    (1, 257, 48, 64, 1, 128, True, False),
    (1, 300, 8, 64, 1, 128, True, False, True),
]
BACKWARD_CASES += SLICE_CASES
#: the training shape of mamba2-780m (Bsz, L, H, P, G, N)
TRAIN_SHAPE = (1, 4096, 48, 64, 1, 128)
# the backward kernel against its mirror (max-abs error over the mirror's
# max-abs, per gradient): float32 computes the same float32 arithmetic in
# another summation order (and reads the CUDA-core forward's S_prev, made
# over chunks of 64); bf16 rounds each gradient to bf16 once and reads
# the tensor-core forward's bf16 S_prev, whose roundings the mirror's
# forward may flip: a few bf16 ulps, the forward's mirror limit
TOL_BWD_MIRROR = {False: 1e-4, True: 2e-2}
# against autograd of the sequential float32 scan (L <= 512 only: the
# sequential scan walks the tokens one by one): float32 as above; bf16
# carries the forward's bf16 roundings (x o w, M, S_prev), the forward's
# limit against the plain scan
TOL_BWD_PLAIN = {False: 1e-4, True: 1e-1}


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


def _profile(fn, calls: int = 20, launches: int = 0,
             attempts: int = 4) -> dict:
    """Device us a call by kernel (torch.profiler), and the host us a call
    takes to enqueue.  With ``launches`` (kernels a call), a trace that
    shows fewer than ``launches x calls`` kernels is taken again, up to
    ``attempts`` times (the profiler's traces drop kernels, more of them
    the more windows a process traced before), and the fullest is used;
    ``complete`` says whether it showed them all."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    events = []
    for _ in range(attempts if launches else 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        got = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        events = max(events, got, key=len)
        if len(events) >= launches * calls:
            break
    dev = collections.defaultdict(float)
    for e in events:
        name = next((k for k in ("bwd_chunk", "bwd_state_pass", "bwd_head",
                                 "bwd_dcb_sum", "bwd_group", "tcb_chunk",
                                 "tcb_state_pass", "tcb_head_slice",
                                 "tcb_group", "chunk", "state_pass",
                                 "output")
                     if k in e.name), e.name[:40])
        dev[name] += e.time_range.elapsed_us() / calls
    return dict(host_us_per_call=host_us, device_us_per_call=dict(dev),
                complete=len(events) >= launches * calls)


def backward_inputs(case, dev, seed: int = 0):
    """(x, a, B, C, dy, d_state) of a ``BACKWARD_CASES`` row on ``dev``,
    from a seeded generator: d_state nonzero; dy zero where the row's
    ninth field says so."""
    import torch
    Bz, L, H, P, G, N, bf16, strong = case[:8]
    dt = torch.bfloat16 if bf16 else torch.float32
    g = torch.Generator(device=dev).manual_seed(seed + L + 7 * N)
    x = (0.5 * torch.randn((Bz, L, H, P), generator=g, device=dev)).to(dt)
    a = 0.7 + 0.299 * torch.rand((Bz, L, H), generator=g, device=dev)
    if strong:
        a = torch.rand((Bz, L, H), generator=g, device=dev) ** 8
    B = (0.3 * torch.randn((Bz, L, G, N), generator=g, device=dev)).to(dt)
    C = (0.3 * torch.randn((Bz, L, G, N), generator=g, device=dev)).to(dt)
    dy = torch.randn((Bz, L, H, P), generator=g, device=dev).to(dt)
    ds = 0.1 * torch.randn((Bz, H, P, N), generator=g, device=dev)
    if case[8:9] == (True,):
        dy = torch.zeros_like(dy)
    return x, a, B, C, dy, ds


def _sequential_grads(x, a, B, C, dy, ds):
    """Autograd of the sequential plain scan on the same inputs."""
    import torch
    from repro_torch.kernels.ssd_scan import ref
    ins = [t.detach().clone().requires_grad_(True) for t in (x, a, B, C)]
    with torch.enable_grad():
        y, s = ref.ssd_scan(*ins)
        torch.autograd.backward((y, s), (dy, ds))
    return [t.grad for t in ins]


def check_backward(case, dev, seed: int = 0) -> dict:
    """One ``BACKWARD_CASES`` row on the card: the forward kernel writing
    S_prev, the backward kernel's (dx, da, dB, dC) against
    ``ref.ssd_scan_chunked_backward`` with its rounding points on the same
    inputs and cotangents (and, at L <= 512, against autograd of the
    sequential scan; on the tensor-core path against the CUDA-core kernel
    on the same bf16 inputs too, within the mirror's limit), and a second
    call bitwise equal to the first.  A row whose ninth field is True has
    dy = 0: then R and u, d log a's terms that carry dy, are exactly zero,
    so dx and da equal, bit for bit, a call with C = 0 (which makes C
    S_prev^T, and so u, zero whatever the kernel reads; nothing else
    depends on C when dy = 0).  Returns the errors (max-abs error over the
    reference's max-abs, per gradient) and raises past the tolerances."""
    import torch
    from repro_torch.kernels.ssd_scan import ops, ref
    x, a, B, C, dy, ds = backward_inputs(case, dev, seed)
    bf16 = case[6]
    before = dict(ops.LAUNCHES_BY_PATH)
    _, _, sp = ops._kernel_forward(x, a, B, C, keep_sprev=True)
    got = ops.ssd_scan_backward(x, a, B, C, sp, dy, ds)
    _finish_or_exit(f"backward {case}")
    again = ops.ssd_scan_backward(x, a, B, C, sp, dy, ds)
    path = ops.kernel_path(x.dtype, B.dtype)
    bpath = ops.backward_path(x.dtype, B.dtype, case[3], case[5])
    tc = bpath == "tensor_core"
    slices = ops.tc_backward_slices(case[0], case[1], case[2], case[4],
                                    dev) if tc else 1
    want = ref.ssd_scan_chunked_backward(x, a, B, C, dy, ds, tensor_core=tc,
                                         slices=slices)
    torch.cuda.synchronize()
    names = ("dx", "da", "dB", "dC")
    launched = {k: ops.LAUNCHES_BY_PATH[k] - before[k] for k in before}
    row = dict(case=list(case), path=path, backward_path=bpath,
               slices=slices, heads_per_group=case[2] // case[4],
               launches_ok=launched == {
                   **{k: 0 for k in before}, path: 1,
                   "backward_" + bpath: 2 * ops.BACKWARD_LAUNCHES[bpath]},
               finite=all(bool(torch.isfinite(t.float()).all())
                          for t in got),
               bitwise=all(torch.equal(u, v) for u, v in zip(got, again)),
               mirror={n: _rel(u, v) for n, u, v in zip(names, got, want)},
               max_abs_err=max(float((u.float() - v.float()).abs().max())
                               for u, v in zip(got, want)))
    if case[8:9] == (True,):
        zc = ops.ssd_scan_backward(x, a, B, torch.zeros_like(C), sp, dy, ds)
        row["zero_dy_exact"] = torch.equal(got[0], zc[0]) and \
            torch.equal(got[1], zc[1])
    if case[1] <= 512:
        plain = _sequential_grads(x, a, B, C, dy, ds)
        row["plain"] = {n: _rel(u, v) for n, u, v in zip(names, got, plain)}
    if bpath == "tensor_core":
        # the CUDA-core backward on the same bf16 inputs: a second check
        path_of = ops.backward_path
        ops.backward_path = lambda *_: "cuda_core"
        try:
            cc = ops.ssd_scan_backward(x, a, B, C, sp, dy, ds)
        finally:
            ops.backward_path = path_of
        row["cuda_core"] = {n: _rel(u, v) for n, u, v in zip(names, got, cc)}
    bad = [k for k in ("launches_ok", "finite", "bitwise", "zero_dy_exact")
           if not row.get(k, True)]
    bad += [f"cuda_core {n}" for n, e in row.get("cuda_core", {}).items()
            if not e <= TOL_BWD_MIRROR[bf16]]
    bad += [f"mirror {n}" for n, e in row["mirror"].items()
            if not e <= TOL_BWD_MIRROR[bf16]]
    bad += [f"plain {n}" for n, e in row.get("plain", {}).items()
            if not e <= TOL_BWD_PLAIN[bf16]]
    if bad:
        raise AssertionError(f"ssd_scan backward {case}: {bad} {row}")
    return row


def backward_bound(shape, bf16: bool = True) -> dict:
    """The least time the card could take for the SSD-scan gradient at
    ``shape`` (Bsz, L, H, P, G, N): each input (x, a, B, C, dy, d_state,
    the saved S_prev) read once and each gradient written once, over
    3.35 TB/s; the products of the chunked gradient (per head and chunk of
    128: dy x^T and M^T dy, Q^2 P each; B dS^T, the chunk-local state
    gradient, C S_prev^T, e dy S_prev and w x dS, Q P N each; per group:
    C B^T and the two (dy x^T)-weighted products for dC and dB, Q^2 N
    each), at 2 flops a multiply-add, over the bf16 dense peak of
    989 TFLOP/s (67 TFLOP/s for float32 operands)."""
    Bz, L, H, P, G, N = shape
    Q = 128
    nc = -(-L // Q)
    e = 2 if bf16 else 4
    nbytes = (3 * Bz * L * H * P * e              # x, dy; dx
              + 2 * Bz * L * H * 4                # a; da
              + 4 * Bz * L * G * N * e            # B, C; dB, dC
              + Bz * H * P * N * 4                # d_state
              + Bz * nc * H * P * N * e)          # S_prev
    flops = 2 * Bz * nc * (H * (2 * Q * Q * P + 5 * Q * P * N)
                           + G * 3 * Q * Q * N)
    peak = 989e12 if bf16 else 67e12
    bytes_ms, flops_ms = nbytes / 3.35e12 * 1e3, flops / peak * 1e3
    return dict(bytes=nbytes, flops=flops, bytes_ms=bytes_ms,
                flops_ms=flops_ms, bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations")


def time_backward(dev, shape=TRAIN_SHAPE, plain: bool = True) -> dict:
    """The backward at ``shape`` in bf16: ms a call (CUDA events), device
    ms by kernel a call (``torch.profiler``; ``profile_complete`` says
    whether its trace showed every launch), the head-slice launch's slice
    count and the workspace bytes, the same for the CUDA-core backward on
    the same inputs, the forward writing S_prev, the plain mirror's ms
    (``plain``), the bound and its share of ``ms``."""
    import torch
    from repro_torch.kernels.ssd_scan import ops, ref
    x, a, B, C, dy, ds = backward_inputs(shape + (True, False), dev)
    _, _, sp = ops._kernel_forward(x, a, B, C, keep_sprev=True)
    run = (lambda: ops.ssd_scan_backward(x, a, B, C, sp, dy, ds))
    out = dict(shape=list(shape), ms=_time_ms(run),
               forward_with_sprev_ms=_time_ms(
                   lambda: ops._kernel_forward(x, a, B, C, keep_sprev=True)),
               forward_ms=_time_ms(lambda: ops._kernel_forward(x, a, B, C)))
    out["path"] = path = ops.backward_path(x.dtype, B.dtype, shape[3],
                                           shape[5])
    Bz, L, H, P, G, N = shape
    out["slices"] = ops.tc_backward_slices(Bz, L, H, G, dev)
    out["workspace_bytes"] = ops._WORKSPACE[
        ("backward_" + path, Bz, L, H, P, G, N, out["slices"])]
    n = ops.BACKWARD_LAUNCHES[path]
    prof = _profile(run, calls=5, launches=n)
    out["device_ms_by_kernel"] = {
        k: v / 1e3 for k, v in prof["device_us_per_call"].items()}
    out["device_ms"] = sum(out["device_ms_by_kernel"].values())
    out["profile_complete"] = prof["complete"]
    # the CUDA-core backward on the same bf16 inputs, in the same run
    path_of = ops.backward_path
    ops.backward_path = lambda *_: "cuda_core"
    try:
        out["cuda_core_ms"] = _time_ms(run)
        out["cuda_core_device_ms"] = sum(_profile(
            run, calls=5, launches=ops.BACKWARD_LAUNCHES["cuda_core"])[
                "device_us_per_call"].values()) / 1e3
    finally:
        ops.backward_path = path_of
    if plain:
        out["plain_ms"] = _time_ms(lambda: ref.ssd_scan_chunked_backward(
            x, a, B, C, dy, ds, tensor_core=out["path"] == "tensor_core",
            slices=out["slices"]), iters=2)
    out.update(backward_bound(shape))
    # back-to-back calls keep the card busy at this size, so the CUDA-event
    # ms a call is device time (a profiler trace may drop kernels)
    out["bound_share"] = out["bound_ms"] / out["ms"]
    return out


def main_backward() -> int:
    import time

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ops
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
    for lib in (ops.TC_BWD_NAME, ops.BWD_NAME):
        info = _build.PTXAS_INFO.get(lib, "").splitlines()
        notes = [ln for ln in info if "(C7" in ln]
        print(lib, "ptxas notes", notes[:5])
        for i, ln in enumerate(info):
            if "Function properties" in ln and ("bwd_" in ln or "tcb_" in ln):
                print(" ".join(x.strip() for x in info[i:i + 3]), flush=True)
    dev = torch.device("cuda", 0)
    failed = 0
    for case in BACKWARD_CASES:
        try:
            print(check_backward(case, dev), flush=True)
        except AssertionError as e:
            failed += 1
            print("FAILED", e, flush=True)
    print("time", time_backward(dev), flush=True)
    return 1 if failed else 0


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
           y.data_ptr(), st.data_ptr(), None, 1, x.shape[1], 48, 64, 1, 128,
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
    sys.exit(main_backward() if "--backward" in sys.argv[1:] else main())
