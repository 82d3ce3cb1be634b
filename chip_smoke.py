#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version on the card, drives the main path (the quickstart
server: ``ArcusRuntime`` admission + ``run_managed``, Algorithm 1) through
the kernels, and checks a CUDA window bitwise against the same window on
the CPU.  Each phase prints one JSON line; any failure raises and the
script exits non-zero.  The last three lines are the kernel table, the
card's ``nvidia-smi`` name and power limit, and the ``ok`` line.

Imports torch and the port only.  Without a CUDA device, or run from a
directory that holds nothing else of the repository, it fails without
printing a result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# main-path cuts (the quickstart runs ProfileTable(n_ticks=60_000) and
# run_managed(total_ticks=120_000, window_ticks=30_000))
PROFILE_TICKS = 4_000
TOTAL_TICKS = 8_000
WINDOW_TICKS = 2_000
PARITY_TICKS = 2_000
PROFILE_WINDOW = 100

# H100 SXM peaks (NVIDIA data sheet, dense): 3.35 TB/s of HBM; the table
# has no int32 entry, so integer work is held against the 67 TFLOP/s
# float32 rate of the cores outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def phase_main_path(dev) -> dict:
    """The quickstart server through ArcusRuntime on the card."""
    import math

    import torch
    from repro_torch.core.accelerator import CATALOG
    from repro_torch.core.engine import SimConfig
    from repro_torch.core.profiler import ProfileTable
    from repro_torch.core.runtime import ArcusRuntime
    from repro_torch.kernels.token_bucket import ops
    k_grant = SimConfig(n_ticks=1).k_grant
    rt = ArcusRuntime([CATALOG["ipsec32"]],
                      profile_table=ProfileTable(n_ticks=PROFILE_TICKS,
                                                 device=dev), device=dev)
    ops.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    admitted = [rt.register(s) for s in quickstart_specs()]
    t1 = time.perf_counter()
    res, reports = rt.run_managed(total_ticks=TOTAL_TICKS,
                                  window_ticks=WINDOW_TICKS,
                                  load_ref_gbps={0: 32.0, 1: 32.0})
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = ops.LAUNCHES
    profiled = len(rt.profile.entries) * PROFILE_TICKS
    ticks = profiled + TOTAL_TICKS
    expect = ticks * (1 + k_grant)
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
         tb_launches=launches, tb_launches_expected=expect)
    if admitted != [True, True, False]:
        raise AssertionError(f"admission {admitted} != [True, True, False]")
    if launches != expect:
        raise AssertionError(f"token_bucket launches {launches} != ticks x "
                             f"(1 + k_grant) = {expect}")
    if len(reports) != TOTAL_TICKS // WINDOW_TICKS or not all(
            math.isfinite(v) and v >= 0 for r in reports
            for v in r.measured.values()):
        raise AssertionError(f"bad window reports: {rates}")
    done, adm = res.counters["c_done_msgs"], res.counters["c_adm_msgs"]
    if not ((done <= adm).all() and done.sum() > 0):
        raise AssertionError(f"counters inconsistent: done={done} adm={adm}")
    return dict(launches=launches)


def phase_parity(dev) -> None:
    """One simulate window of the two admitted tenants, CUDA vs CPU."""
    import numpy as np
    from repro_torch.core import token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import FlowSet
    from repro_torch.core.interconnect import LinkSpec
    from repro_torch.core.sim import SimConfig, gen_arrivals, simulate
    flows = FlowSet.build(quickstart_specs()[:2])
    cfg = SimConfig(n_ticks=PARITY_TICKS)
    arr = gen_arrivals(flows, cfg, load_ref_gbps={0: 32.0, 1: 32.0})
    tbs = tb.pack([tb.params_for_gbps(10.0), tb.params_for_gbps(20.0)])
    atab = AccelTable.build([CATALOG["ipsec32"]])
    out = [simulate(flows, atab, LinkSpec(), cfg, tbs, *arr, device=d)
           for d in (dev, "cpu")]
    for k in out[0].counters:
        a, b = out[0].counters[k], out[1].counters[k]
        if a.tobytes() != b.tobytes():
            raise AssertionError(f"CUDA != CPU counter {k}: {a} vs {b}")
    for k in ("comp_flow", "comp_lat_s", "comp_t_s", "comp_sz"):
        if not np.array_equal(getattr(out[0], k), getattr(out[1], k)):
            raise AssertionError(f"CUDA != CPU completion ring {k}")
    emit("parity", ticks=PARITY_TICKS, completions=int(len(out[0].comp_flow)),
         counters_bitwise=True, ring_bitwise=True)


def _is_host_wait(name: str) -> bool:
    """A profiler event at which the host waits for the device: the CUDA
    runtime's stream/device/event synchronisations and blocking copies,
    and the scalar read-backs that lead to them."""
    return ("Synchronize" in name or name == "cudaMemcpy"
            or name in ("aten::item", "aten::_local_scalar_dense"))


def _profile_window(dev, n_ticks: int) -> dict:
    """torch.profiler over one simulate window of ``n_ticks`` ticks of the
    two admitted tenants: host wall time, device busy time, device kernels,
    host waits by name, and the host time of the costliest ops."""
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
    simulate(flows, atab, LinkSpec(), cfg, tbs, *arr, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        simulate(flows, atab, LinkSpec(), cfg, tbs, *arr, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = kernels = 0
    waits: dict[str, int] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us += e.time_range.elapsed_us()     # one stream: no overlap
            kernels += 1
        elif _is_host_wait(e.name):
            waits[e.name] = waits.get(e.name, 0) + 1
    top = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")),
                 key=lambda e: -e.cpu_time_total)[:6]
    return dict(wall=wall, dev_us=dev_us, kernels=kernels, waits=waits,
                top={e.key: e.cpu_time_total / n_ticks for e in top})


def phase_profile(dev) -> None:
    """Where one window's time goes, and a check that the tick never makes
    the host wait: windows of PROFILE_WINDOW and 2 x PROFILE_WINDOW ticks
    must show the same host waits (the window's setup and result copies)."""
    n = PROFILE_WINDOW
    p1, p2 = _profile_window(dev, n), _profile_window(dev, 2 * n)
    grown = {k: (p1["waits"].get(k, 0), v) for k, v in p2["waits"].items()
             if v > p1["waits"].get(k, 0)}
    emit("profile", ticks=n, host_us_per_tick=p1["wall"] / n * 1e6,
         device_busy_us_per_tick=p1["dev_us"] / n,
         device_kernels_per_tick=p1["kernels"] / n,
         device_idle_share=max(0.0, 1.0 - p1["dev_us"] / (p1["wall"] * 1e6)),
         host_waits_per_window={str(n): p1["waits"], str(2 * n): p2["waits"]},
         top_host_ops_us_per_tick=p1["top"])
    if not p1["waits"]:
        raise AssertionError("profiler recorded no host wait at all (the "
                             "window's result copy is one): cannot check")
    if grown:
        raise AssertionError(f"host waits grow with ticks: {grown}")


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
    from repro_torch.kernels.token_bucket import ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    build_s = ops.build()
    emit("build", kernels=["token_bucket"], seconds=build_s)
    k = phase_kernel(dev)
    phase_interp(dev)
    main = phase_main_path(dev)
    phase_parity(dev)
    phase_profile(dev)
    n_main = 2
    t = k["times"][n_main]
    print(json.dumps({"kernels": [{
        "name": "token_bucket", "route": "cuda",
        "source": "src/repro_torch/kernels/token_bucket/csrc/token_bucket.cu",
        "replaces": "src/repro/kernels/token_bucket/kernel.py:41",
        "launches": main["launches"], "max_abs_err": k["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "shape": f"[{n_main}] flows (admission call)"}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
