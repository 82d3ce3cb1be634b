"""CPU tests of the benchmark's files and arithmetic: BENCHMARK.json's
names and units, the imports of every module under bench/, the traffic
generator, the percentiles, and the FLOP and byte counts."""
from __future__ import annotations

import ast
import json
import math
import pathlib
import re
import sys
import types

import numpy as np
import pytest

from bench import arith, profiling, run, spec, traffic
from bench.serve import Rec, Run

BENCH = pathlib.Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def _bench():
    return json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def test_benchmark_json_names_units_and_files():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and 1 <= b["run_seconds"] <= 51
    assert all(LINE.match(w) for w in b["command"])
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["why"])
        assert c["file"].startswith("bench/configs/")
        cfg = spec.load_json(BENCH.parent / c["file"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) or "head" in k
                       for k in c["reduced"])
    names = [w["name"] for w in b["workloads"]]
    assert len(set(names)) == len(names)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        assert (BENCH / "mixes" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "cells" / f"{w['name']}.json").is_file()
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", names)) <= set(names)
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len(json.dumps(b)) < 64 * 1024


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_or_reference_package_imports(monkeypatch):
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        names = _imports(f)
        # top-level names compared whole: repro_torch is not repro
        assert not names & {"jax", "jaxlib", "flax", "repro"}, f
        if "reference" in f.parts:
            assert "repro_torch" not in names, f
    # the check of a run's process, on a module table of its own (a test
    # worker's holds whatever other test files imported)
    m = types.ModuleType("m")
    table = {"repro_torch": m, "repro_torch.serving": m, "reprox": m,
             "numpy": m}
    monkeypatch.setattr(sys, "modules", table)
    assert run.forbidden_modules() == []
    table.update({"jaxlib.xla_client": m, "repro.core": m})
    assert run.forbidden_modules() == ["jaxlib", "repro"]


@pytest.mark.parametrize("mix", ["chat", "code"])
def test_mix_same_for_same_seed(mix):
    m = spec.load_json(BENCH / "mixes" / f"{mix}.json")

    def draws(seed, n=300):
        st = traffic.Stream(m, 1000, seed, 0, "reserved", 5.0)
        return [st.next() for _ in range(n)]

    a, b, c = draws(2 ** 40 + 3), draws(2 ** 40 + 3), draws(17)
    assert [(d.due, d.prompt, d.max_new) for d in a] == \
        [(d.due, d.prompt, d.max_new) for d in b]
    assert [d.prompt for d in a] != [d.prompt for d in c]
    # one trace for every seed: the same sizes and due times
    assert [(d.due, len(d.prompt), d.max_new) for d in a] == \
        [(d.due, len(d.prompt), d.max_new) for d in c]
    # each block of lengths is the distribution's quantiles, permuted
    k = m["block"]
    assert sorted(len(d.prompt) for d in a[:k]) == \
        traffic.length_block(m["prompt"], k).tolist()
    assert [len(d.prompt) for d in a[:k]] != \
        traffic.length_block(m["prompt"], k).tolist()
    assert math.isclose(a[k - 1].due, k / 5.0)
    fill = traffic.initial_fill(m, 1000, 9, 2, 64)
    assert fill == traffic.initial_fill(m, 1000, 9, 2, 64)
    assert min(d.max_new for d in fill) >= 2


def _run_with(recs, t0=0.0, t1=10.0):
    r = Run(cell=None, seed=0, t0=t0, t1=t1, setup_s=1.0, log=None,
            buckets={})
    r.log = types.SimpleNamespace(recs={i: x for i, x in enumerate(recs)},
                                  rounds=[], prefills=[], decodes=[])
    return r


def test_percentiles_over_all_requests():
    rng = np.random.default_rng(0)
    # 40 requests whose TTFTs are known; the tail sits in a few of them
    ttft = rng.exponential(0.1, 40)
    ttft[[3, 17]] = [2.0, 3.0]
    recs = []
    for i, w in enumerate(ttft):
        due = 0.2 * i
        times = list(due + w + 0.05 * np.arange(1 + (i % 5)))
        recs.append(Rec(req=None, tenant=i % 2, reserved=True, due=due,
                        times=times))
    recs.append(Rec(req=None, tenant=2, reserved=False, due=0.0,
                    times=[1.0, 2.0]))
    r = _run_with(recs, 0.0, 12.0)
    want = float(np.percentile(ttft * 1e3, 95))
    assert spec.reader("ttft_p95_ms")(r) == pytest.approx(want)
    # not the mean of per-chunk percentiles
    chunks = np.mean([np.percentile(c * 1e3, 95)
                      for c in np.array_split(ttft, 4)])
    assert abs(want - chunks) > 1.0
    gaps = [(b - a) * 1e3 for x in recs if x.reserved
            for a, b in zip(x.times, x.times[1:]) if b <= 12.0]
    assert spec.reader("itl_p95_ms")(r) == pytest.approx(
        float(np.percentile(gaps, 95)))
    # a host-paced cell reads the same two tails as per-layer metrics
    for name in ("ttft_p95_ms", "itl_p95_ms"):
        assert spec.reader(name + ".host")(r) == spec.reader(name)(r)
    n = sum(1 for x in recs for t in x.times if t <= 12.0)
    assert spec.reader("tokens_per_s")(r) == pytest.approx(n / 12.0)


def test_flops_and_bytes_by_hand():
    mx = spec.load_json(BENCH / "configs" / "mixtral-8x22b.json")
    sc = spec.load_json(BENCH / "configs" / "starcoder2-3b.json")
    # mixtral: attention 2*6144*48*128 + 2*6144*8*128, router 6144*8,
    # two experts of 3 * 6144 * 16384
    assert arith.layer_params(mx) == 75497472 + 12582912 + 49152 + 603979776
    # starcoder2: attention 2*3072*24*128 + 2*3072*2*128, plain MLP
    assert arith.layer_params(sc) == 18874368 + 1572864 + 75497472
    # a 3-token prefill of starcoder2: 6 keys reached (1 + 2 + 3)
    assert arith.prefill_flops(sc, 3) == 30 * (2.0 * 95944704 * 3
                                               + 4 * 24 * 128 * 6) \
        + 2.0 * 3072 * 49152
    assert arith.keys_reached(5000, 4096) == 4096 * 4097 // 2 + 904 * 4096
    # a decode step of mixtral over contexts 10 and 4200 (the window caps)
    assert arith.decode_flops(mx, [10, 4200]) == 8 * (
        2.0 * arith.layer_params(mx) * 2 + 4 * 48 * 128 * (11 + 4096)) \
        + 2 * 2.0 * 6144 * 32768
    f, b = arith.flash_prefill_call(sc, 2048)
    assert f == 4 * 24 * 128 * 2048 * 2049 // 2
    assert b == 2048 * 128 * (2 * 24 + 2 * 2) * 2
    # PERF.md's table: q [8,16,256] bf16, cache [8,S,8,256] float32 rows
    f, b = arith.decode_attention_call(mx, [99, 4095], "float32")
    assert f == 4 * 48 * 128 * (100 + 4096)
    assert b == 2 * 4196 * 8 * 128 * 4 + 2 * 2 * 48 * 128 * 2 + 8
    assert arith.bound_s(1e12, 1.0) == pytest.approx(1e12 / 989.4e12)


def test_trace_reduction_by_hand():
    """Busy time is the union of device operations cut to the rounds'
    span; every operation counts towards its kernel; each idle gap goes to
    the innermost host span holding its midpoint (times in ns)."""
    host = [("sched.round", 0, 100), ("sched.round", 120, 200),
            ("engine.decode", 10, 60), ("engine.prefill", 130, 170)]
    device = [("decode_attention_kernel", 0, 20), ("gemm", 30, 50),
              ("decode_attention_kernel", 45, 70),
              ("flash_prefill_kernel", 150, 210)]
    r = profiling.reduce(device, host)
    assert r.window_s == pytest.approx(200e-9)
    assert r.busy_s == pytest.approx((20 + 40 + 50) * 1e-9)
    assert r.kernel("decode_attention") == (2, pytest.approx(45e-9))
    assert r.kernel("flash_prefill") == (1, pytest.approx(60e-9))
    assert r.idle_by_host == {"engine.decode": pytest.approx(10e-9),
                              "between rounds": pytest.approx(80e-9)}
    b = r.breakdown(top=2)
    assert [n for n, _ in b["device_ops"]] == ["flash_prefill_kernel",
                                               "decode_attention_kernel"]
