"""CPU tests that drive the harness at tiny sizes: the plain reference
against the port's own float32 model, the float8 control against the
program, and whole runs with the timed path broken underneath, each of
which ``correct`` has to refuse.  The program runs its plain versions here
(``device="cpu"``); nothing here needs the card."""
from __future__ import annotations

import copy
import time

import numpy as np
import pytest
import torch

from bench import check, run, serve, spec, weights

#: the tiny cells' limits, from readings of the dense tiny cell on seeds
#: 11-13, 21 and 22: sound runs read ``gap_max`` 0.013-0.042 and
#: ``gap_share`` 0, the float8 control 0.278-0.547 and 0.089-0.110, the
#: three faults 5.6-6.3 and 0.24-0.66
GAP_MAX_LIMIT = 0.1
GAP_SHARE_LIMIT = 0.02


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def tiny_cell(kind: str, dtype: str = "bfloat16", **params) -> spec.Cell:
    """A cell of the benchmark's own files at tiny widths: ``moe`` from
    mixtral-8x22b's configuration, ``dense`` from starcoder2-3b's."""
    name = {"moe": "mixtral-8x22b", "dense": "starcoder2-3b"}[kind]
    cfg = copy.deepcopy(spec.load_json(spec.BENCH / "configs"
                                       / f"{name}.json"))
    cfg.update(hidden_size=64, intermediate_size=96, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, num_hidden_layers=2,
               vocab_size=4096, sliding_window=64)
    replace = dict(n_layers=2, d_model=64, d_ff=96, n_heads=4, n_kv_heads=2,
                   head_dim=16, vocab=4096, window=64, dtype=dtype)
    if kind == "moe":
        cfg["num_local_experts"] = 4
        replace["n_experts"] = 4
    cfg["served_as"]["dtype"] = dtype
    cfg["program"] = {"arch": name, "replace": replace}
    mix = copy.deepcopy(spec.load_json(spec.BENCH / "mixes" / "chat.json"))
    mix.update(block=16,
               prompt={"median": 8, "sigma": 0.5, "min": 2, "max": 24},
               output={"median": 16, "sigma": 0.5, "min": 4, "max": 36})
    # every request the window finished is compared (some 800-950 tokens):
    # at these widths attention moves the logits little, and a cache that
    # never changes shows only over that many positions
    p = {"name": "tiny", "reserved_rate_per_s": 20.0,
         "engine": {"max_batch": 4, "max_len": 64, "cache_dtype": "float32"},
         "check": {"sample_tokens": 3000, "gap_max_limit": GAP_MAX_LIMIT,
                   "gap_share_limit": GAP_SHARE_LIMIT}}
    p.update(params)
    return spec.Cell(f"{name}.chat", 1, cfg, mix, p)


@pytest.mark.parametrize("kind", ["moe", "dense"])
def test_reference_matches_port_float32(kind):
    """Prefill, then decode through the cache, of the port's float32 model
    against the reference's full forward pass, on the same drawn
    weights."""
    from repro_torch.models import transformer as T
    cell = tiny_cell(kind, "float32")
    cfg, seed = cell.config, 2 ** 33 + 5
    arch = spec.program_config(cfg)
    specs = cell.reference.param_specs(cfg)
    model = T.Transformer(arch, device="cpu")
    weights.load_into(model, specs, seed)
    model.tie()
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 4096, 30))
    P = 20
    cache = T.init_cache(arch, 1, 64, torch.float32, device="cpu")
    got = [T.prefill(model, toks[None, :P], cache)[0][0]]
    for i in range(P, 30):
        got.append(T.decode_step(model, toks[None, i:i + 1],
                                 torch.tensor([i], dtype=torch.int32),
                                 cache)[0])
    want = cell.reference.logits(cfg, weights.Weights(specs, seed, "cpu"),
                                 [toks], [np.arange(P - 1, 30)])[0]
    got = torch.stack(got)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * float(
        want.abs().max())), float((got - want).abs().max())


#: a short traced stretch and drain at these sizes
SHORT = {"trace_s": 0.3, "drain_s": 5.0}


def _measure(cell, seed, *, patch=None, control=False, seconds=1.0):
    return run.measure(cell, seed, seconds, False, "cpu",
                       t_start=time.perf_counter(), patch=patch,
                       control=control, **SHORT)


def test_control_fails_where_the_program_passes():
    """The float8 control, read on the program's served sequences and held
    to the tiny cells' limits in the program's place, is not correct on
    every seed where the program's bf16 tokens are."""
    for seed in (11, 12, 13):
        out = _measure(tiny_cell("dense"), seed, control=True)
        assert out["correct"], out["checks"]
        ctl = out["control_checks"]
        assert not check.passed(ctl), ctl
        assert ctl["gap_max"]["value"] > GAP_MAX_LIMIT, ctl
        assert ctl["gap_share"]["value"] > GAP_SHARE_LIMIT, ctl


def _cache_unchanged(engine):
    dec = engine._decode

    def step(tokens, lengths, cache):
        keep = [t.clone() for layer in cache for t in layer]
        out = dec(tokens, lengths, cache)
        for t, k in zip((t for layer in cache for t in layer), keep):
            t.copy_(k)
        return out
    engine._decode = step


def _half_batch(engine):
    dec = engine._decode

    def step(tokens, lengths, cache):
        out = dec(tokens, lengths, cache)
        h = out.shape[0] // 2
        out[h:] = out[:h].mean(0, keepdim=True)
        return out
    engine._decode = step


def _token_altered(engine):
    dec = engine._decode

    def step(tokens, lengths, cache):
        out = dec(tokens, lengths, cache)
        out[0, (int(out[0].argmax()) + 1) % out.shape[1]] += 1e3
        return out
    engine._decode = step


FAULTS = {"state_unchanged": _cache_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_broken_timed_path_is_not_correct(fault):
    """A whole run (set-up, window, drain, checks) with the timed path
    broken underneath reads ``correct`` false; the same run unbroken reads
    true.  One card, so no exchange between chips to leave out."""
    out = _measure(tiny_cell("dense"), 21,
                   patch=FAULTS[fault] if fault else None, seconds=2.0)
    assert out["correct"] is (fault is None), (fault, out["checks"])


@pytest.mark.parametrize("fault", [None, "bucket_bypass", "extra_token"])
def test_broken_accounting_is_not_correct(fault, monkeypatch):
    """Long prompts against a tight SLO: the buckets shape admissions, and
    a scheduler that admits past its bucket, or a request that gets a
    token more than it asked for, reads ``correct`` false."""
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ArcusScheduler
    cell = tiny_cell("dense", reserved_rate_per_s=20.0)
    cell.engine.update(max_batch=8, max_len=2048)
    cell.config["sliding_window"] = 2048
    cell.config["program"]["replace"]["window"] = 2048
    # an SLO of a twentieth of the offered prompt tokens: shaped, the
    # admissions keep to the bucket (reading -120 to -200 tokens); past it,
    # some 17,000-27,000 tokens over
    cell.mix.update(slo_factor=0.05,
                    prompt={"median": 1200, "sigma": 0.3, "min": 600,
                            "max": 1800},
                    output={"median": 3, "sigma": 0.3, "min": 2, "max": 6})

    def patch(engine):
        if fault == "bucket_bypass":
            monkeypatch.setattr(ArcusScheduler, "_try_consume",
                                lambda self, i, tokens: True)
        elif fault == "extra_token":
            monkeypatch.setattr(Request, "done", property(
                lambda r: len(r.generated) >= r.max_new_tokens + 1))
    out = _measure(cell, 31, seconds=2.0, patch=patch)
    assert out["correct"] is (fault is None), (fault, out["checks"])


#: the per-layer metrics each cell reports that a CPU run finds something
#: to read for (the kernels' rooflines find no kernel of theirs there)
PER_LAYER = {
    "starcoder2-3b.code": {"sched.host_ms", "sched.wait_ms_p50",
                           "engine.decode_ms", "engine.prefill_ms_per_ktok",
                           "model.mfu", "model.mfu.prefill",
                           "device.idle_share"},
    "starcoder2-3b.chat": {"ttft_p95_ms.host", "itl_p95_ms.host",
                           "engine.decode_ms", "model.mfu",
                           "device.idle_share"},
}


def _traced(name):
    cell = tiny_cell("dense")
    cell.name = name
    out = run.measure(cell, 23, 2.0, True, "cpu",
                      t_start=time.perf_counter(), **SHORT)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == PER_LAYER[name]
    return out


def test_host_paced_cell_reports_its_tails_per_layer():
    """The chat cell, whose card is idle most of its traced stretch,
    reports the two tails as per-layer metrics of the host, and none of
    the metrics that move them in the code cell."""
    _traced("starcoder2-3b.chat")


def test_traced_run_reports_per_layer_metrics():
    """A ``--trace 1`` run on the CPU: the cell's per-layer metrics that
    have something to read there, and no other metric, the traced
    stretch's busy and window seconds and its breakdown."""
    out = _traced("starcoder2-3b.code")
    m = out["metrics"]
    dev = out["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert 0 <= m["device.idle_share"]["value"] < 100
    assert out["breakdown"]["device_ops"] and out["breakdown"]["idle_gaps"]
    # the cache's rows in use, told from its size
    c = out["cache"]
    assert c["slots"] == 4 and c["rows_per_slot"] == 64
    assert 0 < c["rows_in_use_mean"] <= c["slots"] * c["rows_per_slot"]
    assert c["bytes"] == 2 * 2 * 4 * 64 * 2 * 16 * 4
    assert 0 < c["bytes_in_use_mean"] < c["bytes"]
    assert list(out)[-1] == "checks"


def test_traced_stretch_follows_the_window_and_drain():
    """The profiler runs after the window and its drain: no call of the
    window is traced, and the traced calls are what the kernels' rooflines
    read."""
    r, drv = serve.run(tiny_cell("dense"), 24, 1.5, trace=True,
                       device="cpu", t_start=time.perf_counter(), **SHORT)
    drv.free()
    calls = r.log.prefills + r.log.decodes + r.log.rounds
    traced = [c for c in calls if c.traced]
    assert traced and r.log.decodes[-1].traced
    assert all(c.t0 >= r.t1 + r.drained_s for c in traced)
    assert not any(c.traced for c in r.window(calls))
    rounds = [c for c in r.log.rounds if c.traced]
    assert r.trace.window_s == pytest.approx(
        rounds[-1].t1 - rounds[0].t0, abs=1e-3)


def test_background_leaves_the_reserved_tenants_slots():
    """The background fills its share of the slots and never more (its
    requests, active and queued, with every other request queued), so
    each reserved request is admitted in the round it falls due in."""
    cell = tiny_cell("dense", reserved_rate_per_s=4.0)
    cell.engine.update(max_batch=8)
    cell.mix["background_fill"] = 0.5
    drv = serve.Driver(cell, 25, "cpu")
    drv.schedule(cell.params["reserved_rate_per_s"])
    drv.fill()
    assert len(drv.log.recs) == drv.bg_cap == 4
    assert all(r.times for r in drv.log.recs.values())
    t0 = time.perf_counter()
    while time.perf_counter() < t0 + 1.5:
        drv.round(t0)
        bg = sum(1 for r in drv.log.recs.values() if not r.reserved
                 and not r.req.done)
        assert bg <= drv.bg_cap
    res = [r for r in drv.log.recs.values() if r.reserved]
    assert res and all(r.times for r in res)
    rounds = drv.log.rounds
    for r in res:
        # admitted in the first round that began after it fell due
        start = next(x.t0 for x in rounds if x.t0 >= r.due)
        assert r.admit_start <= next(x.t1 for x in rounds if x.t0 >= r.due)
        assert r.admit_start >= start
