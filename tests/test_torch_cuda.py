"""On-card tests of the port: the Hopper token-bucket (step and grant
tick, serial and over a batch), decode-attention, flash-prefill (forward
and backward) and SSD-scan kernels against their plain versions, CUDA
dataplane windows (every engine parity case, and a ragged mixed-mode
batch) against the same windows on the CPU, the serving engine (gemma3
and mamba2) through the kernels against the same engine through the plain
versions, and a training step through the kernels against one through the
plain versions.  They need an NVIDIA GPU with ``nvcc`` and skip elsewhere;
on the card run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports torch and the port only (no JAX), so it also runs where
JAX is not installed."""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from _engine_cases import (BATCH_HOLE, BATCH_WINDOW, CASES as ENGINE_CASES,
                           batch_masks, case_link, port_batch,
                           port_batch_registers, port_scenario)
from repro_torch.core import engine as te, token_bucket as tb
from repro_torch.core.accelerator import CATALOG, AccelTable
from repro_torch.core.flow import (SLO, FlowSet, FlowSpec, Path,
                                   TrafficPattern)
from repro_torch.core.interconnect import LinkSpec, ResourceSpec
from repro_torch.core.sim import (SimConfig, gen_arrivals, simulate,
                                  simulate_batch)
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_prefill import ops as fp_ops, \
    rehearse as fp_rehearse
from repro_torch.kernels.ssd_scan import ops as ssd_ops, ref as ssd_ref
from repro_torch.kernels.token_bucket import ops, rehearse as tb_rehearse

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _state(n, dev, seed):
    rng = np.random.default_rng(seed)
    interval = rng.integers(1, 1024, n).astype(np.int32)
    regs = [rng.integers(-(1 << 20), 1 << 20, n),
            rng.integers(0, 1024, n) % interval,
            rng.integers(1, 5000, n), rng.integers(512, 1 << 20, n),
            interval, rng.integers(0, 2, n)]
    regs[0][:1], regs[2][:1], regs[3][:1], regs[4][:1] = \
        2**30, 2**30, 2**30, 1                  # int32-overflow registers
    st = tb.TBState(*(torch.as_tensor(np.asarray(x, np.int32), device=dev)
                      for x in regs))
    cost = torch.as_tensor(rng.integers(1, 8192, n).astype(np.int32),
                           device=dev)
    return st, cost, torch.as_tensor(rng.random(n) < 0.8, device=dev)


@pytest.mark.parametrize("n", [1, 3, 1025, 1 << 16])
@pytest.mark.parametrize("elapsed", [0, 8, 10**7])
def test_kernel_matches_plain_on_card(dev, n, elapsed):
    st, cost, want = _state(n, dev, n + elapsed)
    before = ops.LAUNCHES
    got, adm = ops.token_bucket_step(st, elapsed, cost, want)
    assert ops.LAUNCHES == before + 1
    ref, adm_r = ops.token_bucket_step_plain(st, elapsed, cost, want)
    torch.cuda.synchronize()
    assert torch.equal(got.tokens, ref.tokens)
    assert torch.equal(got.cyc, ref.cyc)
    assert torch.equal(adm, adm_r)


def test_kernel_rejects_bad_inputs(dev):
    st, cost, want = _state(8, dev, 0)
    with pytest.raises(ValueError):
        ops.token_bucket_step(st, 8, cost.long(), want)
    with pytest.raises(ValueError):
        ops.token_bucket_step(st, 8, cost, None)


def test_cuda_window_matches_cpu_window(dev):
    specs = [FlowSpec(i, i, Path.FUNCTION_CALL, 0,
                      TrafficPattern(1500, load=0.9), SLO.gbps(s))
             for i, s in enumerate((10.0, 20.0))]
    flows = FlowSet.build(specs)
    cfg = SimConfig(n_ticks=300)
    arr = gen_arrivals(flows, cfg, load_ref_gbps={0: 32.0, 1: 32.0})
    tbs = tb.pack([tb.params_for_gbps(10.0), tb.params_for_gbps(20.0)])
    atab = AccelTable.build([CATALOG["ipsec32"]])
    before = ops.LAUNCHES
    r_dev = simulate(flows, atab, LinkSpec(), cfg, tbs, *arr, device=dev)
    assert ops.LAUNCHES - before == cfg.n_ticks      # one grant tick a tick
    r_cpu = simulate(flows, atab, LinkSpec(), cfg, tbs, *arr, device="cpu")
    for k in r_cpu.counters:
        assert r_dev.counters[k].tobytes() == r_cpu.counters[k].tobytes(), k
    np.testing.assert_array_equal(r_dev.comp_t_s, r_cpu.comp_t_s)
    np.testing.assert_array_equal(r_dev.comp_flow, r_cpu.comp_flow)


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_case_on_card_matches_cpu(dev, case):
    """Every engine parity case (``_engine_cases.CASES``) as a CUDA window
    equals the same window on the CPU on every carry leaf, with one
    grant-tick launch a tick and no step launch."""
    flows, atab, cfg, tbs, arr, stall = port_scenario(**ENGINE_CASES[case])
    link = case_link(ENGINE_CASES[case], LinkSpec, ResourceSpec)
    before = dict(ops.LAUNCHES_BY_PATH)
    c_dev = te.run_window(flows, atab, link, cfg, tbs, *arr, stall,
                          device=dev)
    torch.cuda.synchronize()
    assert ops.LAUNCHES_BY_PATH["grant_tick"] - before["grant_tick"] == \
        cfg.n_ticks
    assert ops.LAUNCHES_BY_PATH["step"] == before["step"]
    c_cpu = te.run_window(flows, atab, link, cfg, tbs, *arr, stall,
                          device="cpu")
    got, want = te.carry_to_numpy(c_dev), te.carry_to_numpy(c_cpu)
    assert int(want["c_adm_msgs"].sum()) > 0
    for k, v in want.items():
        for a, b in zip(v if k == "tb" else (v,),
                        got[k] if k == "tb" else (got[k],)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("k_grant", tb_rehearse.GRANT_K)
@pytest.mark.parametrize("n", tb_rehearse.GRANT_NS)
def test_grant_tick_matches_plain_on_card(dev, n, k_grant):
    """``grant_tick`` (one launch) equals ``grant_tick_plain`` bitwise on
    random valid carries under every shaping mode and arbiter."""
    for shaping in tb_rehearse.SHAPINGS:
        for arbiter in tb_rehearse.ARBITERS:
            row = tb_rehearse.check_case((n, shaping, arbiter, k_grant), dev)
            torch.cuda.synchronize()
            assert row["launches"] == 1 and row["differ"] == [], row


def test_grant_tick_one_launch_a_tick(dev):
    """A window of 50 ticks makes 50 grant-tick launches and nothing else
    of the token bucket's."""
    flows, atab, cfg, tbs, arr, stall = port_scenario(
        **ENGINE_CASES["hw_rr"], n_ticks=50)
    before = (ops.LAUNCHES, dict(ops.LAUNCHES_BY_PATH))
    te.run_window(flows, atab, LinkSpec(), cfg, tbs, *arr, stall,
                  device=dev)
    assert ops.LAUNCHES - before[0] == 50
    assert ops.LAUNCHES_BY_PATH == dict(
        step=before[1]["step"], grant_tick=before[1]["grant_tick"] + 50)


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_case_graph_matches_eager(dev, case):
    """Every engine parity case as two CUDA windows through the entry's
    graph, the second resumed at t0 > 0 with a register write, equals the
    same windows through the eager body bitwise on every carry leaf; the
    graph's replays count one grant-tick launch a tick, and the resumed
    window captures nothing new."""
    flows, atab, cfg, tbs, arr, stall = port_scenario(**ENGINE_CASES[case])
    link = case_link(ENGINE_CASES[case], LinkSpec, ResourceSpec)
    n = cfg.n_ticks // 2
    win = dataclasses.replace(cfg, n_ticks=n)
    regs = tb.pack([tb.params_for_gbps(4.0 * (i + 1))
                    for i in range(flows.n)])

    def run(fn):
        carry = None
        for t0, st in ((0, tbs), (n, regs)):
            carry = fn(flows, atab, link, win, st, *arr, stall,
                       t0_ticks=t0, carry=carry, device=dev)
            yield te.cache_info()
        yield te.carry_to_numpy(carry)
    before = ops.LAUNCHES_BY_PATH["grant_tick"]
    te.cache_clear()
    *infos, got = run(te.run_window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES_BY_PATH["grant_tick"] - before == 2 * n
    assert infos == [{"entries": 1, "traces": 1}] * 2
    *_, want = run(te._run_window_eager)
    assert int(want["c_adm_msgs"].sum()) > 0
    for k, v in want.items():
        for a, b in zip(v if k == "tb" else (v,),
                        got[k] if k == "tb" else (got[k],)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("case", tb_rehearse.RES_CASES)
def test_grant_tick_resource_axes_match_plain_on_card(dev, case):
    """The grant tick with R = 1-4 extra resource axes (eligibility on
    every demanded axis, a fused charge a grant) equals
    ``grant_tick_plain`` bitwise on every leaf and the axes' budgets."""
    row = tb_rehearse.check_resources(case, dev)
    torch.cuda.synchronize()
    assert row["launches"] == 1 and row["differ"] == [], row


@pytest.mark.parametrize("shared_stall", [False, True])
@pytest.mark.parametrize("batch", tb_rehearse.BATCH_SIZES)
def test_grant_tick_batch_matches_plain_on_card(dev, batch, shared_stall):
    """The batched grant tick (one launch, one CTA an element) equals
    ``grant_tick_plain`` bitwise on ragged batches with mid-table holes,
    mixed shaping modes and arbiters, per-element or shared stall rows."""
    row = tb_rehearse.check_batch(batch, dev, shared_stall=shared_stall)
    torch.cuda.synchronize()
    assert row["launches"] == 1 and row["differ"] == [], row
    assert row["grants"] > 0 and row["hole_grants"] == 0


def _batch_windows(run, dev):
    """``_engine_cases.port_batch`` over three windows through ``run``
    (``run_window_batch`` or its eager body): a hole; a recycled lane and
    new registers; a released lane resumed without registers.  The host
    carry after each window."""
    flows, tabs, cfgs, regs, arr, stall = port_batch()
    masks = [batch_masks(), batch_masks(None), batch_masks(None)]
    masks[2][1][2] = False
    regs = [regs, port_batch_registers(flows), None]
    carry, out = None, []
    for w in range(3):
        if w == 1:
            carry = te.recycle_flow_lane(carry, *BATCH_HOLE)
        if w == 2:
            carry = te.release_flow_lane(carry, 1, 2)
        carry = run(flows, tabs, LinkSpec(), cfgs, regs[w], *arr, stall,
                    t0_ticks=w * BATCH_WINDOW, carry=carry,
                    fl_masks=masks[w], device=dev)
        out.append(te.carry_to_numpy(carry))
    return out


def _carries_equal(want: dict, got: dict) -> None:
    for k, v in want.items():
        for a, b in zip(v if k == "tb" else (v,),
                        got[k] if k == "tb" else (got[k],)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def test_batch_windows_on_card_match_cpu_and_eager(dev):
    """A ragged mixed-mode batch (flows 1-3, accelerators 1-2, HW + RR, SW
    + WFQ with stalls, NONE + PRIORITY, HW + WRR, a hole) over three
    windows through the batch entry's CUDA graph equals the same windows on
    the CPU and through the eager body on the card, bitwise on every carry
    leaf; one grant-tick launch a tick and one batch entry."""
    te.cache_clear()
    before = ops.LAUNCHES_BY_PATH["grant_tick"]
    graph = _batch_windows(te.run_window_batch, dev)
    torch.cuda.synchronize()
    assert ops.LAUNCHES_BY_PATH["grant_tick"] - before == 3 * BATCH_WINDOW
    assert te.cache_info() == {"entries": 1, "traces": 1}
    cpu = _batch_windows(te.run_window_batch, "cpu")
    eager = _batch_windows(te._run_window_batch_eager, dev)
    for g, c, e in zip(graph, cpu, eager):
        assert int(c["c_adm_msgs"].sum()) > 0
        _carries_equal(c, g)
        _carries_equal(c, e)


def test_batch_elements_match_serial_on_card(dev):
    """Each element of one ``simulate_batch`` window on the card equals a
    serial ``simulate`` of it on the card, bitwise."""
    flows, tabs, cfgs, regs, (arr_t, arr_sz), stall = port_batch(1)
    batch = simulate_batch(flows, tabs, LinkSpec(), cfgs, regs, arr_t,
                           arr_sz, stall, device=dev)
    for b, f in enumerate(flows):
        serial = simulate(f, tabs[b], LinkSpec(), cfgs[b], regs[b],
                          arr_t[b, :f.n], arr_sz[b, :f.n], stall[b],
                          device=dev)
        for k, v in serial.counters.items():
            assert v.tobytes() == batch[b].counters[k].tobytes(), (b, k)
        for k in ("comp_flow", "comp_lat_s", "comp_t_s", "comp_sz"):
            assert np.array_equal(getattr(serial, k), getattr(batch[b], k))


@pytest.mark.parametrize("arch", ["gemma3-12b", "mamba2-780m",
                                  "recurrentgemma-9b", "mixtral-8x22b",
                                  "llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_captured_decode_matches_eager(dev, arch):
    """The reduced config's decode step (``chip_smoke._liven``'s noise on
    its gates, biases and norms) through the engine's CUDA graph gives the
    eager body's logits (and so tokens) and cache bitwise, each
    step against the eager body on a copy of the cache it started from
    (the memory caches too); each replay counts one decode-attention
    launch a self-attention, ``cross`` or ``xattn`` layer."""
    import dataclasses as dc
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    cfg = get_reduced_config(arch, dtype="bfloat16")
    if arch == "mamba2-780m":
        cfg = dc.replace(cfg, d_ff=0)
    model = T.init_model(0, cfg, device=dev)
    chip_smoke._liven(model, 0)
    n_attn = chip_smoke.attention_launches(cfg)["decode"]
    eng = ServingEngine(cfg, model, max_batch=4, max_len=128, device=dev)
    graph, rows = eng._decode, []

    def decode(tok, ln, cache):
        snap = [tuple(t.clone() for t in kv) for kv in cache]
        n0 = da_ops.LAUNCHES
        out = graph(tok, ln, cache)
        launched = da_ops.LAUNCHES - n0
        want = eng._decode_eager(tok, ln, snap)
        rows.append((out, want, launched, [
            torch.equal(a, b) for kv, sv in zip(cache, snap)
            for a, b in zip(kv, sv)]))
        return out
    eng._decode = decode
    rng = np.random.default_rng(0)
    for i, n in enumerate((80, 12, 40)):
        eng.admit(Request(i, 0, list(rng.integers(0, cfg.vocab, n)), 12),
                  chip_smoke._frontends(cfg, 1, dev, seed=i)[0])
    for _ in range(10):
        eng.step()
    assert len(rows) == 10
    for out, want, launched, same_cache in rows:
        assert torch.equal(out, want)
        assert all(same_cache)
        assert launched == n_attn


def test_grant_tick_rejects_bad_inputs(dev):
    """A CUDA carry with a wrong dtype, shape or layout raises before any
    launch; so does a tick index that is not a [1] int32 tensor (the
    engine checks the stall mask's length once a window)."""
    cfg, args, carry, budget, t_idx = tb_rehearse.random_grant_inputs(
        5, 0, dev, shaping=2, arbiter=0, k_grant=4)
    before = ops.LAUNCHES
    for key, bad in (("vft", carry["vft"].double()),
                     ("q_head", carry["q_head"].long()),
                     ("q_sz", carry["q_sz"].transpose(1, 2).contiguous()
                      .transpose(1, 2)),
                     ("rr_ptr", carry["rr_ptr"].view(1, 1))):
        c = dict(carry, **{key: bad})
        with pytest.raises(ValueError, match=key):
            ops.grant_tick(cfg, args, c, budget, t_idx)
    with pytest.raises(ValueError, match="budget"):
        ops.grant_tick(cfg, args, carry, budget.double(), t_idx)
    with pytest.raises(ValueError, match="t_idx"):
        ops.grant_tick(cfg, args, carry, budget, t_idx.long())
    assert ops.LAUNCHES == before


# --- attention kernels (tolerances of the JAX tests: 2e-5 float32, 2e-2
# where bf16 is involved) ------------------------------------------------------

DA_CASES = [
    # B, H, KvH, D, S, window, q dtype, cache dtype
    (2, 16, 8, 128, 1024, 0, torch.float32, torch.float32),
    (3, 12, 2, 80, 777, 0, torch.float32, torch.float32),
    (2, 16, 8, 128, 2048, 256, torch.bfloat16, torch.bfloat16),
    (1, 24, 2, 128, 640, 128, torch.float32, torch.float32),
    (8, 16, 8, 256, 1024, 0, torch.bfloat16, torch.float32),
    (2, 8, 2, 64, 256, 0, torch.float32, torch.bfloat16),
    # recurrentgemma-9b's MQA (G = 16, D 256) and mixtral-8x22b's G = 6
    (8, 16, 1, 256, 2048, 0, torch.bfloat16, torch.float32),
    (8, 48, 8, 128, 2048, 0, torch.bfloat16, torch.float32),
]


# the cluster kernel's edges: B, H, KvH, D, S, window, q dtype, cache
# dtype, lengths (each CTA of a cluster of up to 8 takes a share of the
# valid rows)
DA_EDGE_CASES = {
    # empty sequences and fewer valid rows than CTAs in the cluster
    "lengths_0_and_below_cluster": (4, 8, 2, 64, 64, 0, torch.float32,
                                    torch.float32, [0, 1, 3, 0]),
    # a window whose start falls inside one CTA's share
    "window_inside_a_share": (3, 8, 2, 128, 512, 37, torch.float32,
                              torch.float32, [500, 40, 37]),
    # lengths past S clamp to S (and the window's start to 0)
    "lengths_past_s": (3, 8, 4, 64, 100, 150, torch.bfloat16,
                       torch.bfloat16, [101, 250, 100]),
    "g5": (2, 10, 2, 128, 300, 0, torch.bfloat16, torch.float32,
           [300, 17]),
    "g16": (2, 32, 2, 128, 300, 0, torch.float32, torch.float32,
            [150, 299]),
    "d80": (2, 8, 2, 80, 200, 0, torch.float32, torch.bfloat16, [200, 9]),
    "d96": (2, 8, 4, 96, 200, 64, torch.bfloat16, torch.bfloat16,
            [190, 64]),
    # a frontend's memory, every row valid: llama-3.2-vision-11b's cross
    # layers (G = 4, D 128, 1600 rows: a partial last row tile) and
    # seamless-m4t-medium's (G = 1, D 64, 1024 rows)
    "memory_g4_s1600": (8, 32, 8, 128, 1600, 0, torch.bfloat16,
                        torch.float32, [1600] * 8),
    "memory_g1_d64_s1024": (8, 16, 16, 64, 1024, 0, torch.bfloat16,
                            torch.float32, [1024] * 8),
}
DA_DTYPE_PAIRS = [(a, b) for a in (torch.float32, torch.bfloat16)
                  for b in (torch.float32, torch.bfloat16)]


def _da_check(dev, B, H, KvH, D, S, w, qdt, cdt, ln, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, D), generator=g, device=dev).to(qdt)
    k = torch.randn((B, S, KvH, D), generator=g, device=dev).to(cdt)
    v = torch.randn((B, S, KvH, D), generator=g, device=dev).to(cdt)
    if ln is None:
        ln = torch.randint(0, S + 1, (B,), generator=g, device=dev,
                           dtype=torch.int32)
    else:
        ln = torch.tensor(ln, dtype=torch.int32, device=dev)
    before = da_ops.LAUNCHES
    got = da_ops.decode_attention(q, k, v, ln, window=w)
    assert da_ops.LAUNCHES == before + 1
    want = da_ops.decode_attention_plain(q, k, v, ln, window=w)
    torch.cuda.synchronize()
    tol = 2e-2 if torch.bfloat16 in (qdt, cdt) else 2e-5
    assert got.dtype == qdt
    assert float((got.float() - want.float()).abs().max()) < tol
    return got, ln


@pytest.mark.parametrize("case", DA_CASES)
def test_decode_attention_kernel_matches_plain(dev, case):
    B, H, KvH, D, S, w, qdt, cdt = case
    _da_check(dev, B, H, KvH, D, S, w, qdt, cdt, None, S)


@pytest.mark.parametrize("name", sorted(DA_EDGE_CASES))
def test_decode_attention_kernel_edges(dev, name):
    got, ln = _da_check(dev, *DA_EDGE_CASES[name], seed=len(name))
    # a sequence with no valid position returns exactly 0
    assert not got[ln == 0].any()


@pytest.mark.parametrize("qdt, cdt", DA_DTYPE_PAIRS)
def test_decode_attention_kernel_dtype_pairs(dev, qdt, cdt):
    _da_check(dev, 3, 8, 2, 128, 160, 0, qdt, cdt, [160, 3, 77], seed=7)


def test_decode_attention_one_launch_no_scratch(dev):
    """One call is one launch, allocates its output and nothing else, and
    never waits for the card (``lengths`` stays there)."""
    B, H, KvH, D, S = 8, 16, 8, 256, 256
    q = torch.randn((B, H, D), device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, KvH, D), device=dev)
    ln = torch.arange(13, 13 + 8 * B, 8, dtype=torch.int32, device=dev)
    da_ops.decode_attention(q, k, k, ln)          # builds, sets attributes
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    before = da_ops.LAUNCHES
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = da_ops.decode_attention(q, k, k, ln)
    torch.cuda.synchronize()
    assert da_ops.LAUNCHES == before + 1
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == \
        allocs + 1
    assert out.shape == q.shape
    waits = [e.name for e in prof.events()
             if "Synchronize" in e.name or "Memcpy" in e.name
             or e.name in ("aten::item", "aten::_local_scalar_dense")]
    assert not waits


FP_CASES = [
    # B, S, H, KvH, D, window, chunk, dtype[, causal[, Sk]]
    (2, 128, 4, 2, 64, 0, 0, torch.float32),
    (1, 200, 4, 1, 80, 0, 0, torch.float32),
    (2, 256, 4, 2, 64, 64, 0, torch.float32),
    (1, 256, 4, 2, 64, 0, 64, torch.float32),
    (1, 300, 16, 8, 256, 100, 0, torch.bfloat16),
    (1, 1536, 16, 8, 256, 1024, 0, torch.bfloat16),
    # the tensor-core kernel's edges: 128 packed rows (position x head) a
    # block, 64-key tiles, 64-column panels, D rounded up to 16
    (1, 1, 8, 2, 128, 0, 0, torch.bfloat16),
    (1, 63, 8, 2, 64, 0, 0, torch.bfloat16),
    (2, 65, 8, 2, 80, 0, 0, torch.bfloat16),
    (1, 129, 8, 1, 128, 0, 0, torch.bfloat16),        # MQA: G = 8
    (1, 300, 16, 4, 256, 0, 0, torch.bfloat16),       # G = 4
    (1, 200, 10, 2, 128, 0, 0, torch.bfloat16),       # G = 5
    (1, 300, 8, 2, 64, 37, 0, torch.bfloat16),        # window edge in a tile
    (1, 300, 8, 2, 128, 0, 40, torch.bfloat16),       # chunk edges in tiles
    (2, 129, 8, 8, 80, 0, 0, torch.bfloat16, False),  # non-causal, G = 1
    (1, 70, 6, 2, 36, 0, 0, torch.bfloat16),          # D padded to 40
    # recurrentgemma-9b's local layers (G = 16, D 256) past their window,
    # and mixtral-8x22b's (G = 6: packed rows i * 6 + g across tiles)
    (1, 2560, 16, 1, 256, 2048, 0, torch.bfloat16),
    (1, 200, 48, 8, 128, 0, 0, torch.bfloat16),
    (1, 1536, 48, 8, 128, 4096, 0, torch.bfloat16),
    # non-causal over a memory of Sk rows: llama-3.2-vision-11b's cross
    # layers (12 queries against 1600 rows), seamless-m4t-medium's cross
    # layers (1536 against 1024, Sq > Sk) and encoder (1024 x 1024), the
    # reduced configs' memory (16 rows, below one 64-key tile) and Sk not a
    # multiple of the tile
    (1, 12, 32, 8, 128, 0, 0, torch.bfloat16, False, 1600),
    (1, 1536, 16, 16, 64, 0, 0, torch.bfloat16, False, 1024),
    (1, 1024, 16, 16, 64, 0, 0, torch.bfloat16, False, 1024),
    (2, 40, 4, 1, 64, 0, 0, torch.bfloat16, False, 16),
    (1, 300, 8, 2, 128, 0, 0, torch.bfloat16, False, 1000),
]


@pytest.mark.parametrize("case", FP_CASES)
def test_flash_prefill_kernel_matches_plain(dev, case):
    B, S, H, KvH, D, w, ck, dt = case[:8]
    causal = case[8] if len(case) > 8 else True
    Sk = case[9] if len(case) > 9 else S
    g = torch.Generator(device=dev).manual_seed(S)
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(dt)
    k = torch.randn((B, Sk, KvH, D), generator=g, device=dev).to(dt)
    v = torch.randn((B, Sk, KvH, D), generator=g, device=dev).to(dt)
    path = "tensor_core" if dt == torch.bfloat16 else "cuda_core"
    before, by_path = fp_ops.LAUNCHES, dict(fp_ops.LAUNCHES_BY_PATH)
    by_mask = dict(fp_ops.LAUNCHES_BY_MASK)
    got = fp_ops.flash_prefill(q, k, v, window=w, chunk_size=ck,
                               causal=causal)
    assert fp_ops.LAUNCHES == before + 1
    by_path[path] += 1
    assert fp_ops.LAUNCHES_BY_PATH == by_path
    by_mask["causal" if causal else "full" if Sk == S else "full_cross"] += 1
    assert fp_ops.LAUNCHES_BY_MASK == by_mask
    want = fp_ops.flash_prefill_plain(q, k, v, window=w, chunk_size=ck,
                                      causal=causal)
    torch.cuda.synchronize()
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    assert got.dtype == dt and got.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) < tol


def test_flash_prefill_mixed_operands_take_cuda_core_path(dev):
    """bf16 q over float32 k, v: the float32 CUDA-core kernel."""
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((1, 100, 8, 64), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((1, 100, 2, 64), generator=g, device=dev)
            for _ in range(2))
    by_path = dict(fp_ops.LAUNCHES_BY_PATH)
    got = fp_ops.flash_prefill(q, k, v, window=30)
    by_path["cuda_core"] += 1
    assert fp_ops.LAUNCHES_BY_PATH == by_path
    want = fp_ops.flash_prefill_plain(q, k, v, window=30)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < 2e-2


def test_attention_kernels_reject_bad_inputs(dev):
    q = torch.zeros((2, 4, 64), device=dev)
    k = torch.zeros((2, 16, 2, 64), device=dev)
    ln = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):      # int64 lengths
        da_ops.decode_attention(q, k, k, ln.long())
    with pytest.raises(ValueError):      # non-contiguous cache
        da_ops.decode_attention(q, k.transpose(1, 2), k.transpose(1, 2), ln)
    with pytest.raises(ValueError):      # D > 256
        da_ops.decode_attention(torch.zeros((2, 4, 512), device=dev),
                                torch.zeros((2, 16, 2, 512), device=dev),
                                torch.zeros((2, 16, 2, 512), device=dev), ln)
    with pytest.raises(ValueError, match="16 bytes"):   # 34 floats a row
        da_ops.decode_attention(torch.zeros((2, 4, 34), device=dev),
                                torch.zeros((2, 16, 2, 34), device=dev),
                                torch.zeros((2, 16, 2, 34), device=dev), ln)
    with pytest.raises(ValueError, match="16 bytes"):   # k off 16 bytes
        kk = torch.zeros(2 * 16 * 2 * 64 + 1, device=dev)[1:]
        da_ops.decode_attention(q, kk.view(2, 16, 2, 64), k, ln)
    with pytest.raises(ValueError):      # v's dtype differs from k's
        fp_ops.flash_prefill(q[:, None], k, k.half())


def _engine_logits(cfg, model, dev, plain: bool) -> torch.Tensor:
    """Three prompts admitted, then 10 decode steps (the engine's decode
    graph); after each step the logits of one more decode of a copy of the
    cache (the eager body: the graph steps the engine's own cache)."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n in (80, 12, 40)]
    eng = ServingEngine(cfg, model, max_batch=4, max_len=128, device=dev,
                        plain_kernels=plain)
    logits = []
    for i, p in enumerate(prompts):
        eng.admit(Request(i, 0, p, 12))
    for _ in range(10):
        eng.step()
        logits.append(eng._decode_eager(
            torch.zeros((4, 1), dtype=torch.long, device=dev),
            torch.as_tensor(eng.lengths, device=dev),
            [tuple(t.clone() for t in kv) for kv in eng.cache]))
    return torch.stack(logits).float()


def test_serving_engine_kernels_match_plain(dev):
    """Reduced gemma3 in bf16 on the card: logits of every prefill and
    decode through the kernels within one bf16 ulp of their scale of the
    same engine through the plain versions."""
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.models import transformer as T
    cfg = get_reduced_config("gemma3-12b", dtype="bfloat16")
    model = T.init_model(0, cfg, device=dev)
    out = [_engine_logits(cfg, model, dev, plain) for plain in (False, True)]
    diff = (out[0] - out[1]).abs()
    assert bool((diff <= 0.0625 + 1e-2 * out[1].abs()).all()), \
        float(diff.max())


# --- SSD scan (the JAX test's measure: max-abs error over the output's
# max-abs, 2e-3 float32, 1e-1 bf16) ----------------------------------------

SSD_CASES = [
    # Bsz, L, H, P, G, N, dtype: tests/test_kernels.py:88-94, then mamba2's
    # 2000-token prefill (a ragged last chunk) and a ragged case with P not
    # a multiple of the kernel's 16 columns, G = 3 and N = 256; then bf16
    # at Bsz = 2, at G = 2 with N = 256, and below one 128-token chunk
    (2, 256, 4, 64, 1, 128, torch.float32),
    (1, 100, 3, 32, 1, 64, torch.float32),
    (2, 128, 8, 64, 2, 128, torch.float32),
    (1, 512, 4, 64, 1, 128, torch.bfloat16),
    (1, 2000, 48, 64, 1, 128, torch.bfloat16),
    (3, 77, 6, 40, 3, 256, torch.float32),
    (2, 300, 8, 64, 1, 128, torch.bfloat16),
    (1, 300, 8, 64, 2, 256, torch.bfloat16),
    (1, 64, 48, 64, 1, 128, torch.bfloat16),
]
# the tensor-core kernel against its chunked mirror (ref.ssd_scan_chunked:
# the same rounding points, so only float32 summation order and the bf16
# roundings it flips differ): a few bf16 ulps of the output's max-abs
SSD_MIRROR_TOL = 2e-2


def _ssd_rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / (want.float().abs().max() + 1e-9))


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_kernel_matches_plain(dev, case):
    Bz, L, H, P, G, N, dt = case
    g = torch.Generator(device=dev).manual_seed(L)
    x = (0.5 * torch.randn((Bz, L, H, P), generator=g, device=dev)).to(dt)
    a = 0.7 + 0.299 * torch.rand((Bz, L, H), generator=g, device=dev)
    B = (0.3 * torch.randn((Bz, L, G, N), generator=g, device=dev)).to(dt)
    C = (0.3 * torch.randn((Bz, L, G, N), generator=g, device=dev)).to(dt)
    before, by_path = ssd_ops.LAUNCHES, dict(ssd_ops.LAUNCHES_BY_PATH)
    y, s = ssd_ops.ssd_scan(x, a, B, C)
    assert ssd_ops.LAUNCHES == before + 1
    path = "tensor_core" if dt == torch.bfloat16 else "cuda_core"
    by_path[path] += 1
    assert ssd_ops.LAUNCHES_BY_PATH == by_path
    yr, sr = ssd_ops.ssd_scan_plain(x, a, B, C)
    torch.cuda.synchronize()
    assert y.dtype == dt and s.dtype == torch.float32
    tol = 1e-1 if dt == torch.bfloat16 else 2e-3
    for got, want in ((y, yr), (s, sr)):
        assert _ssd_rel(got, want) < tol
    if dt == torch.bfloat16:
        ym, sm = ssd_ref.ssd_scan_chunked(x, a, B, C)
        assert _ssd_rel(y, ym) < SSD_MIRROR_TOL
        assert _ssd_rel(s, sm) < SSD_MIRROR_TOL


def test_ssd_scan_kernel_strong_decay_stays_finite(dev):
    """Decays down to 1e-30 (exp of the cumulative log decay underflows)
    and up to 1: finite, and within the float32 limit of the plain
    version."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, 300, 4, 64), generator=g, device=dev)
    a = torch.rand((1, 300, 4), generator=g, device=dev) ** 8
    B = torch.randn((1, 300, 2, 128), generator=g, device=dev)
    C = torch.randn((1, 300, 2, 128), generator=g, device=dev)
    y, s = ssd_ops.ssd_scan(x, a, B, C)
    yr, sr = ssd_ops.ssd_scan_plain(x, a, B, C)
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    assert float((y - yr).abs().max() / yr.abs().max()) < 2e-3
    assert float((s - sr).abs().max() / sr.abs().max()) < 2e-3


def test_ssd_scan_kernel_bf16_strong_decay(dev):
    """bf16 on the tensor cores with decays down to 1e-30: chunks whose
    decay spans more than 2^120 take the per-entry exponential; finite, and
    within the bf16 limit of the plain version and the mirror's."""
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((1, 300, 4, 64), generator=g, device=dev).bfloat16()
    a = torch.rand((1, 300, 4), generator=g, device=dev) ** 8
    B = torch.randn((1, 300, 2, 128), generator=g, device=dev).bfloat16()
    C = torch.randn((1, 300, 2, 128), generator=g, device=dev).bfloat16()
    by_path = dict(ssd_ops.LAUNCHES_BY_PATH)
    y, s = ssd_ops.ssd_scan(x, a, B, C)
    assert ssd_ops.LAUNCHES_BY_PATH["tensor_core"] == \
        by_path["tensor_core"] + 1
    yr, sr = ssd_ops.ssd_scan_plain(x, a, B, C)
    ym, sm = ssd_ref.ssd_scan_chunked(x, a, B, C)
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(s).all())
    assert _ssd_rel(y, yr) < 1e-1 and _ssd_rel(s, sr) < 1e-1
    assert _ssd_rel(y, ym) < SSD_MIRROR_TOL
    assert _ssd_rel(s, sm) < SSD_MIRROR_TOL


@pytest.mark.parametrize("x_dt,bc_dt,path", [
    (torch.bfloat16, torch.bfloat16, "tensor_core"),
    (torch.float32, torch.float32, "cuda_core"),
    (torch.bfloat16, torch.float32, "cuda_core"),
    (torch.float32, torch.bfloat16, "cuda_core"),
])
def test_ssd_scan_path_follows_operand_types(dev, x_dt, bc_dt, path):
    """bf16 x, B and C launch the tensor-core kernel, anything else the
    CUDA-core one: one launch on one path a call."""
    assert ssd_ops.kernel_path(x_dt, bc_dt) == path
    x = torch.ones((1, 40, 2, 16), device=dev).to(x_dt)
    a = torch.full((1, 40, 2), 0.9, device=dev)
    B = torch.ones((1, 40, 1, 8), device=dev).to(bc_dt)
    before, by_path = ssd_ops.LAUNCHES, dict(ssd_ops.LAUNCHES_BY_PATH)
    ssd_ops.ssd_scan(x, a, B, B)
    by_path[path] += 1
    assert ssd_ops.LAUNCHES == before + 1
    assert ssd_ops.LAUNCHES_BY_PATH == by_path


def test_ssd_scan_kernel_rejects_bad_inputs(dev):
    x = torch.zeros((1, 8, 4, 16), device=dev)
    a = torch.ones((1, 8, 4), device=dev)
    B = torch.zeros((1, 8, 1, 16), device=dev)
    with pytest.raises(ValueError):      # float16 x
        ssd_ops.ssd_scan(x.half(), a, B, B)
    with pytest.raises(ValueError):      # rank 3 x
        ssd_ops.ssd_scan(x[0], a, B, B)
    with pytest.raises(ValueError):      # G = 3 does not divide H = 4
        B3 = torch.zeros((1, 8, 3, 16), device=dev)
        ssd_ops.ssd_scan(x, a, B3, B3)
    with pytest.raises(ValueError):      # bf16 decay
        ssd_ops.ssd_scan(x, a.bfloat16(), B, B)
    with pytest.raises(ValueError):      # C's dtype differs from B's
        ssd_ops.ssd_scan(x, a, B, B.bfloat16())
    with pytest.raises(ValueError):      # non-contiguous B
        Bt = torch.zeros((1, 16, 1, 8), device=dev).transpose(1, 3)
        ssd_ops.ssd_scan(x, a, Bt, Bt)


def test_serving_engine_mamba2_kernels_match_plain(dev):
    """Reduced mamba2 in bf16 on the card (the full config's layout, no
    MLP): logits through the SSD-scan kernel within one bf16 ulp of their
    scale of the same engine through the plain scan, and one kernel launch
    per layer per prefill."""
    import dataclasses
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(
        get_reduced_config("mamba2-780m", dtype="bfloat16"), d_ff=0)
    model = T.init_model(0, cfg, device=dev)
    before, tc = ssd_ops.LAUNCHES, ssd_ops.LAUNCHES_BY_PATH["tensor_core"]
    kern = _engine_logits(cfg, model, dev, False)
    assert ssd_ops.LAUNCHES - before == 3 * cfg.n_layers
    assert ssd_ops.LAUNCHES_BY_PATH["tensor_core"] - tc == 3 * cfg.n_layers
    plain = _engine_logits(cfg, model, dev, True)
    assert ssd_ops.LAUNCHES - before == 3 * cfg.n_layers
    diff = (kern - plain).abs()
    assert bool((diff <= 0.0625 + 1e-2 * plain.abs()).all()), \
        float(diff.max())


def _shadowed_engine_calls(cfg, model, dev) -> tuple:
    """Three prompts admitted and 10 decode steps (the eager body) through
    the kernels, each call's logits beside the plain versions' on a copy
    of the cache it started from, on the MoE routing the kernels' call
    chose (``RoutingTape``; a recurrent state carries rounding forward, so
    two independent runs would drift apart).  Returns the (kernels, plain)
    logit pairs and the tape's report."""
    from repro_torch.models import routing, transformer as T
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    eng = ServingEngine(cfg, model, max_batch=4, max_len=128, device=dev)
    tape = routing.RoutingTape(model)
    pairs = []
    pre, dec = eng._prefill, eng._decode_eager

    def shadowed(kind, call, plain_call, cache, *args, after=()):
        snap = [tuple(t.clone() for t in kv) for kv in cache]
        tape.record()
        out = call(*args, cache, *after)
        tape.replay()
        want = plain_call(model, *args, snap, *after, plain=True)
        tape.stop()
        pairs.append((out[0], want[0]) if kind == "prefill" else (out, want))
        return out
    eng._prefill = lambda tok, c, fe=None: shadowed(
        "prefill", pre, T.prefill, c, tok, after=(fe,))
    eng._decode = lambda tok, ln, c: shadowed("decode", dec, T.decode_step,
                                              c, tok, ln)
    rng = np.random.default_rng(0)
    for i, n in enumerate((80, 12, 40)):
        eng.admit(Request(i, 0, list(rng.integers(0, cfg.vocab, n)), 12),
                  chip_smoke._frontends(cfg, 1, dev, seed=i)[0])
    for _ in range(10):
        eng.step()
    tape.remove()
    return pairs, tape.report()


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mixtral-8x22b"])
def test_serving_engine_rglru_and_moe_kernels_match_plain(dev, arch):
    """Reduced recurrentgemma / mixtral in bf16 on the card: every prefill's
    and decode's logits through the kernels (decode attention and flash
    prefill at G = 4 on one KV head) within one bf16 ulp of their scale of
    the plain versions on the same cache and MoE routing."""
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.models import transformer as T
    cfg = get_reduced_config(arch, dtype="bfloat16")
    model = T.init_model(0, cfg, device=dev)
    before = fp_ops.LAUNCHES
    pairs, routing = _shadowed_engine_calls(cfg, model, dev)
    n_attn = sum(k in T.ATTN_KINDS for k in cfg.layer_kinds())
    assert fp_ops.LAUNCHES - before == 3 * n_attn
    assert len(pairs) == 13
    for got, want in pairs:
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= 0.0625 + 1e-2 * want.float().abs()).all()), \
            (float(diff.max()), routing)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_serving_engine_frontend_kernels_match_plain(dev, arch):
    """Reduced llama-3.2-vision / seamless in bf16 on the card, with the
    smoke's live gates, biases and norms (``chip_smoke._liven``),
    each request with its frontend embeddings: every prefill's and
    decode's logits through the kernels (flash prefill non-causal against
    16 memory rows, and over the encoder's 16 frames; decode attention
    over the memory) within one bf16 ulp of their scale of the plain
    versions on the same cache; the flash-prefill launches counted by
    mask."""
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.models import transformer as T
    cfg = get_reduced_config(arch, dtype="bfloat16")
    model = T.init_model(0, cfg, device=dev)
    chip_smoke._liven(model, 0)
    masks = dict(fp_ops.LAUNCHES_BY_MASK)
    pairs, _ = _shadowed_engine_calls(cfg, model, dev)
    assert {k: fp_ops.LAUNCHES_BY_MASK[k] - masks[k] for k in masks} == \
        chip_smoke.prefill_masks(cfg, (80, 12, 40))
    assert len(pairs) == 13
    for got, want in pairs:
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= 0.0625 + 1e-2 * want.float().abs()).all()), \
            float(diff.max())


def test_moe_decode_form_matches_grouped_on_card(dev):
    """The reduced bf16 mixtral's MoE layer on a decode step's 8 tokens:
    the fixed-shape form (every expert, unrouted outputs dropped) within
    one bf16 ulp of the output's scale of the grouped form, on the same
    routing."""
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.models import transformer as T
    cfg = get_reduced_config("mixtral-8x22b", dtype="bfloat16")
    moe = T.init_model(0, cfg, device=dev).blocks[0].ffn
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((8, 1, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    dense, grouped = moe.all_experts(x).float(), moe.grouped(x).float()
    scale = float(grouped.abs().max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert bool(((dense - grouped).abs() <= ulp + 1e-2 * grouped.abs()
                 ).all()), float((dense - grouped).abs().max())


# --- training: the flash-attention backward kernel and the train step ------

@pytest.mark.parametrize("n", range(len(fp_rehearse.BACKWARD_CASES)))
def test_flash_backward_kernel_matches_plain(dev, n):
    """The backward kernel's dq, dk, dv and the forward kernel's LSE
    against the plain versions on the same inputs, at every
    ``rehearse.BACKWARD_CASES`` row (starcoder2-3b's and gemma3-12b's
    shapes, a chunked mask, a ragged 1000, seamless's non-causal G = 1, a
    cross case, float32, rows that reach no key; in bf16 D 256 off
    gemma3's shape, D 80 and 200, G = 5 in uneven head slices, B = 2, a
    chunk across tiles): within ``rehearse.LSE_TOL`` / ``GRAD_RTOL``;
    ``BACKWARD_LAUNCHES`` launches on the backward kernels of
    ``backward_path`` (tensor cores for bf16, three; CUDA cores for
    float32, two)."""
    case = fp_rehearse.BACKWARD_CASES[n]
    bpath = fp_ops.backward_path(getattr(torch, case[-1]), case[4])
    before = dict(fp_ops.LAUNCHES_BY_PATH)
    fp_rehearse.check_backward(case, dev, n)
    before["backward_" + bpath] += fp_ops.BACKWARD_LAUNCHES[bpath]
    before["tensor_core" if case[-1] == "bfloat16" else "cuda_core"] += 1
    assert fp_ops.LAUNCHES_BY_PATH == before


@pytest.mark.parametrize("n", [
    i for i, case in enumerate(fp_rehearse.BACKWARD_CASES)
    if case[-1] == "bfloat16"])
def test_flash_backward_bitwise_repeatable(dev, n):
    """Two calls of the tensor-core backward on the same inputs give
    bitwise-equal dq, dk and dv at every bf16 ``BACKWARD_CASES`` row (the
    head slices' partial sums are added in a fixed order; no atomics)."""
    assert fp_rehearse.check_deterministic(fp_rehearse.BACKWARD_CASES[n],
                                           dev, 100 + n)


def _train_batch(cfg, dev, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, (2, 40)), device=dev),
        "mask": torch.ones((2, 40), dtype=torch.int32, device=dev)}
    if cfg.frontend:
        batch["frontend"] = torch.as_tensor(rng.standard_normal(
            (2, cfg.frontend_len, cfg.frontend_dim), dtype=np.float32),
            device=dev)
    return batch


@pytest.mark.parametrize("arch", ["starcoder2-3b", "seamless-m4t-medium",
                                  "recurrentgemma-9b", "mixtral-8x22b"])
def test_train_step_kernels_match_plain_on_card(dev, arch):
    """One ``train_step`` of the reduced float32 config (live gates, biases
    and norms, ``chip_smoke._liven``) through the kernels (the float32
    flash forward and backward kernels; seamless's non-causal encoder and
    cross-attention backward) against one through the plain versions from
    the same weights (mixtral on the same MoE routing): the loss within
    1e-5, each gradient within 1e-4 relative Frobenius error (or 1e-6
    absolute: a key bias's gradient is zero in exact arithmetic), each
    updated element within 2.5 learning rates; the flash forward kernel
    launched twice a decoder attention (remat recomputes it) and once an
    encoder layer, the float32 backward kernels
    ``BACKWARD_LAUNCHES["cuda_core"]`` times (dQ, then dK and dV) an
    attention."""
    import copy
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.models.routing import RoutingTape
    from repro_torch.training import optimizer as opt, train as TR
    cfg = get_reduced_config(arch)
    model = T.init_model(0, cfg, device=dev, train=True)
    chip_smoke._liven(model, 1)
    plain = copy.deepcopy(model)
    batch = _train_batch(cfg, dev)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    tapes = [RoutingTape(m) for m in (model, plain)] if cfg.n_experts \
        else None
    per = chip_smoke.attention_launches(cfg)
    n_attn = per["causal"] + per["encoder"] + per["memory"]
    # remat recomputes the decoder's attention; the encoder runs once
    n_fwd = 2 * (per["causal"] + per["memory"]) + per["encoder"]
    metrics = []
    for i, m in enumerate((model, plain)):
        if tapes and i == 0:
            tapes[0].record()
        elif tapes:
            # the kernels' routing, the forward's and remat's recompute's
            tapes[1].tape = tapes[0].tape
            tapes[1].replay()
        before = dict(fp_ops.LAUNCHES_BY_PATH)
        step = TR.make_train_step(cfg, ocfg, remat=True, plain=i == 1)
        metrics.append(step(m, opt.init(dict(m.named_parameters())),
                            batch)[2])
        got = {k: fp_ops.LAUNCHES_BY_PATH[k] - before[k] for k in before}
        want = dict(tensor_core=0, cuda_core=n_fwd,
                    backward_tensor_core=0,
                    backward_cuda_core=fp_ops.BACKWARD_LAUNCHES["cuda_core"]
                    * n_attn)
        assert got == (want if i == 0 else {k: 0 for k in want})
        if tapes and i == 1:
            tapes[1].stop()
    torch.cuda.synchronize()
    assert float(metrics[0]["loss"]) == pytest.approx(
        float(metrics[1]["loss"]), rel=1e-5)
    lr = float(metrics[0]["lr"])
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 plain.named_parameters()):
        err = float((p.grad - q.grad).norm())
        assert err <= 1e-4 * float(q.grad.norm()) or err <= 1e-6, name
        assert float((p - q).abs().max()) <= 2.5 * lr, name


def test_ssd_training_refused_on_card(dev, monkeypatch):
    """mamba2's ssd layers have no SSD-scan backward: on the card a graph
    that needs their gradient raises (never a silently constant output),
    and the launcher refuses the arch before building a model; serving
    (no grad) and the plain scan (``plain=True``) still run."""
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.launch import train as LT
    from repro_torch.models import transformer as T
    from repro_torch.training import train as TR
    cfg = get_reduced_config("mamba2-780m")
    model = T.init_model(0, cfg, device=dev, train=True)
    batch = _train_batch(cfg, dev)
    with pytest.raises(RuntimeError, match="SSD-scan kernel has no backward"):
        TR.loss_fn(model, batch)
    with torch.no_grad():
        logits, _ = T.forward(model, batch["tokens"])
    loss, _ = TR.loss_fn(model, batch, plain=True)
    loss.backward()
    assert torch.isfinite(logits).all() and torch.isfinite(loss)

    def built(*_, **__):
        raise AssertionError("a model was built")
    monkeypatch.setattr(LT.T, "init_model", built)
    with pytest.raises(ValueError, match="SSD-scan"):
        LT.train(LT.parser().parse_args(["--arch", "mamba2-780m"]),
                 device=dev)
