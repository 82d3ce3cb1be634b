"""Port parity: ``repro_torch`` token bucket (core functions, planners and
the plain version of the Hopper kernel) against the JAX package, bitwise;
and, on the CPU, the grant-tick kernel's binding (its argument block and
mode words against the CUDA source) and its random test carries."""
import ctypes
import re

import numpy as np
import pytest
import torch

from repro.core import token_bucket as jtb
from repro.kernels.token_bucket import ops as jops, ref as jref
from repro_torch.core import token_bucket as ttb
from repro_torch.core import interconnect as tic
from repro_torch.kernels.token_bucket import ops as tops, ref as tref
from repro_torch.kernels.token_bucket import rehearse

NS = [1, 3, 1023, 1025]
ELAPSED = [0, 8, 1000, 10**7]


def _registers(n, seed, *, overflow=False):
    """Random registers (IOPS and GBPS mixed); ``overflow`` gives a quarter
    of the flows the unshaped profiling registers (refill = bkt = 2^30,
    interval 1) whose first refill wraps int32."""
    rng = np.random.default_rng(seed)
    refill = rng.integers(1, 5000, n).astype(np.int32)
    bkt = rng.integers(512, 1 << 20, n).astype(np.int32)
    interval = rng.integers(1, 1024, n).astype(np.int32)
    mode = rng.integers(0, 2, n).astype(np.int32)
    tokens = rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32)
    if overflow:
        big = rng.random(n) < 0.25
        big[0] = True
        refill[big], bkt[big], interval[big], tokens[big] = \
            2**30, 2**30, 1, 2**30
    cyc = (rng.integers(0, 1024, n) % interval).astype(np.int32)
    cost = rng.integers(1, 8192, n).astype(np.int32)
    want = rng.random(n) < 0.8
    return (tokens, cyc, refill, bkt, interval, mode), cost, want


def _port_state(regs):
    return ttb.TBState(*(torch.as_tensor(x) for x in regs))


def _jax_state(regs):
    return jtb.TBState(*(np.asarray(x) for x in regs))


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("elapsed", ELAPSED)
@pytest.mark.parametrize("n", NS)
def test_advance_and_admit_match_reference(n, elapsed, overflow):
    regs, cost, want = _registers(n, n + elapsed, overflow=overflow)
    j = jtb.advance(_jax_state(regs), elapsed)
    t = ttb.advance(_port_state(regs), elapsed)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    j2, jok = jtb.try_admit(j, cost, want)
    t2, tok = ttb.try_admit(t, cost, want)
    np.testing.assert_array_equal(np.asarray(j2.tokens), t2.tokens.numpy())
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    np.testing.assert_array_equal(
        np.asarray(jtb.cost_of(j, cost)), ttb.cost_of(t, cost).numpy())
    np.testing.assert_array_equal(
        np.asarray(jtb.consume(j, cost).tokens),
        ttb.consume(t, cost).tokens.numpy())


def test_overflow_registers_wrap_like_reference():
    """refill = bkt = 2^30: tokens + 2 * 2^30 wraps to -2^30 and back."""
    regs = ([2**30], [0], [2**30], [2**30], [1], [0])
    j, t = _jax_state(regs), _port_state(regs)
    for _ in range(4):
        j, t = jtb.advance(j, 8), ttb.advance(t, 8)
        assert int(np.asarray(j.tokens)[0]) == int(t.tokens[0])
    assert int(ttb.advance(t, 8).tokens[0]) in (-(2**30), 2**30)


def test_init_does_not_alias_bucket_size():
    """The reference's init makes tokens the very bkt_size buffer; the
    port copies, so an in-place token update leaves the register alone."""
    st = ttb.init([10], [100], [50], [ttb.MODE_GBPS])
    st.tokens.sub_(60)
    assert int(st.bkt_size[0]) == 100 and int(st.tokens[0]) == 40
    st0 = ttb.init([10], [100], [50], [ttb.MODE_GBPS], start_full=False)
    assert int(st0.tokens[0]) == 0


@pytest.mark.parametrize("slo", [0.5, 1, 3, 10, 47, 100, 400, 1000])
def test_planners_match_reference(slo):
    for clock in (250e6, 500e6):
        assert ttb.params_for_gbps(float(slo), clock).__dict__ == \
            jtb.params_for_gbps(float(slo), clock).__dict__
        iops = slo * 10_000.0
        assert ttb.params_for_iops(iops, clock).__dict__ == \
            jtb.params_for_iops(iops, clock).__dict__
    p = ttb.params_for_gbps(float(slo))
    assert ttb.achieved_rate(p) == jtb.achieved_rate(
        jtb.params_for_gbps(float(slo)))


def test_paper_table2_and_pack_match_reference():
    assert {k: v.__dict__ for k, v in ttb.PAPER_TABLE2.items()} == \
        {k: v.__dict__ for k, v in jtb.PAPER_TABLE2.items()}
    plans = [ttb.params_for_gbps(s) for s in (1.0, 10.0, 40.0)]
    jplans = [jtb.params_for_gbps(s) for s in (1.0, 10.0, 40.0)]
    for start_full in (True, False):
        t = ttb.pack(plans, start_full=start_full)
        j = jtb.pack(jplans, start_full=start_full)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
            assert b.dtype == torch.int32


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("elapsed", ELAPSED)
@pytest.mark.parametrize("n", NS)
def test_plain_kernel_matches_pallas_kernel(n, elapsed, overflow):
    """The port's plain version (what its CUDA kernel is held against on
    the card) equals the Pallas TPU kernel run in interpret mode and the
    port's own oracle, with and without admission."""
    regs, cost, want = _registers(n, 7 * n + elapsed, overflow=overflow)
    j_state, j_admit = jops.token_bucket_step(_jax_state(regs), elapsed,
                                              cost, want, interpret=True)
    before = tops.LAUNCHES
    t_state, t_admit = tops.token_bucket_step(
        _port_state(regs), elapsed, torch.as_tensor(cost),
        torch.as_tensor(want))
    assert tops.LAUNCHES == before        # CPU tensors never launch
    np.testing.assert_array_equal(np.asarray(j_state.tokens),
                                  t_state.tokens.numpy())
    np.testing.assert_array_equal(np.asarray(j_state.cyc),
                                  t_state.cyc.numpy())
    np.testing.assert_array_equal(np.asarray(j_admit), t_admit.numpy())
    r_tok, r_cyc, r_adm = tref.token_bucket_step(
        *(torch.as_tensor(x) for x in regs), elapsed, cost, want)
    np.testing.assert_array_equal(r_tok.numpy(), t_state.tokens.numpy())
    np.testing.assert_array_equal(r_cyc.numpy(), t_state.cyc.numpy())
    np.testing.assert_array_equal(r_adm.numpy(), t_admit.numpy())
    jr_tok, _, _ = jref.token_bucket_step(*regs, elapsed, cost, want)
    np.testing.assert_array_equal(np.asarray(jr_tok), r_tok.numpy())


@pytest.mark.parametrize("n", NS)
def test_plain_kernel_per_flow_elapsed_and_refill_only(n):
    """A per-flow elapsed vector (software shaping's deferred refills) and
    the refill-only call (no cost/want) agree with the reference."""
    regs, cost, want = _registers(n, 11 * n, overflow=True)
    e = np.random.default_rng(n).integers(0, 10**6, n).astype(np.int32)
    j = jtb.advance(_jax_state(regs), e)
    t, admit = tops.token_bucket_step(_port_state(regs), torch.as_tensor(e))
    assert admit is None
    np.testing.assert_array_equal(np.asarray(j.tokens), t.tokens.numpy())
    np.testing.assert_array_equal(np.asarray(j.cyc), t.cyc.numpy())
    # in place: outputs may be the input buffers
    st = _port_state(regs)
    out = (st.tokens, st.cyc)
    t2, _ = tops.token_bucket_step(st, torch.as_tensor(e), out=out)
    assert t2.tokens is st.tokens
    np.testing.assert_array_equal(t2.tokens.numpy(), t.tokens.numpy())


def _cuda_source() -> str:
    return tops._SRC.read_text()


def test_grant_args_struct_matches_cuda_source():
    """``ops.GrantTickArgs`` (ctypes) declares the fields of ``struct
    GrantTickArgs`` in ``token_bucket.cu`` in order, with the same types:
    every pointer a ``c_void_p``, ``int`` a ``c_int``, ``float`` a
    ``c_float`` (parsed from the source: there is no nvcc here)."""
    body = re.search(r"struct GrantTickArgs \{(.*?)\n\};", _cuda_source(),
                     re.S).group(1)
    fields = []
    for line in body.splitlines():
        code = line.split("//")[0].strip()
        if not code:
            continue
        m = re.fullmatch(r"(const\s+)?([\w ]+?)\s*(\*?)\s*(\w+);", code)
        assert m, code
        ctype = (ctypes.c_void_p if m.group(3) else
                 {"int": ctypes.c_int, "float": ctypes.c_float}[m.group(2)])
        fields.append((m.group(4), ctype))
    assert fields == list(tops.GrantTickArgs._fields_)
    assert len(fields) == 47


def test_grant_kernel_mode_words_match_python():
    """The shaping and arbiter words the kernel compares against are the
    engine's."""
    src = _cuda_source()
    words = dict(re.findall(r"constexpr int (SHAPING_\w+|ARB_\w+) = (\d+);",
                            src))
    expect = dict(SHAPING_NONE=tops.SHAPING_NONE, SHAPING_SW=tops.SHAPING_SW,
                  ARB_RR=tic.ARB_RR, ARB_WRR=tic.ARB_WRR,
                  ARB_PRIORITY=tic.ARB_PRIORITY, ARB_WFQ=tic.ARB_WFQ)
    assert {k: int(v) for k, v in words.items()} == expect
    assert re.search(r"constexpr float BIG = 3e38f;", src)
    assert tops.BIG == float(np.float32(3e38))


def test_grant_tick_on_cpu_runs_plain_version():
    """On a CPU carry the wrapper runs ``grant_tick_plain`` and launches
    nothing."""
    before = (tops.LAUNCHES, dict(tops.LAUNCHES_BY_PATH))
    for arbiter in (tic.ARB_RR, tic.ARB_WFQ):
        cfg, args, carry, budget, t_idx = rehearse.random_grant_inputs(
            33, arbiter, "cpu", shaping=tops.SHAPING_HW, arbiter=arbiter,
            k_grant=4)
        c1, b1 = rehearse.copy_inputs(carry, budget)
        c2, b2 = rehearse.copy_inputs(carry, budget)
        tops.grant_tick(cfg, args, c1, b1, t_idx)
        tops.grant_tick_plain(cfg, args, c2, b2, t_idx)
        assert rehearse.differing_leaves(c1, b1, c2, b2) == []
        assert rehearse.grants_made(carry, c1) > 0
    assert (tops.LAUNCHES, tops.LAUNCHES_BY_PATH) == before


def test_random_grant_inputs_reach_every_kernel_path():
    """The card tests' random carries (``rehearse.CASES`` below 1025 flows,
    run here through the plain version) grant under every shaping mode and
    arbiter, leave some iterations without a winner, grant one flow more
    often than the kernel holds queue entries ahead (``KPF`` = 4), and
    grant flows of a second warp."""
    grants = {}
    past_prefetch = second_warp = idle = False
    for case in rehearse.CASES:
        n, shaping, arbiter, k = case
        if n > 33:
            continue
        cfg, args, carry, budget, t_idx = rehearse.random_grant_inputs(
            n, n * 100 + shaping * 10 + arbiter + k * 1000, "cpu",
            shaping=shaping, arbiter=arbiter, k_grant=k)
        c, b = rehearse.copy_inputs(carry, budget)
        tops.grant_tick_plain(cfg, args, c, b, t_idx)
        per_flow = c["c_adm_msgs"] - carry["c_adm_msgs"]
        grants[shaping, arbiter] = grants.get((shaping, arbiter), 0) + \
            int(per_flow.sum())
        past_prefetch |= int(per_flow.max()) > 4
        second_warp |= bool((per_flow[..., 32:] > 0).any())
        idle |= int(per_flow.sum()) < k
    assert all(v > 0 for v in grants.values()) and len(grants) == 12
    assert past_prefetch and second_warp and idle
