"""Port parity: ``repro_torch.core.engine.run_window`` against
``repro.core.engine.run_window`` on the same numpy traces — every carry
leaf (counters, completion ring, queues, lanes, bucket state, LCG) bitwise,
across shaping modes, arbiters, accelerators and resumed windows."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _engine_cases import (CASES, DEFAULT_SYSTEM, N_TICKS, case_hints,
                           case_link, port_scenario)
from _torch_parity import (assert_bitwise, assert_carry_equal, port_cfg,
                           port_flows)
from repro.core import baselines as jb, engine as je, token_bucket as jtb
from repro.core.accelerator import CATALOG, AccelTable
from repro.core.flow import SLO, FlowSet, FlowSpec, Path, TrafficPattern
from repro.core.interconnect import (ARB_PRIORITY, ARB_RR, ARB_WFQ, ARB_WRR,
                                     LinkSpec, ResourceSpec, mem_bw)
from repro.core.sim import SHAPING_SW, SimConfig, gen_arrivals, gen_stall_mask
from repro_torch.core import accelerator as tacc, engine as te
from repro_torch.core import interconnect as tic, token_bucket as ttb
from repro_torch.kernels.token_bucket import ops as tb_ops


def _scenario(shaping, arbiter, n_flows=2, system=None, load=0.9, msg=1500,
              msg2=0, p2=0.0, accels=("ipsec32",), cfg=None, n_ticks=N_TICKS,
              seed=3, paths=(Path.FUNCTION_CALL, Path.INLINE_NIC_RX),
              slo="gbps", resources=(), hint=None):
    """A case of ``_engine_cases.CASES`` built with the JAX package (the
    accelerator table with both): flow i takes ``paths[i % len(paths)]``
    and SLO ``8 (i + 1)`` Gbps, or with ``slo="iops"`` ``400,000 (i + 1)``
    IOPS, under the registers that SLO plans (``resources`` and ``hint``:
    ``_engine_cases.case_hints``)."""
    if slo == "gbps":
        slos = [SLO.gbps(8.0 * (i + 1)) for i in range(n_flows)]
        plans = [jtb.params_for_gbps(s.target) for s in slos]
    else:
        slos = [SLO.iops(400_000.0 * (i + 1)) for i in range(n_flows)]
        plans = [jtb.params_for_iops(s.target) for s in slos]
    specs = [FlowSpec(i, i, Path(int(paths[i % len(paths)])),
                      i % len(accels),
                      TrafficPattern(msg, load=load, process="poisson",
                                     msg_bytes2=msg2, p2=p2),
                      slos[i], priority=i, weight=1.0 + i, res_demand=h)
             for i, h in enumerate(case_hints(n_flows, resources, hint))]
    flows = FlowSet.build(specs)
    sim_cfg = SimConfig(n_ticks=n_ticks, shaping=shaping, arbiter=arbiter,
                        **(cfg or {}))
    arr = gen_arrivals(flows, sim_cfg, seed=seed,
                       load_ref_gbps={i: 40.0 for i in range(n_flows)})
    tbs = jb.make_tb_state(getattr(jb, system or DEFAULT_SYSTEM[shaping]),
                           plans)
    stall = None
    if shaping == SHAPING_SW:
        # host-descheduling bursts of 6..31 ticks, a few per window
        stall = gen_stall_mask(sim_cfg, seed=1, stall_rate_hz=500_000.0,
                               stall_us=(0.2, 1.0))
        assert stall.any()
    jtab = AccelTable.build([CATALOG[a] for a in accels])
    ttab = tacc.AccelTable.build([tacc.CATALOG[a] for a in accels])
    return flows, jtab, ttab, sim_cfg, tbs, arr, stall


def _port_tb(tbs):
    return ttb.TBState(*(np.asarray(x) for x in tbs))


def _run_both(flows, jtab, ttab, cfg, tbs, arr, stall, *, t0=0,
              carries=(None, None), case=None):
    case = case or {}
    c_ref = je.run_window(flows, jtab, case_link(case, LinkSpec,
                                                 ResourceSpec),
                          cfg, tbs, *arr, stall, t0_ticks=t0,
                          carry=carries[0])
    c_port = te.run_window(port_flows(flows), ttab,
                           case_link(case, tic.LinkSpec, tic.ResourceSpec),
                           port_cfg(cfg), _port_tb(tbs), *arr, stall,
                           t0_ticks=t0, carry=carries[1], device="cpu")
    return c_ref, c_port


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_window_matches_reference(case):
    flows, jtab, ttab, cfg, tbs, arr, stall = _scenario(**CASES[case])
    c_ref, c_port = _run_both(flows, jtab, ttab, cfg, tbs, arr, stall,
                              case=CASES[case])
    host = jax.device_get(c_ref)
    assert int(host["comp_n"]) > 0 and host["c_adm_msgs"].sum() > 0
    assert_carry_equal(host, te.carry_to_numpy(c_port))


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_scenario_matches_reference_scenario(case):
    """The card tests' scenarios (built with the port alone) are the CPU
    parity tests' scenarios: the same flow tables, bucket registers,
    arrival traces, stall mask and config."""
    flows, _, ttab, cfg, tbs, arr, stall = _scenario(**CASES[case])
    p_flows, p_tab, p_cfg, p_tbs, p_arr, p_stall = port_scenario(
        **CASES[case])
    assert p_cfg == port_cfg(cfg)
    assert [dataclasses.asdict(s) for s in p_flows.specs] == \
        [dataclasses.asdict(s) for s in port_flows(flows).specs]
    for a, b in zip(tbs, p_tbs):
        assert_bitwise(np.asarray(a), b.numpy())
    for a, b in zip(arr, p_arr):
        assert_bitwise(a, b)
    assert (stall is None) == (p_stall is None)
    if stall is not None:
        np.testing.assert_array_equal(stall, p_stall)
    assert_bitwise(np.asarray(ttab.service_cycles),
                   np.asarray(p_tab.service_cycles))


def _two_windows(case):
    flows, jtab, ttab, cfg, tbs, arr, stall = _scenario(
        **CASES[case], n_ticks=2 * 150)
    return flows, jtab, ttab, dataclasses.replace(cfg, n_ticks=150), tbs, \
        arr, stall


def test_register_write_on_resume_matches_reference():
    """Window 2 resumes the carry with new registers (a live MMIO write:
    tokens clamp to the new bucket, timers keep running)."""
    flows, jtab, ttab, cfg, tbs, arr, stall = _two_windows("hw_rr")
    c_ref, c_port = _run_both(flows, jtab, ttab, cfg, tbs, arr, stall)
    tbs2 = jtb.pack([jtb.params_for_gbps(3.0), jtb.params_for_gbps(30.0)])
    c_ref, c_port = _run_both(flows, jtab, ttab, cfg, tbs2, arr, stall,
                              t0=150, carries=(c_ref, c_port))
    assert_carry_equal(jax.device_get(c_ref), te.carry_to_numpy(c_port))


@pytest.mark.parametrize("case", ["hw_rr", "sw_stall"])
def test_resume_jax_carry_in_port(case):
    """A carry the JAX engine produced (fetched with jax.device_get)
    resumes in the port and continues bit for bit."""
    flows, jtab, ttab, cfg, tbs, arr, stall = _two_windows(case)
    c1 = je.run_window(flows, jtab, LinkSpec(), cfg, tbs, *arr, stall)
    c1_host = jax.device_get(c1)
    c_port = te.carry_from_numpy(c1_host, device="cpu")
    assert_carry_equal(c1_host, te.carry_to_numpy(c_port))
    c_ref, c_port = _run_both(flows, jtab, ttab, cfg, tbs, arr, stall,
                              t0=150, carries=(c1, c_port))
    assert_carry_equal(jax.device_get(c_ref), te.carry_to_numpy(c_port))


def test_resource_vector_not_ported_yet():
    """(Named for the refusal it replaces: the port used to reject
    ``LinkSpec.resources``.)  A window on a link with a tight memory-
    bandwidth axis, resumed for a second window with new registers,
    equals the reference's carry bit for bit, the axes' residue
    ``res_res`` included, and the axis does charge."""
    flows, jtab, ttab, cfg, tbs, arr, stall = _two_windows("hw_rr")
    case = dict(resources=(("mem_bw", 8.0, 0, False),))
    c_ref, c_port = _run_both(flows, jtab, ttab, cfg, tbs, arr, stall,
                              case=case)
    assert mem_bw(8.0) == case_link(case, LinkSpec, ResourceSpec).resources[0]
    tbs2 = jtb.pack([jtb.params_for_gbps(3.0), jtb.params_for_gbps(30.0)])
    c_ref, c_port = _run_both(flows, jtab, ttab, cfg, tbs2, arr, stall,
                              t0=150, carries=(c_ref, c_port), case=case)
    host = jax.device_get(c_ref)
    assert host["res_res"].shape == (1,) and host["res_res"][0] < 0.0
    assert_carry_equal(host, te.carry_to_numpy(c_port))


def test_entry_points_default_to_cuda():
    """Without an explicit device the port runs on the card; with no card
    it raises instead of carrying on on the host."""
    flows, jtab, ttab, cfg, tbs, arr, stall = _scenario(
        **CASES["hw_rr"], n_ticks=10)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        te.run_window(port_flows(flows), ttab, tic.LinkSpec(),
                      port_cfg(cfg), _port_tb(tbs), *arr)


@pytest.mark.parametrize("case", ["hw_rr", "sw_stall"])
def test_tick_issues_no_host_sync(case):
    """No op of the tick reads a tensor back to the host (``item`` is what
    indexing with a 0-dim tensor or a Python branch on one would call)."""
    flows, jtab, ttab, cfg, tbs, arr, stall = _scenario(**CASES[case])
    cfg = dataclasses.replace(cfg, n_ticks=15)     # the profiler is slow
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        te.run_window(port_flows(flows), ttab, tic.LinkSpec(),
                      port_cfg(cfg), _port_tb(tbs), *arr, stall,
                      device="cpu")
    names = {e.name for e in prof.events()}
    assert "aten::item" not in names and \
        "aten::_local_scalar_dense" not in names


def test_host_delay_matches_compiled_reference():
    """Every value the LCG can draw (u = k / 65536) goes through the
    reference's host-delay expression under jit and through the port's,
    bitwise; the unfused float32 form differs on some of them."""
    u = np.arange(65536, dtype=np.float32) / np.float32(65536.0)
    f = jax.jit(lambda u, d, j: d + (u ** 4) * j)
    for delay, jit_ in ((500, 2500), (100, 800), (0, 1), (12345, 99999)):
        want = np.asarray(f(u, jnp.float32(delay), jnp.float32(jit_)))
        got = te._host_delay(torch.as_tensor(u), te._f32(jit_),
                             te._f32(delay)).numpy()
        assert_bitwise(want, got, f"host delay {delay}+{jit_}")
    u2 = u * u
    unfused = np.float32(500) + (u2 * u2) * np.float32(2500)
    assert (unfused != f(u, jnp.float32(500), jnp.float32(2500))).any()


@pytest.mark.parametrize("arb", [ARB_RR, ARB_WRR, ARB_WFQ, ARB_PRIORITY])
def test_arbiter_key_matches_compiled_reference(arb):
    """The reference's arbiter-key expression under jit against the port's,
    bitwise, over virtual finish times of every magnitude the engine
    accumulates; the unfused float32 form differs on some of them."""
    rng = np.random.default_rng(arb)
    n = 200_000
    rr_key = rng.integers(0, 16, n).astype(np.float32)
    vft = (rng.random(n) * 10.0 ** rng.integers(-4, 7, n)).astype(np.float32)
    prio = rng.integers(0, 8, n).astype(np.float32)
    f = jax.jit(lambda arb, p, rk, v: jnp.where(
        arb == ARB_RR, rk, jnp.where(arb == ARB_PRIORITY, -p * 1e6 + rk,
                                     v + 1e-6 * rk)))
    want = np.asarray(f(jnp.int32(arb), prio, rr_key, vft))
    got = tb_ops.arb_key(arb, torch.as_tensor(rr_key), torch.as_tensor(prio),
                      torch.as_tensor(vft)).numpy()
    assert_bitwise(want, got, f"arbiter {arb}")
    if arb in (ARB_WRR, ARB_WFQ):
        assert (vft + np.float32(1e-6) * rr_key != want).any()


# --- the compile cache: buffers, keys and the device clock ------------------


def _leaves(carry):
    return {f"{k}.{i}" if k == "tb" else k: x for k, v in carry.items()
            for i, x in (enumerate(v) if k == "tb" else [(0, v)])}


@pytest.mark.parametrize("case", ["hw_rr", "sw_stall"])
def test_tick_keeps_every_carry_tensor_in_place(case):
    """A tick changes no carry tensor's identity or address and adds no
    key (a CUDA graph of it reads and writes fixed buffers), and advances
    the device clock by one."""
    flows, atab, cfg, tbs, arr, stall = port_scenario(**CASES[case])
    args, carry = te._prepare(flows, atab, tic.LinkSpec(), cfg, tbs, *arr,
                              stall, 0, None, "cpu")
    before = _leaves(carry)
    ptrs = {k: x.data_ptr() for k, x in before.items()}
    clock = torch.tensor([7, 0], dtype=torch.int32)
    for _ in range(cfg.n_ticks):
        te._tick(cfg, args, carry, clock)
    after = _leaves(carry)
    assert after.keys() == before.keys()
    assert all(after[k] is x for k, x in before.items())
    assert {k: x.data_ptr() for k, x in after.items()} == ptrs
    assert clock.tolist() == [7 + cfg.n_ticks, cfg.n_ticks]
    assert int(carry["c_adm_msgs"].sum()) > 0


def _two_port_windows(case, tbs2=None, link=None, n=80):
    """The arguments of two windows of ``n`` ticks of a case, the second
    resumed with ``tbs2``'s registers written."""
    flows, atab, cfg, tbs, arr, stall = port_scenario(**CASES[case],
                                                      n_ticks=2 * n)
    cfg = dataclasses.replace(cfg, n_ticks=n)
    link = link or tic.LinkSpec()
    return [((flows, atab, link, cfg, regs, *arr, stall), t0)
             for t0, regs in ((0, tbs), (n, tbs if tbs2 is None else tbs2))]


def _step(run, window, carry):
    """One window through ``run`` (``run_window`` or the eager body)."""
    args, t0 = window
    return run(*args, t0_ticks=t0, carry=carry, device="cpu")


def _solo(run, windows) -> dict:
    carry = None
    for w in windows:
        carry = _step(run, w, carry)
    return te.carry_to_numpy(carry)


def _assert_same(want: dict, got: dict) -> None:
    """Two port carries (``carry_to_numpy``) equal bit for bit."""
    assert want.keys() == got.keys()
    for k, v in want.items():
        for i, (a, b) in enumerate(zip(v, got[k]) if k == "tb"
                                   else [(v, got[k])]):
            assert_bitwise(a, b, f"{k}.{i}")


def test_two_dataplanes_of_one_signature_interleaved():
    """Two dataplanes of one signature (other registers), run window by
    window in turn through one cache entry, each equal their solo runs
    bitwise: a returned carry never aliases the other's."""
    regs = ttb.pack([ttb.params_for_gbps(3.0), ttb.params_for_gbps(30.0)])
    wins = [_two_port_windows("hw_rr"), _two_port_windows("hw_rr", regs)]
    te.cache_clear()
    carries = [None, None]
    for pair in zip(*wins):
        carries = [_step(te.run_window, w, c) for w, c in zip(pair, carries)]
    assert te.cache_info() == {"entries": 1, "traces": 1}
    both = [te.carry_to_numpy(c) for c in carries]
    for got, w in zip(both, wins):
        _assert_same(_solo(te.run_window, w), got)
    assert both[0]["tb"][0].tobytes() != both[1]["tb"][0].tobytes()


@pytest.mark.parametrize("field, value", [("credits", 2),
                                          ("msg_overhead_bytes", 900)])
def test_link_values_take_their_own_entries(field, value):
    """Windows that differ only in the link's credits or per-message
    overhead (data the tick reads from the entry's buffers, as the
    reference traces them) share one entry and one capture, and each
    equals the eager body's run of its own link."""
    wins = [_two_port_windows("hw_rr", link=lk)
            for lk in (tic.LinkSpec(), tic.LinkSpec(**{field: value}))]
    te.cache_clear()
    got = [_solo(te.run_window, w) for w in wins]
    assert te.cache_info() == {"entries": 1, "traces": 1}
    for g, w in zip(got, wins):
        _assert_same(_solo(te._run_window_eager, w), g)
    assert got[0]["c_adm_msgs"].tobytes() != got[1]["c_adm_msgs"].tobytes()


def test_short_stall_mask_raises():
    """The stall mask must cover the window (the card reads stall[t_idx]
    without a check)."""
    flows, atab, cfg, tbs, arr, stall = port_scenario(**CASES["sw_stall"])
    with pytest.raises(ValueError, match="stall mask"):
        te.run_window(flows, atab, tic.LinkSpec(), cfg, tbs, *arr,
                      stall[:-1], t0_ticks=1, device="cpu")
