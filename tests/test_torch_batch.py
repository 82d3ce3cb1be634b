"""Port parity of the batched dataplane: ``repro_torch.core.engine.
run_window_batch`` and the entry points above it (``sim.stack_arrivals`` /
``simulate_batch``, ``baselines.run_system_batch``, the profiler's
``profile_contexts`` / ``sweep`` / ``profile_contexts_multi``) against the
JAX package on the same numpy inputs, bitwise: ragged flows and
accelerators, mixed shaping modes and arbiters, stall masks, ``fl_masks``
holes, lane surgery and resumed windows (port analogues of
``tests/test_engine.py`` and ``tests/test_fleet.py``'s batch tests).

Each module's JAX runs are shared through module-scoped fixtures."""
import dataclasses

import jax
import numpy as np
import pytest

from _engine_cases import (BATCH_ELEMENTS, BATCH_HOLE, BATCH_WINDOW, CASES,
                           DEFAULT_SYSTEM, batch_masks, port_batch,
                           port_batch_registers, stack_stalls)
from _torch_parity import (assert_bitwise, assert_carry_equal,
                           assert_results_equal, port_cfg, port_flows)
from test_torch_engine import _port_tb, _scenario
from repro.core import baselines as jb, engine as je, profiler as jprof
from repro.core import sim as jsim, token_bucket as jtb
from repro.core.accelerator import CATALOG
from repro.core.flow import Path
from repro.core.interconnect import LinkSpec
from repro_torch.core import accelerator as tacc, baselines as tbl
from repro_torch.core import engine as te, interconnect as tic
from repro_torch.core import profiler as tprof, sim as tsim


def _regs2(els):
    """Second-window registers (JAX): SLOs of 4 (i + 1) Gbps."""
    return [jb.make_tb_state(getattr(jb, DEFAULT_SYSTEM[e["shaping"]]),
                             [jtb.params_for_gbps(4.0 * (i + 1))
                              for i in range(el[0].n)])
            for e, el in zip(BATCH_ELEMENTS, els)]


@pytest.fixture(scope="module")
def mixed():
    """``BATCH_ELEMENTS`` over three windows of the JAX batched engine:
    window 1 with a mid-table hole; lane ``BATCH_HOLE`` recycled and
    unmasked, then window 2 with new registers; lane 2 of element 1
    released and masked, then window 3 resumed with ``tb_states=None``.
    Host copies of the carry after each window (and after each surgery)."""
    n = 3 * BATCH_WINDOW
    els = [_scenario(**e, n_ticks=n) for e in BATCH_ELEMENTS]
    cfgs = [dataclasses.replace(el[3], n_ticks=BATCH_WINDOW) for el in els]
    arr = jsim.stack_arrivals([el[5] for el in els])
    stall = stack_stalls([el[6] for el in els], n)
    masks = [batch_masks(), batch_masks(None), batch_masks(None)]
    masks[2][1][2] = False
    regs = [[el[4] for el in els], _regs2(els), None]
    b, lane = BATCH_HOLE
    surgery = [lambda c: je.recycle_flow_lane(c, b, lane),
               lambda c: je.release_flow_lane(c, 1, 2), None]
    carry, host, after = None, [], []
    for w in range(3):
        carry = je.run_window_batch(
            [el[0] for el in els], [el[1] for el in els], LinkSpec(), cfgs,
            regs[w], *arr, stall, t0_ticks=w * BATCH_WINDOW, carry=carry,
            fl_masks=masks[w])
        host.append(jax.device_get(carry))
        if surgery[w] is not None:
            carry = surgery[w](carry)
            after.append(jax.device_get(carry))
    return dict(els=els, cfgs=cfgs, arr=arr, stall=stall, masks=masks,
                regs=regs, host=host, after=after)


def _port_args(m):
    return ([port_flows(el[0]) for el in m["els"]],
            [el[2] for el in m["els"]],
            [port_cfg(c) for c in m["cfgs"]])


def _port_regs(regs):
    return None if regs is None else [_port_tb(r) for r in regs]


def _port_window(m, w, carry, run=te.run_window_batch, link=None):
    flows, tabs, cfgs = _port_args(m)
    return run(flows, tabs, link or tic.LinkSpec(), cfgs,
               _port_regs(m["regs"][w]), *m["arr"], m["stall"],
               t0_ticks=w * BATCH_WINDOW, carry=carry,
               fl_masks=m["masks"][w], device="cpu")


def _port_surgery(w, carry):
    b, lane = BATCH_HOLE
    if w == 0:
        return te.recycle_flow_lane(carry, b, lane)
    return te.release_flow_lane(carry, 1, 2)


def test_batch_scenario_is_the_card_tests_scenario(mixed):
    """``_engine_cases.port_batch`` (what the card tests and their
    registers build with the port alone) is this module's batch."""
    flows, tabs, cfgs, regs, arr, stall = port_batch()
    assert cfgs == [port_cfg(c) for c in mixed["cfgs"]]
    assert [f.n for f in flows] == [el[0].n for el in mixed["els"]]
    for a, b in zip(arr, mixed["arr"]):
        assert_bitwise(a, b)
    np.testing.assert_array_equal(stall, mixed["stall"])
    for mine, ref in ((regs, mixed["regs"][0]),
                      (port_batch_registers(flows), mixed["regs"][1])):
        for r, p in zip(ref, mine):
            for x, y in zip(r, p):
                assert_bitwise(np.asarray(x), y.numpy())
    for t, el in zip(tabs, mixed["els"]):
        assert_bitwise(t.service_cycles, el[2].service_cycles)


def test_windows_and_lane_surgery_match_reference(mixed):
    """Three batched windows (a hole; a recycled lane and new registers; a
    released lane resumed without registers) through one cache entry equal
    the JAX batched engine's carries bitwise after every window and every
    surgery."""
    te.cache_clear()
    carry = None
    for w in range(3):
        carry = _port_window(mixed, w, carry)
        assert_carry_equal(mixed["host"][w], te.carry_to_numpy(carry))
        if w < 2:
            carry = _port_surgery(w, carry)
            assert_carry_equal(mixed["after"][w], te.carry_to_numpy(carry))
    assert te.cache_info() == {"entries": 1, "traces": 1}
    host = mixed["host"][-1]
    # every element granted and completed; the released lane and the
    # padding of element 0 stayed inert in the last window
    assert (host["c_adm_msgs"].sum(1) > 0).all() and \
        (host["comp_n"] > 0).all()
    assert (host["c_adm_msgs"][0, 1:] == 0).all()


def test_resume_jax_batched_carry_in_port(mixed):
    """A batched carry the JAX engine produced (``jax.device_get``: stacked
    [B, ...] numpy leaves) loads through ``carry_from_numpy`` and resumes in
    the port bit for bit, lane surgery included."""
    carry = te.carry_from_numpy(mixed["host"][0], device="cpu")
    assert_carry_equal(mixed["host"][0], te.carry_to_numpy(carry))
    carry = _port_window(mixed, 1, _port_surgery(0, carry))
    assert_carry_equal(mixed["host"][1], te.carry_to_numpy(carry))


def test_eager_batch_body_matches_cached_entry(mixed):
    """The batched eager body outside the cache equals the cached entry's
    window (both on the CPU) on the first window."""
    eager = _port_window(mixed, 0, None, run=te._run_window_batch_eager)
    assert_carry_equal(mixed["host"][0], te.carry_to_numpy(eager))


def test_padded_accel_rows_stay_inert(mixed):
    """Elements with one accelerator in a batch padded to two: the padded
    row never enqueues or serves (every lane still disabled)."""
    host = mixed["host"][-1]
    assert host["aq_cnt"].shape[1] == 2
    for b in (0, 2):
        assert host["aq_cnt"][b, 1] == 0 and host["aq_bytes"][b, 1] == 0
        assert (host["lanes"][b, 1] >= np.float32(3e38)).all()
        assert (host["lanes"][b, 0, 1:] >= np.float32(3e38)).all()


def test_elements_match_serial_simulate(mixed):
    """Each element of a ``simulate_batch`` window (mixed modes, ragged
    flows and accelerators, per-element stall rows) equals the port's
    serial ``simulate`` of it, and the JAX package's ``simulate_batch``."""
    flows, tabs, cfgs = _port_args(mixed)
    regs = _port_regs(mixed["regs"][0])
    got = tsim.simulate_batch(flows, tabs, tic.LinkSpec(), cfgs, regs,
                              *mixed["arr"], mixed["stall"], device="cpu")
    ref = jsim.simulate_batch([el[0] for el in mixed["els"]],
                              [el[1] for el in mixed["els"]], LinkSpec(),
                              mixed["cfgs"], mixed["regs"][0],
                              *mixed["arr"], mixed["stall"])
    for b, (el, r) in enumerate(zip(mixed["els"], ref)):
        n = el[0].n
        arr = (mixed["arr"][0][b, :n], mixed["arr"][1][b, :n])
        serial = tsim.simulate(flows[b], tabs[b], tic.LinkSpec(), cfgs[b],
                               regs[b], *arr, mixed["stall"][b],
                               device="cpu")
        assert_results_equal(serial, got[b])
        assert_results_equal(r, got[b])
        assert len(got[b].counters["c_adm_msgs"]) == n


# --- shared inputs, registers, ragged flows and accelerators, stalls --------


def _shared_case(n_ticks=200):
    return _scenario(**CASES["hw_rr"], n_ticks=n_ticks)


def _run_pair(flows, jtabs, ttabs, link, cfg, regs, arr, stall=None,
              **kw):
    """One window of the JAX batched engine and the port's on the same
    inputs (a shared value or a per-element list each); both carries as
    host copies."""
    pf = [port_flows(f) for f in flows] if isinstance(flows, list) \
        else port_flows(flows)
    pc = [port_cfg(c) for c in cfg] if isinstance(cfg, list) \
        else port_cfg(cfg)
    ref = je.run_window_batch(flows, jtabs, link[0], cfg, regs, *arr, stall,
                              **kw)
    got = te.run_window_batch(pf, ttabs, link[1], pc,
                              [_port_tb(r) for r in regs], *arr, stall,
                              device="cpu", **kw)
    return jax.device_get(ref), te.carry_to_numpy(got)


LINKS = (LinkSpec(), tic.LinkSpec())


def test_shared_inputs_match_reference():
    """Three seeds' traces under one shared flow set, accelerator table,
    link, config and registers (the reference's 8-seed batch, cut)."""
    flows, jtab, ttab, cfg, tbs, _, _ = _shared_case()
    arrs = [jsim.gen_arrivals(flows, cfg, seed=s,
                              load_ref_gbps={0: 40.0, 1: 40.0})
            for s in range(3)]
    ref, got = _run_pair(flows, jtab, ttab, LINKS, cfg, [tbs] * 3,
                         jsim.stack_arrivals(arrs))
    assert_carry_equal(ref, got)
    assert len(set(got["c_adm_msgs"][:, 0].tolist())) > 1


def test_heterogeneous_registers_and_links_match_reference():
    """Each element honours its own registers and its own link (credits,
    overhead and rates differ per element)."""
    flows, jtab, ttab, cfg, _, arr, _ = _shared_case()
    regs = [jtb.pack([jtb.params_for_gbps(g), jtb.params_for_gbps(g)])
            for g in (5.0, 20.0)]
    links = ([LinkSpec(), LinkSpec(credits=3, msg_overhead_bytes=300,
                                   h2d_gbps=20.0)],
             [tic.LinkSpec(), tic.LinkSpec(credits=3, msg_overhead_bytes=300,
                                           h2d_gbps=20.0)])
    ref, got = _run_pair(flows, jtab, ttab, links, cfg, regs,
                         jsim.stack_arrivals([arr, arr]))
    assert_carry_equal(ref, got)
    assert (got["c_adm_msgs"][0] != got["c_adm_msgs"][1]).any()


def test_ragged_flows_and_accels_match_reference():
    """Elements of 1, 3 and 2 flows on 1, 3 and 2 accelerators (padded
    to 3 lanes and 3 rows, masked), bitwise with the JAX engine."""
    specs = [dict(n_flows=1), dict(n_flows=3, accels=("synthetic50",
                                                      "aes256", "ipsec32")),
             dict(n_flows=2, accels=("sha3_512", "synthetic50"))]
    els = [_scenario(**CASES["hw_rr"] | s, n_ticks=200) for s in specs]
    ref, got = _run_pair([e[0] for e in els], [e[1] for e in els],
                         [e[2] for e in els], LINKS, els[0][3],
                         [e[4] for e in els],
                         jsim.stack_arrivals([e[5] for e in els]))
    assert_carry_equal(ref, got)
    assert got["aq_cnt"].shape == (3, 3)


@pytest.mark.parametrize("per_element", [False, True])
def test_stall_masks_shared_and_per_element_match_reference(per_element):
    """Software shaping under a shared [T] stall mask, and under [B, T]
    masks that differ per element."""
    flows, jtab, ttab, cfg, tbs, arr, stall = _scenario(
        **CASES["sw_stall"], n_ticks=200)
    other = jsim.gen_stall_mask(cfg, seed=2, stall_rate_hz=500_000.0,
                                stall_us=(0.2, 1.0))
    assert not np.array_equal(stall, other)
    mask = np.stack([stall, other]) if per_element else stall
    ref, got = _run_pair(flows, jtab, ttab, LINKS, cfg, [tbs, tbs],
                         jsim.stack_arrivals([arr, arr]), mask)
    assert_carry_equal(ref, got)
    same = all(x[0].tobytes() == x[1].tobytes() for x in
               (got["sw_pend"], *got["tb"]))
    assert same != per_element


def test_stack_arrivals_matches_reference():
    """Ragged traces pad with INF arrivals and zero sizes, as the
    reference's."""
    rng = np.random.default_rng(0)
    arrs = [(np.sort(rng.integers(0, 10**6, (n, m))).astype(np.int32),
             rng.integers(1, 9000, (n, m)).astype(np.int32))
            for n, m in ((1, 7), (3, 2), (2, 5))]
    for a, b in zip(jsim.stack_arrivals(arrs), tsim.stack_arrivals(arrs)):
        assert_bitwise(a, b)


# --- the batch entry points: run_system_batch and the profiler --------------

SYSTEMS = ("Arcus", "Host_TS_reflex", "Bypassed_noTS_panic", "Host_noTS")


def test_run_system_batch_matches_reference():
    """Four baseline systems (hardware, software, no shaping under the
    priority and WRR arbiters) over one scenario as one batch, each
    element's SimResult bitwise the reference's, software stalls per
    system."""
    flows, jtab, ttab, cfg, _, arr, _ = _shared_case(n_ticks=300)
    plans = [jtb.params_for_gbps(8.0), jtb.params_for_gbps(16.0)]
    over = dict(tick_cycles=64)
    regs = [jb.make_tb_state(jb.ALL[s], plans) for s in SYSTEMS]
    ref = jb.run_system_batch(SYSTEMS, flows, jtab, LinkSpec(), 300,
                              tb_states=regs, arr=arr, cfg_overrides=over,
                              stall_seed=7)
    pregs = [tbl.make_tb_state(tbl.ALL[s], plans) for s in SYSTEMS]
    for r, p in zip(regs, pregs):
        for x, y in zip(r, p):
            assert_bitwise(np.asarray(x), y.numpy())
    got = tbl.run_system_batch(SYSTEMS, port_flows(flows), ttab,
                               tic.LinkSpec(), 300, tb_states=pregs,
                               arr=arr, cfg_overrides=over, stall_seed=7,
                               device="cpu")
    for r, g in zip(ref, got):
        assert_results_equal(r, g)
    assert got[0].counters["c_done_msgs"].sum() > 0


def _contexts(pkg):
    cat = CATALOG if pkg == "jax" else tacc.CATALOG
    return [(cat["ipsec32"], [(Path.FUNCTION_CALL, 1500, 0.9)]),
            (cat["aes256"], [(Path.FUNCTION_CALL, 512, 0.9),
                             (Path.INLINE_NIC_RX, 4096, 0.5)]),
            (cat["sha3_512"], [(Path.FUNCTION_CALL, 64, 0.9)] * 3),
            (cat["ipsec32"], [(Path.FUNCTION_CALL, 1500, 0.9)])]


def _profiled(pkg):
    """One table of each package: a serial profile_context, then a batch
    of four contexts (one already profiled, one duplicate), then a sweep
    on a second table sharing one batched call with a third table of
    another link; entries and profiling_stats."""
    prof = jprof if pkg == "jax" else tprof
    kw = {} if pkg == "jax" else dict(device="cpu")
    link = LinkSpec if pkg == "jax" else tic.LinkSpec
    cat = CATALOG if pkg == "jax" else tacc.CATALOG
    prof.profiling_stats_clear()
    t1 = prof.ProfileTable(n_ticks=200, **kw)
    ctx = _contexts(pkg)
    first = t1.profile_context(*ctx[0])
    batch = t1.profile_contexts(ctx)
    t2 = prof.ProfileTable(n_ticks=200, **kw)
    t3 = prof.ProfileTable(link(credits=4), n_ticks=200, **kw)
    t2.sweep(cat["synthetic50"], msg_sizes=(64, 4096), n_flows=(1, 2))
    multi = prof.profile_contexts_multi([(t3, *ctx[1]), (t2, *ctx[2])])
    entries = [first, *batch, *multi] + [t2.entries[k]
                                         for k in sorted(t2.entries)]
    return [dataclasses.asdict(e) for e in entries], prof.profiling_stats()


def test_profile_contexts_sweep_and_stats_match_reference():
    """``profile_contexts`` (deduplicated against the table and within the
    batch), ``sweep`` and ``profile_contexts_multi`` across tables of two
    links give the reference's entries exactly, with its counters."""
    ref, ref_stats = _profiled("jax")
    got, got_stats = _profiled("torch")
    assert got == ref
    assert got_stats == ref_stats
    assert got_stats["sim_batches"] == 3 and got_stats["calls"] == 3


def test_profile_contexts_match_serial_profile_context():
    """Entries of one batched ``profile_contexts`` equal serial
    ``profile_context`` calls on fresh tables (the port alone)."""
    ctx = _contexts("torch")[:3]
    batch = tprof.ProfileTable(n_ticks=150, device="cpu") \
        .profile_contexts(ctx)
    serial = [tprof.ProfileTable(n_ticks=150, device="cpu")
              .profile_context(*c) for c in ctx]
    assert [dataclasses.asdict(e) for e in batch] == \
        [dataclasses.asdict(e) for e in serial]


# --- rejections --------------------------------------------------------------


def _port_case(n_ticks=10):
    flows, _, ttab, cfg, tbs, arr, _ = _shared_case(n_ticks)
    return port_flows(flows), ttab, port_cfg(cfg), _port_tb(tbs), arr


@pytest.mark.parametrize("what", ["static", "size", "resources", "ndim",
                                  "fl_masks", "tb_states", "stall"])
def test_batch_rejects_what_the_reference_rejects(what):
    """A structural config mismatch, a batch size mismatch, links with
    different numbers of resource axes, a 2-D trace, a wrong ``fl_masks``
    shape, ``tb_states=None`` without a carry and a stall mask of another
    batch raise ``ValueError``, as in the reference."""
    flows, tab, cfg, tbs, arr = _port_case()
    arr2 = tsim.stack_arrivals([arr, arr])
    args = dict(flows=flows, accels=tab, link=tic.LinkSpec(), cfg=cfg,
                tb_states=[tbs, tbs], arr_t=arr2[0], arr_sz=arr2[1])
    match = None
    if what == "static":
        args["cfg"] = [cfg, dataclasses.replace(cfg, k_grant=2)]
        match = "traced fields"
    elif what == "size":
        args["tb_states"] = [tbs]
        match = "batch size mismatch"
    elif what == "resources":
        args["link"] = [tic.LinkSpec(),
                        tic.LinkSpec(resources=(tic.mem_bw(100.0),))]
        match = "resource axes"
    elif what == "ndim":
        args["arr_t"], args["arr_sz"] = arr
        match = "arr_t"
    elif what == "fl_masks":
        args["fl_masks"] = [np.ones(3, bool)] * 2
        match = "fl_masks"
    elif what == "tb_states":
        args["tb_states"] = None
        match = "tb_states"
    else:
        args["stall_mask"] = np.zeros((3, cfg.n_ticks), bool)
        match = "stall_mask"
    with pytest.raises(ValueError, match=match):
        te.run_window_batch(**args, device="cpu")
