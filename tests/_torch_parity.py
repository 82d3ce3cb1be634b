"""Shared helpers for the parity tests of the PyTorch port (``repro_torch``)
against the JAX package (``repro``): the same numpy inputs go through both,
and outputs are compared bitwise (float32 leaves by their bit patterns)."""
import dataclasses

import numpy as np

from repro.core import flow as jflow
from repro_torch.core import flow as tflow
from repro_torch.core import engine as tengine


def port_spec(spec: jflow.FlowSpec) -> tflow.FlowSpec:
    """The port's FlowSpec equal to a reference FlowSpec."""
    return tflow.FlowSpec(
        spec.flow_id, spec.vm_id, tflow.Path(int(spec.path)), spec.accel_id,
        tflow.TrafficPattern(**dataclasses.asdict(spec.pattern)),
        tflow.SLO(tflow.SLOKind(int(spec.slo.kind)), spec.slo.target,
                  spec.slo.percentile),
        spec.priority, spec.weight, spec.res_demand)


def port_flows(flows: jflow.FlowSet) -> tflow.FlowSet:
    return tflow.FlowSet.build([port_spec(s) for s in flows.specs])


def port_cfg(cfg) -> tengine.SimConfig:
    """The port's SimConfig with the reference config's values for every
    field the port defines (the reference's fast-path tuning knobs have no
    counterpart in the port)."""
    return tengine.SimConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(tengine.SimConfig)})


def bits(x) -> np.ndarray:
    """Integer view of an array (float32 by bit pattern)."""
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_bitwise(a, b, label="") -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (label, a.shape, a.dtype, b.shape, b.dtype)
    diff = np.flatnonzero(bits(a).ravel() != bits(b).ravel())
    assert diff.size == 0, (label, diff[:10], a.ravel()[diff[:10]],
                            b.ravel()[diff[:10]])


def assert_carry_equal(c_ref: dict, c_port: dict) -> None:
    """Every leaf of the reference carry (host copy, ``jax.device_get``)
    equals the port's carry (``engine.carry_to_numpy``), bit for bit."""
    assert set(c_ref) == set(c_port), set(c_ref) ^ set(c_port)
    for k, v in c_ref.items():
        if k == "tb":
            for name, a, b in zip(v._fields, v, c_port["tb"]):
                assert_bitwise(a, b, f"tb.{name}")
        else:
            assert_bitwise(v, c_port[k], k)


def assert_results_equal(r_ref, r_port) -> None:
    """Two SimResults agree on every counter and the completion ring."""
    assert set(r_ref.counters) == set(r_port.counters)
    for k in r_ref.counters:
        assert_bitwise(r_ref.counters[k], r_port.counters[k], k)
    for k in ("comp_flow", "comp_lat_s", "comp_t_s", "comp_sz"):
        np.testing.assert_array_equal(getattr(r_ref, k), getattr(r_port, k),
                                      err_msg=k)
    assert r_ref.seconds == r_port.seconds


# --- models and serving -----------------------------------------------------


def port_arch(cfg):
    """The port's ArchConfig equal to a reference ArchConfig."""
    from repro_torch.models.config import ArchConfig
    return ArchConfig(**dataclasses.asdict(cfg))


#: the Mamba2 parameters that init_mamba2 sets to zeros or ones, with the
#: scale and centre of the noise ``jax_and_port_model(ssd_seed=...)`` puts
#: on them, so that the conv taps, the decay, the skip and the norm scale act
SSD_NOISE = {"conv_w": (0.3, 0.0), "conv_b": (0.1, 0.0), "a_log": (0.5, 0.0),
             "dt_bias": (0.5, 0.0), "d_skip": (0.2, 1.0),
             "norm_scale": (0.2, 1.0)}


def jax_and_port_model(cfg, seed: int = 0, *, bias_seed=None,
                       ssd_seed=None):
    """The reference's ``init_model(seed, cfg)`` parameters and the port's
    CPU model holding the same values.  ``bias_seed`` replaces the zero QKV
    biases by random ones, and ``ssd_seed`` puts seeded noise
    (``SSD_NOISE``) on the Mamba2 parameters initialised to zeros or ones,
    in the numpy tree both packages load (so a test sees them act)."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as JT
    from repro_torch.models import convert
    params, _ = JT.init_model(seed, cfg)
    params = jax.tree.map(np.asarray, params)
    mixers = [bp["mixer"] for bp in params["blocks"].values()] + \
        [bp["mixer"] for bp in params["tail"]]
    if bias_seed is not None:
        rng = np.random.default_rng(bias_seed)
        for mixer in mixers:
            for name in ("bq", "bk", "bv"):
                mixer[name] = (0.1 * rng.standard_normal(
                    mixer[name].shape)).astype(np.float32)
    if ssd_seed is not None:
        rng = np.random.default_rng(ssd_seed)
        for mixer in mixers:
            for name, (scale, centre) in SSD_NOISE.items():
                mixer[name] = (centre + scale * rng.standard_normal(
                    mixer[name].shape)).astype(np.float32)
    model = convert.params_from_jax(params, port_arch(cfg), device="cpu")
    return jax.tree.map(jnp.asarray, params), model


# --- serving runs -------------------------------------------------------------

#: the reference's default HardwareSpec numbers, given to both cost models
V5E = dict(flops=197e12, hbm=819e9)


def serving_mix(vocab: int):
    """(tenant, prompt, new tokens, arrival) of a small mix: background
    80-token prompts (longer than the reduced window of 64, so prefill
    truncates the local caches and decode wraps their slots) and reserved
    12-token prompts arriving over time."""
    rng = np.random.default_rng(0)
    reqs = [(2, rng.integers(0, vocab, 80).tolist(), 16, 0.0)
            for _ in range(4)]
    reqs += [(tid, rng.integers(0, vocab, 12).tolist(), 6, k * 0.02)
             for k in range(4) for tid in range(2)]
    return reqs


def run_serving(pkg: str, cfg, model, mix, shaped: bool, use_kernel: bool,
                arch: str, max_rounds: int = 400):
    """Serve ``mix`` through one package's ``ServingEngine`` (max_batch 4,
    max_len 128, float32 cache) under its Arcus or FCFS scheduler, clocked
    by ``arch``'s full-config cost model on the reference's hardware
    numbers (8 chips), for 0.6 s or ``max_rounds`` rounds (an idle round
    advances 0.1 ms).  ``pkg`` is ``"jax"`` (``model`` = the parameter
    tree) or ``"torch"`` (``model`` = the port's CPU model).  Returns
    (scheduler, requests, the logits of every prefill and decode call)."""
    if pkg == "jax":
        from repro.configs.registry import get_config
        from repro.core.flow import SLO
        from repro.serving import costmodel
        from repro.serving.engine import ServingEngine
        from repro.serving.request import Request, Tenant
        from repro.serving.scheduler import ArcusScheduler, FCFSScheduler
        eng = ServingEngine(cfg, model, max_batch=4, max_len=128)
    else:
        from repro_torch.configs.registry import get_config
        from repro_torch.core.flow import SLO
        from repro_torch.serving import costmodel
        from repro_torch.serving.engine import ServingEngine
        from repro_torch.serving.request import Request, Tenant
        from repro_torch.serving.scheduler import (ArcusScheduler,
                                                   FCFSScheduler)
        eng = ServingEngine(model.cfg, model, max_batch=4, max_len=128,
                            device="cpu")
    logits = []
    dec, pre = eng._decode, eng._prefill

    def rec_dec(*a):
        out = dec(*a)
        logits.append(("decode", np.asarray(out[0] if pkg == "jax"
                                            else out.float())))
        return out

    def rec_pre(*a):
        out = pre(*a)
        logits.append(("prefill", np.asarray(out[0] if pkg == "jax"
                                             else out[0].float())))
        return out
    eng._decode, eng._prefill = rec_dec, rec_pre
    tenants = [Tenant(0, SLO.iops(1200.0)), Tenant(1, SLO.iops(800.0)),
               Tenant(2, SLO.iops(1e9), "opportunistic")]
    cost = costmodel.StepCostModel(get_config(arch),
                                   costmodel.HardwareSpec(chips=8, **V5E))
    cls = ArcusScheduler if shaped else FCFSScheduler
    sched = cls(eng, tenants, cost, use_kernel=use_kernel)
    reqs = [Request(i, t, p, n, arrive_s=a) for i, (t, p, n, a)
            in enumerate(mix)]
    for r in reqs:
        sched.submit(r)
    sched.run(0.6, max_rounds=max_rounds)
    return sched, reqs, logits


def launcher_report(argv: list) -> tuple:
    """What the reference's launcher prints and what the port's launcher
    reports, both with ``argv`` and the reference's hardware numbers."""
    import contextlib
    import io
    import sys
    from repro.launch import serve as j_serve
    from repro_torch.launch import serve as t_serve
    from repro_torch.serving import costmodel
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = ["serve", *argv]
    try:
        with contextlib.redirect_stdout(buf):
            j_serve.main()
    finally:
        sys.argv = saved
    args = t_serve.parser().parse_args(argv)
    sched, tenants, cfg = t_serve.serve(
        args, device="cpu", hw=costmodel.HardwareSpec(chips=args.chips,
                                                      **V5E))
    return buf.getvalue().rstrip("\n"), t_serve.report(sched, tenants, cfg,
                                                        args)


# --- the reference digest of the smoke's fig6_batch phase --------------------


def result_digest(res) -> str:
    """sha256 of one SimResult's counters (by sorted key) and completion
    ring (flow, latency, time, size), each array's bytes in turn;
    ``chip_smoke.result_digest`` is the same function."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(res.counters):
        h.update(np.ascontiguousarray(res.counters[k]).tobytes())
    for k in ("comp_flow", "comp_lat_s", "comp_t_s", "comp_sz"):
        h.update(np.ascontiguousarray(getattr(res, k)).tobytes())
    return h.hexdigest()


def fig6_batch_digests(n_ticks: int = 20_000) -> list:
    """The JAX reference's run of ``chip_smoke.py``'s ``fig6_batch``
    phase on the CPU (``benchmarks/fig6_throughput_cdf.py``'s experiment:
    Arcus, Host_TS_reflex and Host_TS_firecracker at load points 1.5 and
    0.9, seed 3, one ``run_system_batch``) and each element's
    ``result_digest``, in the smoke's element order.  No tier-1 test calls
    it; ``chip_smoke.FIG6_DIGESTS`` pins its output:

        PYTHONPATH=src:tests JAX_PLATFORMS=cpu python -c \\
            'import _torch_parity as p; print(p.fig6_batch_digests())'
    """
    from repro.core import baselines, token_bucket as jtb
    from repro.core.accelerator import CATALOG, AccelTable
    from repro.core.flow import SLO, FlowSet, FlowSpec, Path, TrafficPattern
    from repro.core.interconnect import LinkSpec
    from repro.core.sim import gen_arrivals
    slo1, slo2 = 300_000.0, 200_000.0
    overrides = dict(tick_cycles=64, comp_cap=1 << 17, k_grant=8, k_srv=8,
                     k_eg=8, qlen=512, lmax=64)

    def flows(load_x):
        return FlowSet.build([
            FlowSpec(0, 0, Path.FUNCTION_CALL, 0,
                     TrafficPattern(4096, rate_mps=slo1 * load_x,
                                    process="poisson"), SLO.iops(slo1)),
            FlowSpec(1, 1, Path.FUNCTION_CALL, 0,
                     TrafficPattern(4096, rate_mps=slo2 * load_x,
                                    process="poisson"), SLO.iops(slo2))])
    names = ("Arcus", "Host_TS_reflex", "Host_TS_firecracker")
    cfg0 = baselines.make_sim_config(baselines.ALL[names[0]], n_ticks,
                                     **overrides)
    arrs_lp = [gen_arrivals(flows(x), cfg0, seed=3) for x in (1.5, 0.9)]
    plans = [jtb.params_for_iops(slo1), jtb.params_for_iops(slo2)]
    systems, arrs, tbss = [], [], []
    for name in names:
        for a in arrs_lp:
            systems.append(baselines.ALL[name])
            arrs.append(a)
            tbss.append(baselines.make_tb_state(baselines.ALL[name], plans))
    res = baselines.run_system_batch(
        systems, flows(1.0), AccelTable.build([CATALOG["nvme_raid0"]]),
        LinkSpec(credits=256), n_ticks, tb_states=tbss, arr=arrs,
        cfg_overrides=overrides)
    return [result_digest(r) for r in res]
