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


def jax_and_port_model(cfg, seed: int = 0, *, bias_seed=None):
    """The reference's ``init_model(seed, cfg)`` parameters and the port's
    CPU model holding the same values.  ``bias_seed`` replaces the zero QKV
    biases by random ones (so a test sees them act)."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as JT
    from repro_torch.models import convert
    params, _ = JT.init_model(seed, cfg)
    if bias_seed is not None:
        rng = np.random.default_rng(bias_seed)

        def with_bias(mixer):
            for name in ("bq", "bk", "bv"):
                mixer[name] = jnp.asarray(
                    0.1 * rng.standard_normal(mixer[name].shape), jnp.float32)
        for bp in params["blocks"].values():
            with_bias(bp["mixer"])
        for bp in params["tail"]:
            with_bias(bp["mixer"])
    model = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                    port_arch(cfg), device="cpu")
    return params, model
