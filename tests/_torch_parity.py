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
