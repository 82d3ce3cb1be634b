"""The port's serving stack (``repro_torch.serving``) against the JAX
package: ``ServingEngine`` + ``ArcusScheduler`` / ``FCFSScheduler`` on the
same requests, and the cost model (the launcher: ``test_torch_launcher.py``).

Weights come from the reference's init (``convert.params_from_jax``); the
cost model gets the reference's default hardware numbers explicitly, so the
two virtual clocks agree.  Random-weight models repeat one token per
request, so the tests hold the logits of every prefill and decode step
(float32, 1e-4 absolute: sums in another order), and the tokens, the final
cache (2e-5) and the scheduler's statistics, which must be equal bit for
bit: the clock is Python floats and the buckets int32.
"""
import dataclasses

import pytest
import torch

from repro.configs.registry import ARCH_IDS, get_config, get_reduced_config
from repro.serving import costmodel as j_cost
from repro_torch.configs import registry as t_registry
from repro_torch.core.flow import SLO as TSLO
from repro_torch.serving import costmodel as t_cost
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.request import Tenant as TTenant
from repro_torch.serving.scheduler import ArcusScheduler as TArcus
from _torch_parity import (V5E, assert_serving_matches, jax_and_port_model,
                           one_torch_thread)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: beside the other test processes a pool of
    threads spin-waits (``_torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


@pytest.mark.parametrize("shaped,use_kernel", [(True, True), (False, False)],
                         ids=["arcus-kernel", "fcfs"])
def test_engine_and_scheduler_match_reference(shaped, use_kernel):
    cfg = get_reduced_config("gemma3-12b")
    params, model = jax_and_port_model(cfg, 0)
    assert_serving_matches(cfg, params, model, "gemma3-12b", shaped,
                           use_kernel)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cost_model_matches_reference(arch):
    """The formulas are the reference's, to the bit, given its hardware
    numbers; the port's default target is the H100 SXM data sheet."""
    j_cfg, t_cfg = get_config(arch), t_registry.get_config(arch)
    assert dataclasses.asdict(j_cfg) == dataclasses.asdict(t_cfg)
    assert t_cost.param_bytes(t_cfg) == j_cost.param_bytes(j_cfg)
    assert t_cost.param_bytes(t_cfg, False) == j_cost.param_bytes(j_cfg,
                                                                  False)
    for ctx in (1, 700, 5000):
        assert t_cost.flops_per_token(t_cfg, ctx) == \
            j_cost.flops_per_token(j_cfg, ctx)
        assert t_cost.kv_bytes_per_token(t_cfg, ctx) == \
            j_cost.kv_bytes_per_token(j_cfg, ctx)
    jm = j_cost.StepCostModel(j_cfg, j_cost.HardwareSpec(chips=4))
    tm = t_cost.StepCostModel(t_cfg, t_cost.HardwareSpec(chips=4, **V5E))
    for b, s in ((1, 12), (1, 64), (8, 300)):
        assert tm.prefill_s(b, s) == jm.prefill_s(b, s)
        assert tm.decode_s(b, s) == jm.decode_s(b, s)
    hw = t_cost.HardwareSpec()
    assert (hw.flops, hw.hbm, hw.chips) == (989.4e12, 3.35e12, 1)


def test_bucket_advance_same_with_and_without_kernel():
    """``use_kernel`` changes the route (the token-bucket kernel's wrapper,
    here its plain version), not the buckets."""
    cfg = t_registry.get_reduced_config("gemma3-12b")
    from repro_torch.models import transformer as TT
    model = TT.init_model(0, cfg, device="cpu")
    eng = TEngine(cfg, model, max_batch=2, max_len=32, device="cpu")
    tenants = [TTenant(0, TSLO.iops(1200.0)), TTenant(1, TSLO.iops(800.0))]
    cost = t_cost.StepCostModel(cfg)
    a = TArcus(eng, tenants, cost, use_kernel=True)
    b = TArcus(eng, tenants, cost, use_kernel=False)
    for s in (a, b):
        s._try_consume(0, 3000)
    for dt in (1e-4, 3.3e-3, 0.25, 1.0):
        a._advance_buckets(dt)
        b._advance_buckets(dt)
        assert torch.equal(a.buckets.tokens, b.buckets.tokens)
        assert torch.equal(a.buckets.cyc, b.buckets.cyc)


def test_engine_refuses_model_on_another_device():
    cfg = t_registry.get_reduced_config("gemma3-12b")
    from repro_torch.models import transformer as TT
    model = TT.init_model(0, cfg, device="cpu")
    with pytest.raises(ValueError):
        TEngine(cfg, model, max_batch=1, max_len=16, device="meta")
