"""On-card tests of the port: the Hopper token-bucket kernel against its
plain version, and a CUDA dataplane window against the same window on the
CPU.  They need an NVIDIA GPU with ``nvcc`` and skip elsewhere; on the card
run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports torch and the port only (no JAX), so it also runs where
JAX is not installed."""
import numpy as np
import pytest
import torch

from repro_torch.core import token_bucket as tb
from repro_torch.core.accelerator import CATALOG, AccelTable
from repro_torch.core.flow import (SLO, FlowSet, FlowSpec, Path,
                                   TrafficPattern)
from repro_torch.core.interconnect import LinkSpec
from repro_torch.core.sim import SimConfig, gen_arrivals, simulate
from repro_torch.kernels.token_bucket import ops

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
    assert ops.LAUNCHES - before == cfg.n_ticks * (1 + cfg.k_grant)
    r_cpu = simulate(flows, atab, LinkSpec(), cfg, tbs, *arr, device="cpu")
    for k in r_cpu.counters:
        assert r_dev.counters[k].tobytes() == r_cpu.counters[k].tobytes(), k
    np.testing.assert_array_equal(r_dev.comp_t_s, r_cpu.comp_t_s)
    np.testing.assert_array_equal(r_dev.comp_flow, r_cpu.comp_flow)
