"""On-card tests of the port: the Hopper token-bucket, decode-attention and
flash-prefill kernels against their plain versions, a CUDA dataplane window
against the same window on the CPU, and the serving engine through the
kernels against the same engine through the plain versions.  They need an NVIDIA GPU with ``nvcc`` and skip elsewhere; on the card
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
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_prefill import ops as fp_ops
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
]


@pytest.mark.parametrize("case", DA_CASES)
def test_decode_attention_kernel_matches_plain(dev, case):
    B, H, KvH, D, S, w, qdt, cdt = case
    g = torch.Generator(device=dev).manual_seed(S)
    q = torch.randn((B, H, D), generator=g, device=dev).to(qdt)
    k = torch.randn((B, S, KvH, D), generator=g, device=dev).to(cdt)
    v = torch.randn((B, S, KvH, D), generator=g, device=dev).to(cdt)
    ln = torch.randint(0, S + 1, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    before = da_ops.LAUNCHES
    got = da_ops.decode_attention(q, k, v, ln, window=w)
    assert da_ops.LAUNCHES == before + 1
    want = da_ops.decode_attention_plain(q, k, v, ln, window=w)
    torch.cuda.synchronize()
    tol = 2e-2 if torch.bfloat16 in (qdt, cdt) else 2e-5
    assert got.dtype == qdt
    assert float((got.float() - want.float()).abs().max()) < tol


FP_CASES = [
    # B, S, H, KvH, D, window, chunk, dtype
    (2, 128, 4, 2, 64, 0, 0, torch.float32),
    (1, 200, 4, 1, 80, 0, 0, torch.float32),
    (2, 256, 4, 2, 64, 64, 0, torch.float32),
    (1, 256, 4, 2, 64, 0, 64, torch.float32),
    (1, 300, 16, 8, 256, 100, 0, torch.bfloat16),
    (1, 1536, 16, 8, 256, 1024, 0, torch.bfloat16),
]


@pytest.mark.parametrize("case", FP_CASES)
def test_flash_prefill_kernel_matches_plain(dev, case):
    B, S, H, KvH, D, w, ck, dt = case
    g = torch.Generator(device=dev).manual_seed(S)
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(dt)
    k = torch.randn((B, S, KvH, D), generator=g, device=dev).to(dt)
    v = torch.randn((B, S, KvH, D), generator=g, device=dev).to(dt)
    before = fp_ops.LAUNCHES
    got = fp_ops.flash_prefill(q, k, v, window=w, chunk_size=ck)
    assert fp_ops.LAUNCHES == before + 1
    want = fp_ops.flash_prefill_plain(q, k, v, window=w, chunk_size=ck)
    torch.cuda.synchronize()
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    assert float((got.float() - want.float()).abs().max()) < tol


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
    with pytest.raises(ValueError):      # v's dtype differs from k's
        fp_ops.flash_prefill(q[:, None], k, k.half())


def test_serving_engine_kernels_match_plain(dev):
    """Reduced gemma3 in bf16 on the card: logits of every prefill and
    decode through the kernels within one bf16 ulp of their scale of the
    same engine through the plain versions."""
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    cfg = get_reduced_config("gemma3-12b", dtype="bfloat16")
    model = T.init_model(0, cfg, device=dev)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n in (80, 12, 40)]
    out = []
    for plain in (False, True):
        eng = ServingEngine(cfg, model, max_batch=4, max_len=128,
                            device=dev, plain_attention=plain)
        logits = []
        for i, p in enumerate(prompts):
            eng.admit(Request(i, 0, p, 12))
        for _ in range(10):
            eng.step()
            logits.append(eng._decode(
                torch.zeros((4, 1), dtype=torch.long, device=dev),
                torch.as_tensor(eng.lengths, device=dev),
                [tuple(t.clone() for t in kv) for kv in eng.cache]))
        out.append(torch.stack(logits).float())
    diff = (out[0] - out[1]).abs()
    assert bool((diff <= 0.0625 + 1e-2 * out[1].abs()).all()), \
        float(diff.max())
