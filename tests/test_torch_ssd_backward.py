"""The gradient of the port's SSD scan against ``jax.vjp`` of the JAX
package's oracle (``src/repro/kernels/ssd_scan/ref.py::ssd_scan``), whose
autodiff is what the reference trains through.

``ref.ssd_scan_chunked_backward`` is the backward kernel's arithmetic on
the CPU (``csrc/ssd_scan_bwd.cu``: chunks of 128, the reverse state pass,
d log a summed directly); the sequential plain scan's autograd is what the
port trains through on the CPU; ``ops.SSDScan`` is the autograd Function
the card trains through, run here with the chunked pair.  Five items, so
that ``--dist loadfile`` schedules the file beside the run's longest one
(files are handed out by test count, most first).

Limits (max-abs error over the reference's max-abs, per gradient):
float32 1e-4, for float32 sums in another order (measured about 5e-7);
bf16 inputs 5e-2: the chunked form rounds the saved state entering each
chunk to bf16, as the tensor-core forward stores it, and each gradient
to bf16 once (2^-8 relative an element), where the reference computes
from the same bf16 inputs in float32.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ref as j_ref
from repro.training import train as JTR
from repro_torch.configs.registry import get_reduced_config
from repro_torch.kernels.ssd_scan import ops as t_ops, ref as t_ref
from repro_torch.models import convert
from repro_torch.training import train as TTR
from _torch_parity import jax_and_port_model, one_torch_thread

F32_LIMIT = 1e-4
BF16_LIMIT = 5e-2
#: the training tests' gradient tolerance (tests/test_torch_train.py)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
NAMES = ("x", "a", "B", "C")
# Bsz, L, H, P, G, N, decay: a ragged last chunk at G = 2, at G = 1 over
# three chunks, one prompt below a chunk, and a strong-decay case whose
# first chunk spans more than 2^120 and whose second does not (so the
# forward takes both decay forms)
CASES = [
    (1, 300, 4, 16, 2, 32, "mild"),
    (2, 280, 3, 8, 1, 16, "mild"),
    (1, 90, 2, 8, 1, 16, "mild"),
    (1, 300, 4, 8, 2, 16, "strong"),
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: beside the other test processes a pool of
    threads spin-waits (``_torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


def _tensor(v):
    return None if v is None else torch.as_tensor(v)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _inputs(case, seed=0):
    """numpy x, a, B, C and cotangents dy, d_state (float32)."""
    Bz, L, H, P, G, N, decay = case
    rng = np.random.default_rng(seed + L)
    x = (0.5 * rng.standard_normal((Bz, L, H, P))).astype(np.float32)
    a = rng.uniform(0.7, 0.999, (Bz, L, H)).astype(np.float32)
    if decay == "strong":
        a[:, :128] = rng.random((Bz, 128, H)) ** 8
    B, C = ((0.3 * rng.standard_normal((Bz, L, G, N))).astype(np.float32)
            for _ in range(2))
    dy = rng.standard_normal((Bz, L, H, P)).astype(np.float32)
    ds = (0.1 * rng.standard_normal((Bz, H, P, N))).astype(np.float32)
    return (x, a, B, C), dy, ds


def _reference_vjp(ins, dy, ds, dtype=jnp.float32, log_a=False):
    """``jax.vjp`` of the oracle: (dx, da, dB, dC) as float32 numpy; with
    ``log_a`` the second is the gradient of log a (a = exp(log a), the
    model's chain)."""
    x, a, B, C = ins
    args = (jnp.asarray(x, dtype), jnp.asarray(np.log(a) if log_a else a),
            jnp.asarray(B, dtype), jnp.asarray(C, dtype))
    fn = (lambda x, la, B, C: j_ref.ssd_scan(x, jnp.exp(la), B, C)) \
        if log_a else j_ref.ssd_scan
    _, vjp = jax.vjp(fn, *args)
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp((jnp.asarray(dy, dtype), jnp.asarray(ds)))]


def _strong_spans(a) -> tuple:
    """The log2 span of the strong case's first and second chunks."""
    ca = np.cumsum(np.log(a[0, :256].astype(np.float64)), 0)
    return ((ca[0] - ca[127]) / np.log(2), (ca[128] - ca[255]) / np.log(2))


def test_chunked_backward_float32_matches_reference_vjp():
    """Every case, both cotangents at once and each alone: dx, da, dB, dC
    within the float32 limit; on the strong-decay case also d log a = da a
    (what the model's chain ``a = exp(-dt exp(a_log))`` uses)."""
    for case in CASES:
        ins, dy, ds = _inputs(case)
        if case[-1] == "strong":
            lo, hi = _strong_spans(ins[1])
            assert (lo > 120).all() and (hi <= 120).all(), (lo, hi)
        t = [torch.as_tensor(v) for v in ins]
        for gy, gs in ((dy, ds), (dy, None), (None, ds)):
            want = _reference_vjp(ins, dy if gy is not None else 0 * dy,
                                  ds if gs is not None else 0 * ds)
            got = t_ref.ssd_scan_chunked_backward(*t, _tensor(gy),
                                                  _tensor(gs))
            for name, g, w in zip(NAMES, got, want):
                assert g.dtype == torch.float32
                assert _rel(g.numpy(), w) <= F32_LIMIT, (case, name)
        if case[-1] == "strong":
            want = _reference_vjp(ins, dy, ds, log_a=True)[1]
            got = t_ref.ssd_scan_chunked_backward(
                *t, torch.as_tensor(dy), torch.as_tensor(ds))[1]
            assert _rel(got.numpy() * ins[1], want) <= F32_LIMIT


def test_chunked_backward_bf16_matches_reference_vjp():
    """bf16 x, B, C and dy (a ragged chunk at G = 2, and strong decay),
    with the CUDA-core kernel's rounding points and with the tensor-core
    kernel's: each gradient in its input's dtype, within the bf16 limit."""
    for case, tensor_core in itertools.product((CASES[0], CASES[3]),
                                               (False, True)):
        ins, dy, ds = _inputs(case, seed=1)
        bf = [torch.as_tensor(v).bfloat16() for v in (ins[0], ins[2],
                                                      ins[3], dy)]
        # the reference sees the same bf16-rounded values
        ins = (bf[0].float().numpy(), ins[1], bf[1].float().numpy(),
               bf[2].float().numpy())
        want = _reference_vjp(ins, bf[3].float().numpy(), ds,
                              dtype=jnp.bfloat16)
        got = t_ref.ssd_scan_chunked_backward(
            bf[0], torch.as_tensor(ins[1]), bf[1], bf[2], bf[3],
            torch.as_tensor(ds), tensor_core=tensor_core)
        for name, g, w in zip(NAMES, got, want):
            assert g.dtype == (torch.float32 if name == "a"
                               else torch.bfloat16)
            assert _rel(g.float().numpy(), w) <= BF16_LIMIT, \
                (case, tensor_core, name)


def test_sequential_plain_autograd_matches_reference_vjp():
    """Autograd through the sequential plain scan (the CPU training path)
    on the ragged G = 2 case and the strong-decay case: float32 limit."""
    for case in (CASES[0], CASES[3]):
        ins, dy, ds = _inputs(case, seed=2)
        want = _reference_vjp(ins, dy, ds)
        t = [torch.as_tensor(v).requires_grad_() for v in ins]
        y, s = t_ops.ssd_scan_plain(*t)
        torch.autograd.backward((y, s), (torch.as_tensor(dy),
                                         torch.as_tensor(ds)))
        for name, v, w in zip(NAMES, t, want):
            assert _rel(v.grad.numpy(), w) <= F32_LIMIT, (case, name)


def test_ssd_scan_function_runs_the_pair_it_is_given():
    """``SSDScan`` with the chunked forward and backward: its outputs are
    the chunked forward's, its gradients those of autograd through the
    sequential scan (float32 limit) for a loss on y alone, on the final
    state alone, and on both; the backward is called with None for an
    output that has no gradient."""
    ins, dy, ds = _inputs(CASES[0], seed=3)
    calls = []

    def fwd(x, a, B, C):
        return (*t_ref.ssd_scan_chunked(x, a, B, C), None)

    def bwd(x, a, B, C, saved, gy, gs):
        calls.append((gy is None, gs is None))
        return t_ref.ssd_scan_chunked_backward(x, a, B, C, gy, gs)

    for use in ("y", "state", "both"):
        grads = []
        for scan in ("function", "plain"):
            t = [torch.as_tensor(v).requires_grad_() for v in ins]
            if scan == "function":
                y, s = t_ops.SSDScan.apply(*t, fwd, bwd)
                yc, sc = t_ref.ssd_scan_chunked(
                    *[torch.as_tensor(v) for v in ins])
                assert torch.equal(y, yc) and torch.equal(s, sc)
            else:
                y, s = t_ops.ssd_scan_plain(*t)
            loss = {"y": (y * torch.as_tensor(dy)).sum(),
                    "state": (s * torch.as_tensor(ds)).sum(),
                    "both": (y * torch.as_tensor(dy)).sum()
                    + (s * torch.as_tensor(ds)).sum()}[use]
            loss.backward()
            # the final state does not depend on C: no gradient there
            grads.append([np.zeros(v.shape, np.float32) if v.grad is None
                          else v.grad.numpy() for v in t])
        for name, g, w in zip(NAMES, *grads):
            assert _rel(g, w) <= F32_LIMIT, (use, name)
    assert calls == [(False, True), (True, False), (False, False)]


def test_reduced_mamba2_trains_through_ssd_function_like_reference(
        monkeypatch):
    """The reduced mamba2 (2 ``ssd`` layers, float32) on 160 tokens (two
    chunks, the second ragged), its scans through ``SSDScan`` with the
    chunked pair: loss and every parameter's gradient against the
    reference's ``value_and_grad`` at the training tests' tolerance."""
    cfg = get_reduced_config("mamba2-780m")
    params, model = jax_and_port_model(cfg, 0, train=True, ssd_seed=4)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (2, 160)).astype(np.int32)
    mask = np.ones((2, 160), np.int32)
    mask[1, 150:] = 0
    jb = {"tokens": jnp.asarray(toks), "mask": jnp.asarray(mask)}
    (loss_ref, _), grads = jax.jit(jax.value_and_grad(
        lambda p: JTR.loss_fn(p, cfg, jb, remat=False), has_aux=True))(params)
    want = convert.values_from_jax(jax.tree.map(np.asarray, grads), model)

    def fwd(x, a, B, C):
        return (*t_ref.ssd_scan_chunked(x, a, B, C), None)

    def bwd(x, a, B, C, saved, gy, gs):
        return t_ref.ssd_scan_chunked_backward(x, a, B, C, gy, gs)

    calls = []

    def grad_scan(x, a, B, C, *, plain=False):
        calls.append(tuple(x.shape))
        return t_ops.SSDScan.apply(x, a, B, C, fwd, bwd)

    monkeypatch.setattr(t_ops, "ssd_scan_grad", grad_scan)
    tb = {"tokens": torch.as_tensor(toks).long(),
          "mask": torch.as_tensor(mask)}
    loss, _ = TTR.loss_fn(model, tb, remat=False)
    loss.backward()
    assert len(calls) == cfg.n_layers and calls[0][1] == 160
    assert loss.item() == pytest.approx(float(loss_ref), rel=1e-5, abs=1e-5)
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name]
        err = np.linalg.norm(g - w)
        assert err <= GRAD_RTOL * np.linalg.norm(w) or err <= GRAD_ATOL, \
            (name, err, np.linalg.norm(w))
