"""The port's attention plain versions against the JAX package.

``repro_torch.kernels.decode_attention`` and ``.flash_prefill`` run their
plain versions on CPU tensors; here they are held, on the same numpy
inputs, against the reference's oracles (``ref.py``) and its Pallas
wrappers in interpret mode, with the cases of ``tests/test_kernels.py`` and
``tests/test_flash_prefill_kernel.py``.  Tolerances are those of the JAX
tests: decode 2e-5 (float32) / 2e-2 (bf16), prefill 3e-5 / 3e-2 (sums in
another order; bf16 rounds the output).  The CUDA kernels themselves are
held against these plain versions in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as j_da_ops, ref as j_da_ref
from repro.kernels.flash_prefill import ops as j_fp_ops, ref as j_fp_ref
from repro.models import layers as JL
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_prefill import ops as fp_ops

T_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _pair(x: np.ndarray, dt):
    """The same values as a JAX array and a torch CPU tensor of ``dt``."""
    j = jnp.asarray(x, dt)
    return j, torch.as_tensor(np.array(j.astype(jnp.float32))).to(T_DT[dt])


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

DA_CASES = [
    # B, H, KvH, D, S, window, q dtype, cache dtype
    (2, 16, 8, 128, 1024, 0, jnp.float32, jnp.float32),
    (1, 8, 1, 64, 512, 0, jnp.float32, jnp.float32),
    (3, 12, 2, 80, 777, 0, jnp.float32, jnp.float32),
    (2, 16, 8, 128, 2048, 256, jnp.bfloat16, jnp.bfloat16),
    (1, 40, 8, 128, 4096, 1024, jnp.float32, jnp.float32),
    (2, 16, 16, 96, 300, 0, jnp.bfloat16, jnp.bfloat16),
    (1, 24, 2, 128, 640, 128, jnp.float32, jnp.float32),
    # the serving engine's mix: bf16 activations over a float32 cache
    (2, 16, 8, 256, 256, 0, jnp.bfloat16, jnp.float32),
]


def _da_inputs(case, seed):
    B, H, KvH, D, S, w, qdt, cdt = case
    rng = np.random.default_rng(seed)
    q = _pair(rng.standard_normal((B, H, D)), qdt)
    k = _pair(rng.standard_normal((B, S, KvH, D)), cdt)
    v = _pair(rng.standard_normal((B, S, KvH, D)), cdt)
    ln = rng.integers(max(1, S // 4), S + 1, B).astype(np.int32)
    return q, k, v, (jnp.asarray(ln), torch.as_tensor(ln))


@pytest.mark.parametrize("case", DA_CASES)
def test_decode_plain_matches_reference(case):
    """Plain version vs the JAX oracle and the Pallas kernel (interpret)."""
    w, qdt = case[5], case[6]
    (jq, tq), (jk, tk), (jv, tv), (jl, tl) = _da_inputs(case, 0)
    before = da_ops.LAUNCHES
    got = da_ops.decode_attention(tq, tk, tv, tl, window=w)
    assert da_ops.LAUNCHES == before       # a CPU tensor launches nothing
    assert got.dtype == tq.dtype and tuple(got.shape) == tuple(jq.shape)
    tol = 2e-2 if qdt == jnp.bfloat16 else 2e-5
    want = j_da_ref.decode_attention(jq, jk, jv, jl, window=w)
    assert _err(_np(got), want) < tol
    if qdt == case[7]:                      # the Pallas wrapper takes one dtype
        pallas = j_da_ops.decode_attention(jq, jk, jv, jl, window=w)
        assert _err(_np(got), pallas) < tol


def test_decode_plain_ignores_padding_region():
    """Entries beyond ``lengths`` do not affect the output (the case of
    ``test_kernels.py::test_decode_attention_ignores_padding_region``)."""
    rng = np.random.default_rng(1)
    B, H, KvH, D, S = 2, 8, 4, 64, 256
    q = torch.as_tensor(rng.standard_normal((B, H, D)), dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((B, S, KvH, D)),
                        dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((B, S, KvH, D)),
                        dtype=torch.float32)
    ln = torch.tensor([100, 180], dtype=torch.int32)
    out1 = da_ops.decode_attention(q, k, v, ln)
    k2, v2 = k.clone(), v.clone()
    k2[:, 200:] = 1e6
    v2[:, 200:] = -1e6
    out2 = da_ops.decode_attention(q, k2, v2, ln)
    assert torch.equal(out1, out2)


def test_decode_plain_empty_row_is_zero():
    """A sequence with no valid position returns 0, as the reference's
    ``max(l, 1e-30)``."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 32)).astype(np.float32)
    ln = np.array([0, 5], np.int32)
    got = da_ops.decode_attention(*(torch.as_tensor(x) for x in (q, k, k)),
                                  torch.as_tensor(ln))
    want = j_da_ref.decode_attention(*(jnp.asarray(x) for x in (q, k, k, ln)))
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert _err(_np(got), want) < 2e-5


# ---------------------------------------------------------------------------
# flash prefill
# ---------------------------------------------------------------------------

FP_CASES = [
    # B, S, H, KvH, D, window, chunk, bq, bk, dtype
    (2, 128, 4, 2, 64, 0, 0, 64, 64, jnp.float32),
    (1, 256, 8, 8, 128, 0, 0, 128, 128, jnp.float32),
    (1, 200, 4, 1, 80, 0, 0, 64, 64, jnp.float32),     # ragged + MQA
    (2, 256, 4, 2, 64, 64, 0, 64, 64, jnp.float32),    # sliding window
    (1, 256, 4, 2, 64, 0, 64, 64, 64, jnp.float32),    # chunked local
    (1, 256, 8, 4, 128, 128, 0, 128, 128, jnp.bfloat16),
]


@pytest.mark.parametrize("case", FP_CASES)
def test_prefill_plain_matches_reference(case):
    """Plain version vs the JAX oracle and the Pallas kernel (interpret)."""
    B, S, H, KvH, D, w, ck, bq, bk, dt = case
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng.standard_normal((B, S, H, D)), dt)
    jk, tk = _pair(rng.standard_normal((B, S, KvH, D)), dt)
    jv, tv = _pair(rng.standard_normal((B, S, KvH, D)), dt)
    before = fp_ops.LAUNCHES
    got = fp_ops.flash_prefill(tq, tk, tv, window=w, chunk_size=ck)
    assert fp_ops.LAUNCHES == before
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, S, H, D)
    tol = 3e-2 if dt == jnp.bfloat16 else 3e-5
    want = j_fp_ref.flash_prefill(jq, jk, jv, window=w, chunk_size=ck)
    assert _err(_np(got), want) < tol
    pallas = j_fp_ops.flash_prefill(jq, jk, jv, window=w, chunk_size=ck,
                                    bq=bq, bk=bk)
    assert _err(_np(got), pallas) < tol


@pytest.mark.parametrize("kind", ["causal", "local", "chunk"])
def test_prefill_plain_matches_model_flash(kind):
    """The plain version agrees with the masks the reference model computes
    inline (``layers.flash_attention``, where the model calls no kernel),
    within 3e-4 as ``test_flash_prefill_kernel.py`` holds them."""
    rng = np.random.default_rng(4)
    B, S, H, KvH, D, W = 1, 192, 4, 2, 64, 48
    q, k, v = (rng.standard_normal((B, S, n, D)).astype(np.float32)
               for n in (H, KvH, KvH))
    window = W if kind == "local" else 0
    chunk = W if kind == "chunk" else 0
    got = fp_ops.flash_prefill(*(torch.as_tensor(x) for x in (q, k, v)),
                               window=window, chunk_size=chunk)
    want = JL.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                              mask_kind="causal", window=window,
                              chunk_size=chunk, kv_chunk=64)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


def test_prefill_plain_non_causal():
    rng = np.random.default_rng(5)
    q, k = (rng.standard_normal((1, 40, n, 32)).astype(np.float32)
            for n in (4, 2))
    got = fp_ops.flash_prefill(*(torch.as_tensor(x) for x in (q, k, k)),
                               causal=False)
    want = j_fp_ref.flash_prefill(*(jnp.asarray(x) for x in (q, k, k)),
                                  causal=False)
    assert _err(_np(got), want) < 3e-5


@pytest.mark.parametrize("qd, kd, path", [
    (torch.bfloat16, torch.bfloat16, "tensor_core"),
    (torch.float32, torch.float32, "cuda_core"),
    (torch.bfloat16, torch.float32, "cuda_core"),
    (torch.float32, torch.bfloat16, "cuda_core")])
def test_prefill_kernel_path_by_dtype(qd, kd, path):
    """On the card the wrapper picks its kernel by operand type alone; a CPU
    call runs the plain version and counts a launch on neither path."""
    assert fp_ops.kernel_path(qd, kd) == path
    before = dict(fp_ops.LAUNCHES_BY_PATH)
    q = torch.zeros((1, 3, 2, 8), dtype=qd)
    kv = torch.zeros((1, 3, 1, 8), dtype=kd)
    fp_ops.flash_prefill(q, kv, kv)
    assert fp_ops.LAUNCHES_BY_PATH == before


def test_tensor_core_operands_padded_and_aligned():
    """The tensor-core kernel takes D % 8 == 0 and 16-byte aligned rows: the
    wrapper pads D with zeros (which change no score) and copies an
    unaligned view; the models' tensors pass unchanged."""
    x = torch.randn((1, 5, 2, 36)).to(torch.bfloat16)
    p = fp_ops._tc_operand(x, 40)
    assert p.shape == (1, 5, 2, 40) and torch.equal(p[..., :36], x)
    assert not p[..., 36:].any()
    y = torch.randn((1, 5, 2, 64)).to(torch.bfloat16)
    assert fp_ops._tc_operand(y, 64) is y
    z = torch.randn(1 + 5 * 2 * 64).to(torch.bfloat16)[1:].view(1, 5, 2, 64)
    assert z.data_ptr() % 16 != 0
    c = fp_ops._tc_operand(z, 64)
    assert c.data_ptr() % 16 == 0 and torch.equal(c, z)


def test_wrappers_refuse_other_devices():
    x = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(ValueError):
        da_ops.decode_attention(x, x[:, :, None].expand(1, 4, 1, 8), x,
                                torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        fp_ops.flash_prefill(x[None], x[None], x[None])


def test_decode_launch_plan():
    """The decode kernel's launch plan, from shapes alone: clusters of 1..8
    CTAs, never more CTAs a cluster than S has row tiles, a ring that fits
    three CTAs an SM over a short cache and one over a longer one, and at
    least one CTA for each of the H100's 132 SMs at the serve mix's shape
    (gemma3-12b: B 8, 8 KV heads of 256 floats, G 2)."""
    gc, cluster, tile_rows = da_ops.launch_plan(8, 8, 2, 256, 256 * 4)
    assert gc == 2 and 8 * 8 * cluster >= 132
    # the long mix's caches: one CTA an SM
    for S in (1024, 2048):
        assert 8 * 8 * da_ops.launch_plan(8, 8, 2, S, 256 * 4)[1] <= 132
    for B in (1, 2, 8, 64):
        for KvH, G in ((1, 8), (2, 5), (8, 2), (16, 1), (2, 16)):
            for S in (1, 7, 64, 256, 1024, 2048):
                for row_bytes in (16, 160, 512, 1024):
                    gc, cluster, tile_rows = da_ops.launch_plan(
                        B, KvH, G, S, row_bytes)
                    assert gc == da_ops.group_chunk(G)
                    assert 1 <= cluster <= da_ops.MAX_CLUSTER
                    assert 1 <= tile_rows <= min(S, da_ops.MAX_TILE_ROWS)
                    assert cluster <= -(-S // tile_rows)
                    ring = da_ops.RING_BYTES * (1 if S <= da_ops.SHORT_S
                                                else 2)
                    assert da_ops.STAGES * 2 * tile_rows * row_bytes <= \
                        max(ring, da_ops.STAGES * 2 * row_bytes)
