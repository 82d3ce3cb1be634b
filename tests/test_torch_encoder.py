"""The port's encoder-decoder family (the bidirectional encoder, each
decoder layer's cross-attention to its output, the ``audio`` frontend)
against the JAX package, at the reduced seamless-m4t-medium
(``get_reduced_config``: 2 encoder and 2 decoder layers, d_model 256, 4
heads of 64, LayerNorm, QKV biases, a plain GELU MLP, a tied head; 16
frames of dim 128).

The reference's weights carry seeded noise on every QKV bias (the
decoder's, ``xattn``'s and the encoder's) and on the LayerNorm scales and
biases (``_torch_parity.CROSS_NOISE``), which start at zero and one.
float32, within ``tests/test_torch_model.py``'s ``TOL``
(``_torch_frontend``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from _torch_frontend import (ACT_TOL, check_attention, check_engine,
                             check_frontend_kv, check_prefill_and_decode,
                             check_prefill_needs_frontend, check_resume,
                             reference_run)
from _torch_parity import one_torch_thread

ARCH = "seamless-m4t-medium"


@pytest.fixture(scope="module")
def run():
    with one_torch_thread():
        yield reference_run(ARCH)


def _rep(tree, r: int):
    return {k: _rep(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def test_encoder_attention_matches_reference(run):
    """An encoder layer's attention: RoPE at 0..S-1, no mask."""
    check_attention(run, run.model.encoder[0].mixer,
                    _rep(run.params["encoder"], 0)["mixer"], "encoder")


def test_decoder_cross_attention_matches_reference(run):
    """A decoder layer's ``xattn`` over a memory (here the projected
    frontend): biases, no RoPE, no mask, Sq = 9 against Sk = 16."""
    _, memory = check_frontend_kv(run)
    check_attention(run, run.model.blocks[1].xattn,
                    _rep(run.params["blocks"]["pos0"], 1)["xattn"], "cross",
                    memory)


def test_frontend_and_encoder_match_reference(run):
    """``frontend_kv`` then ``encode`` (2 layers and ``enc_norm``) against
    ``_frontend_kv`` then ``_encode``."""
    fkv, want_fkv = check_frontend_kv(run)
    want = JT._encode(run.params, run.cfg, jnp.asarray(want_fkv))
    got = run.model.encode(fkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT_TOL)
    assert not torch.equal(got, fkv)


def test_prefill_and_decode_match_reference(run):
    check_prefill_and_decode(run)


def test_cache_from_jax_resumes_decode(run):
    check_resume(run)


def test_engine_admit_with_frontend_matches_reference(run):
    check_engine(run)


def test_prefill_without_frontend_raises(run):
    check_prefill_needs_frontend(run)
