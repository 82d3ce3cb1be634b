"""The port's cross-attention family (layer kind ``cross``, the ``vision``
frontend) against the JAX package, at the reduced llama-3.2-vision-11b
(``get_reduced_config``: 5 layers, global x 4 then cross; d_model 256, 4
query heads on one KV head of 64; 16 patch embeddings of dim 128).

The reference's weights carry seeded noise on the gate (``xgate`` is zero
at init, which would silence the cross layer) and on the norm scales
(``_torch_parity.CROSS_NOISE``).  float32, within
``tests/test_torch_model.py``'s ``TOL`` (``_torch_frontend``).
"""
import pytest

from _torch_frontend import (check_attention, check_engine,
                             check_frontend_kv, check_prefill_and_decode,
                             check_prefill_needs_frontend, check_resume,
                             reference_run)
from _torch_parity import one_torch_thread

ARCH = "llama-3.2-vision-11b"


@pytest.fixture(scope="module")
def run():
    with one_torch_thread():
        yield reference_run(ARCH)


def test_config_has_one_cross_layer_with_a_live_gate(run):
    assert run.cfg.layer_kinds() == ["global"] * 4 + ["cross"]
    blk = run.model.blocks[4]
    assert blk.kind == "cross" and not blk.has_xattn
    assert float(blk.xgate) != 0.0


def test_cross_attention_matches_reference(run):
    """The cross layer's attention over the projected frontend: no RoPE,
    no mask, Sq = 9 against Sk = 16."""
    memory, _ = check_frontend_kv(run)
    ref_p = {k: v[0] for k, v in
             run.params["blocks"]["pos4"]["mixer"].items()}
    check_attention(run, run.model.blocks[4].mixer, ref_p, "cross",
                    memory.numpy())


def test_prefill_and_decode_match_reference(run):
    check_prefill_and_decode(run)


def test_cache_from_jax_resumes_decode(run):
    check_resume(run)


def test_engine_admit_with_frontend_matches_reference(run):
    check_engine(run)


def test_prefill_without_frontend_raises(run):
    check_prefill_needs_frontend(run)
