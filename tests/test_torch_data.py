"""The port's data pipeline (``repro_torch.data.pipeline``) against the JAX
package's (``repro.data.pipeline``): batches bitwise for any (seed, step),
``start_step`` included, and the frontend stub equal within one process
(it seeds with ``hash(kind)``, which Python salts per process)."""
import itertools

import numpy as np
import pytest

from repro.data import pipeline as JP
from repro_torch.data import pipeline as TP


@pytest.mark.parametrize("seed,start,vocab,seq,batch", [
    (0, 0, 512, 64, 4), (7, 0, 49152, 128, 2), (3, 5, 1000, 33, 3),
    (11, 1000, 64, 8, 1)])
def test_batches_match_reference_bitwise(seed, start, vocab, seq, batch):
    kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    ref = JP.SyntheticLM(JP.DataConfig(**kw)).batches(start_step=start)
    got = TP.SyntheticLM(TP.DataConfig(**kw)).batches(start_step=start)
    for a, b in itertools.islice(zip(ref, got), 3):
        assert a["step"] == b["step"]
        for key in ("tokens", "mask"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_data_config_defaults_match_reference():
    assert TP.DataConfig(1, 2, 3).__dict__ == JP.DataConfig(1, 2, 3).__dict__


@pytest.mark.parametrize("kind,seed", [("audio", 0), ("vision", 3)])
def test_frontend_stub_matches_reference_in_one_process(kind, seed):
    a = JP.frontend_stub(kind, 2, 40, 24, seed=seed)
    b = TP.frontend_stub(kind, 2, 40, 24, seed=seed)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
