"""The port's serving launcher (``repro_torch.launch.serve``) against the
JAX package's: the same flags print the same report.  Its own file, apart
from ``test_torch_serving.py``, so that a run that distributes test files
over workers can place these long cases beside the rest; torch runs on one
thread here (``_torch_parity.one_torch_thread``).
"""
import pytest

from repro_torch.launch import serve as t_serve
from _torch_parity import launcher_report, one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.mark.parametrize("arch", ["gemma3-12b", "mamba2-780m",
                                  "recurrentgemma-9b", "mixtral-8x22b"])
def test_launcher_matches_reference(arch):
    """``python -m repro_torch.launch.serve --arch <arch>`` with default
    flags otherwise prints what the reference's launcher prints (the
    reduced model, the same mix, 2000 rounds), given the reference's
    hardware numbers.  The printed stats do not depend on the weights,
    which differ (each package draws its own)."""
    want, got = launcher_report(["--arch", arch])
    assert got == want


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_launcher_refuses_frontend_archs(arch, monkeypatch):
    """An arch with a frontend is refused with a ``ValueError`` before any
    model is built: the launcher's scheduler admits requests with no
    frontend embeddings, as the reference's launcher does, and the
    reference fails there."""
    def built(*_, **__):
        raise AssertionError("a model was built")
    monkeypatch.setattr(t_serve.T, "init_model", built)
    monkeypatch.setattr(t_serve, "ServingEngine", built)
    with pytest.raises(ValueError, match="frontend"):
        t_serve.main(["--arch", arch])
