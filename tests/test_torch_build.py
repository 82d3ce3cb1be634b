"""``kernels/_build.py`` names each kernel library by everything that goes
into it: every file of the kernel's ``csrc/`` directory (headers included),
the source compiled, and the flags.  These checks run on the CPU and never
call ``nvcc``."""
import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A kernel directory with a source and a header beside it; ``nvcc``
    may not be called."""
    def no_nvcc(*a, **kw):
        raise AssertionError("nvcc called")
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build.subprocess, "Popen", no_nvcc)
    d = tmp_path / "kern" / "csrc"
    d.mkdir(parents=True)
    (d / "kern.cu").write_text('#include "helpers.cuh"\nint f();\n')
    (d / "helpers.cuh").write_text("#pragma once\n")
    (tmp_path / "kern" / "ops.py").write_text("x = 1\n")
    return d


def _edit_header(d):
    (d / "helpers.cuh").write_text("#pragma once\n#define TILE 64\n")


def _edit_source(d):
    (d / "kern.cu").write_text('#include "helpers.cuh"\nint g();\n')


def _add_header(d):
    (d / "sub").mkdir()
    (d / "sub" / "more.cuh").write_text("// new\n")


def _rename_header(d):
    (d / "helpers.cuh").rename(d / "other.cuh")


@pytest.mark.parametrize("edit", [_edit_header, _edit_source, _add_header,
                                  _rename_header],
                         ids=["header", "source", "new-file", "renamed"])
def test_edit_in_csrc_changes_library_path(csrc, edit):
    src = csrc / "kern.cu"
    before = _build._lib_path("kern", src)
    assert _build._lib_path("kern", src) == before      # deterministic
    edit(csrc)
    after = _build._lib_path("kern", src)
    assert after != before
    assert after.parent == before.parent == _build.BUILD_DIR
    assert after.name.startswith("libkern-") and after.suffix == ".so"


def test_flags_change_library_path(csrc, monkeypatch):
    src = csrc / "kern.cu"
    before = _build._lib_path("kern", src)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._lib_path("kern", src) != before


def test_files_outside_csrc_leave_library_path(csrc):
    src = csrc / "kern.cu"
    before = _build._lib_path("kern", src)
    (csrc.parent / "ops.py").write_text("x = 2\n")
    (csrc.parent / "notes.txt").write_text("unrelated\n")
    assert _build._lib_path("kern", src) == before


def test_which_source_is_compiled_is_hashed(csrc):
    (csrc / "other.cu").write_text("int h();\n")
    assert _build._lib_path("kern", csrc / "kern.cu") != \
        _build._lib_path("kern", csrc / "other.cu")
