"""``kernels/_build.py`` names each kernel library by everything that goes
into it: every file of the kernel's ``csrc/`` directory (headers included),
every file of the shared header directory ``csrc_common/``, the source
compiled, and the flags.  These checks run on the CPU and never call
``nvcc``."""
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
    common = tmp_path / "csrc_common"
    common.mkdir()
    (common / "shared.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "COMMON_DIR", common)
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


def _edit_common_header(d):
    (_build.COMMON_DIR / "shared.cuh").write_text("#pragma once\n// v2\n")


def _add_common_header(d):
    (_build.COMMON_DIR / "more.cuh").write_text("// new\n")


@pytest.mark.parametrize("edit", [_edit_header, _edit_source, _add_header,
                                  _rename_header, _edit_common_header,
                                  _add_common_header],
                         ids=["header", "source", "new-file", "renamed",
                              "common-header", "common-new-file"])
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


def test_common_header_is_shared_by_every_library(csrc):
    """A change to the shared header directory renames every kernel's
    library, so each rebuilds against it."""
    other = csrc.parent.parent / "other" / "csrc"
    other.mkdir(parents=True)
    (other / "other.cu").write_text("int k();\n")
    srcs = [csrc / "kern.cu", other / "other.cu"]
    before = [_build._lib_path(n, s) for n, s in zip(("kern", "other"), srcs)]
    _edit_common_header(csrc)
    after = [_build._lib_path(n, s) for n, s in zip(("kern", "other"), srcs)]
    assert all(a != b for a, b in zip(after, before))


def test_port_kernels_include_the_common_header():
    """The moved Hopper header lives in the shared directory and is not
    copied beside a kernel."""
    assert (_build.COMMON_DIR / "hopper_ptx.cuh").is_file()
    kernels = _build.COMMON_DIR.parent
    assert not list(kernels.glob("*/csrc/hopper_ptx.cuh"))
    for name in ("flash_prefill/csrc/flash_prefill.cu",
                 "ssd_scan/csrc/ssd_scan_tc.cu"):
        assert '#include "hopper_ptx.cuh"' in (kernels / name).read_text()
