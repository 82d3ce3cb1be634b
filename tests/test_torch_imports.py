"""Import guard: the PyTorch port never imports JAX or the JAX package."""
import pathlib
import re
import subprocess
import sys

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PORT.rglob("*.py"))


def test_port_modules_import_without_jax():
    """Importing every module of the port, in a fresh interpreter, pulls in
    neither ``jax`` nor any ``repro.`` module."""
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(SRC)!r})\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'jax' or k.startswith(('jax.', 'jaxlib'))\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    assert "repro_torch.core.engine" in MODULES


@pytest.mark.parametrize("path", sorted(p.relative_to(SRC).as_posix()
                                        for p in PORT.rglob("*.py")))
def test_port_sources_name_no_jax_import(path):
    text = (SRC / path).read_text()
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|from\s+repro\.|"
                     r"import\s+repro\.|from\s+repro\s+import|import\s+repro\b)",
                     re.M)
    assert not pat.search(text), path


@pytest.mark.parametrize("module", [
    "repro_torch.kernels.token_bucket.ops", "repro_torch.core.engine",
    "repro_torch.core.controller", "repro_torch.core.runtime"])
def test_port_module_imports_first(module):
    """Any of the port's entry modules can be the first one a program
    imports (the smoke starts with the kernels' wrappers): no import
    cycle through ``repro_torch.core``, whose ``FleetController`` loads
    on first use."""
    code = (f"import sys\nsys.path.insert(0, {str(SRC)!r})\n"
            f"import {module}\nimport repro_torch.core as core\n"
            "print(core.FleetController.__name__, core.TenantEvent.__name__)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["FleetController", "TenantEvent"]
