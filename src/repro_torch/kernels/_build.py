"""Build the port's CUDA kernels from the sources in the checkout.

Each kernel is one ``.cu`` file with a plain C interface, compiled by
``nvcc`` into a shared library and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries go to ``build/repro_torch/``
at the repository root, named by a hash of the source and the flags, so a
changed source rebuilds and an unchanged one loads the cached library.
Nothing here runs at import time: the first launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"

#: seconds each library took to build in this process (0.0 = cache hit)
BUILD_SECONDS: dict[str, float] = {}
_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on ``PATH`` or
    ``/usr/local/cuda/bin/nvcc``."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source on the machine with the card")


def build(name: str, source: pathlib.Path) -> ctypes.CDLL:
    """Compile ``source`` (once per content hash) and load it."""
    if name in _LOADED:
        return _LOADED[name]
    src = pathlib.Path(source).read_bytes()
    flags = ARCH_FLAGS + NVCC_FLAGS
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    t0 = time.perf_counter()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *flags, "-o", tmp, str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
        os.replace(tmp, lib_path)     # atomic: a concurrent loader never
                                      # sees a half-written library
    BUILD_SECONDS[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[name] = lib
    return lib
