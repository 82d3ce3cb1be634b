"""Build the port's CUDA kernels from the sources in the checkout.

Each kernel is one ``.cu`` file with a plain C interface (it may include
headers beside it in its ``csrc/`` directory, and the shared Hopper headers
of ``kernels/csrc_common/``, which every build gets with ``-I``), compiled
by ``nvcc`` into a shared library and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries go to ``build/repro_torch/``
at the repository root, named by a hash of every file in the source's
directory and in ``csrc_common/``, the source's name and the flags, so a
changed source or header rebuilds and an unchanged one loads the cached
library.  Nothing here runs at import time: the first launch builds.
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
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
#: headers shared by the kernels (``-I`` of every build, hashed into every
#: library's name)
COMMON_DIR = pathlib.Path(__file__).resolve().parent / "csrc_common"
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"

#: seconds each library took to build in this process (0.0 = cache hit)
BUILD_SECONDS: dict[str, float] = {}
#: ptxas's report (registers, shared memory, spills) of each kernel built
#: in this process
PTXAS_INFO: dict[str, str] = {}
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


def _lib_path(name: str, source: pathlib.Path) -> pathlib.Path:
    """Where the library of ``source`` lives: named by a hash of every file
    under the source's directory (its headers too) and under
    ``COMMON_DIR``, which of them is compiled, and the flags."""
    source = pathlib.Path(source).resolve()
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    h.update(b"\0" + source.name.encode())
    for tag, root in ((b"csrc", source.parent), (b"common", COMMON_DIR)):
        for f in sorted(p for p in root.rglob("*") if p.is_file()):
            rel = f.relative_to(root).as_posix().encode()
            h.update(b"\0" + tag + b"/" + rel + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_many(kernels: list[tuple[str, pathlib.Path]]) -> dict[str, float]:
    """Compile every ``(name, source)`` pair not built yet, one ``nvcc``
    process each, all started together, then load them.  Returns the
    seconds each library took (0.0 = cache hit)."""
    t0 = time.perf_counter()
    procs = []
    for name, source in kernels:
        if name in _LOADED:
            continue
        lib_path = _lib_path(name, source)
        if lib_path.exists():
            procs.append((name, source, lib_path, None, None))
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(COMMON_DIR),
               "-o", tmp, str(source)]
        procs.append((name, source, lib_path, tmp,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, source, lib_path, tmp, proc in procs:
        if proc is not None:
            _, err = proc.communicate()
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed for {source}:\n{err}")
                continue
            os.replace(tmp, lib_path)     # atomic: a concurrent loader never
                                          # sees a half-written library
            PTXAS_INFO[name] = err
            BUILD_SECONDS[name] = time.perf_counter() - t0
        else:
            BUILD_SECONDS[name] = 0.0
        _LOADED[name] = ctypes.CDLL(str(lib_path))
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: BUILD_SECONDS[name] for name, _ in kernels}


def build(name: str, source: pathlib.Path) -> ctypes.CDLL:
    """Compile ``source`` (once per content hash) and load it."""
    if name not in _LOADED:
        build_many([(name, source)])
    return _LOADED[name]
