"""Mamba2 SSD chunked scan: the Hopper kernel's wrapper and its plain
version.

Port of ``src/repro/kernels/ssd_scan/ops.py`` (whose Pallas kernel is
``kernel.py::_ssd_kernel``).  ``ssd_scan`` runs the selective-SSM
recurrence over a whole prompt: on a CUDA tensor it launches
``csrc/ssd_scan.cu`` (built at first use) or raises; on a CPU tensor it
runs ``ssd_scan_plain`` (``ref.py``, the sequential recurrence).  Unlike the
reference wrapper it broadcasts no group to the heads and pads nothing: the
kernel reads group h // (H // G) and masks the ragged last chunk.
``LAUNCHES`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan as ssd_scan_plain

NAME = "ssd_scan"
SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
_FN = None
_DTYPES = (torch.float32, torch.bfloat16)
MAX_STATE = 256

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.build(NAME, SOURCE).ssd_scan_launch
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def build() -> float:
    """Build (or load) the kernel library; seconds the build took."""
    _launcher()
    return _build.BUILD_SECONDS[NAME]


def _check(name: str, t: torch.Tensor, shape, dtypes, dev) -> None:
    if t.device != dev or t.dtype not in dtypes or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"ssd_scan: {name} must be a contiguous {list(shape)} tensor of "
            f"{[str(d) for d in dtypes]} on {dev} (got {list(t.shape)} "
            f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()})")


def ssd_scan(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [Bsz, L, H, P]; a [Bsz, L, H] float32; B, C [Bsz, L, G, N] ->
    (y [Bsz, L, H, P] in x's dtype, final state [Bsz, H, P, N] float32).
    x, B and C are float32 or bf16 (B and C of one type)."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, a, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    global LAUNCHES
    dev = x.device
    if x.ndim != 4 or a.ndim != 3 or B.ndim != 4:
        raise ValueError(f"ssd_scan: x must be [Bsz, L, H, P], a [Bsz, L, H] "
                         f"and B, C [Bsz, L, G, N] (got {list(x.shape)}, "
                         f"{list(a.shape)}, {list(B.shape)})")
    Bsz, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if G == 0 or H % G or N > MAX_STATE or N % 4:
        raise ValueError(f"ssd_scan: needs H % G == 0, N <= {MAX_STATE} and "
                         f"N % 4 == 0 (H={H}, G={G}, N={N})")
    _check("x", x, (Bsz, L, H, P), _DTYPES, dev)
    _check("a", a, (Bsz, L, H), (torch.float32,), dev)
    _check("B", B, (Bsz, L, G, N), _DTYPES, dev)
    _check("C", C, (Bsz, L, G, N), (B.dtype,), dev)
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    err = _launcher()(
        int(x.dtype == torch.bfloat16), int(B.dtype == torch.bfloat16),
        x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), state.data_ptr(), Bsz, L, H, P, G, N,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y, state
