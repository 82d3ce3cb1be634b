"""Flash-prefill attention: the Hopper kernel's wrapper and its plain
version.

Port of ``src/repro/kernels/flash_prefill/ops.py`` (whose Pallas kernel is
``kernel.py::_flash_kernel``).  ``flash_prefill`` is causal GQA attention
over a whole prompt with optional sliding-window and chunked-local masks:
on a CUDA tensor it launches ``csrc/flash_prefill.cu`` (built at first use)
or raises; on a CPU tensor it runs ``flash_prefill_plain`` (``ref.py``).
Unlike the reference wrapper it repeats no KV head and pads nothing: the
kernel indexes KV head h // G.  ``LAUNCHES`` counts kernel launches and
nothing else.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.ref import \
    flash_prefill as flash_prefill_plain

NAME = "flash_prefill"
SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / \
    "flash_prefill.cu"
_FN = None
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.build(NAME, SOURCE).flash_prefill_launch
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 9 + [ctypes.c_float,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def build() -> float:
    """Build (or load) the kernel library; seconds the build took."""
    _launcher()
    return _build.BUILD_SECONDS[NAME]


def _check(name: str, x: torch.Tensor, shape, dtypes, dev) -> None:
    if x.device != dev or x.dtype not in dtypes or not x.is_contiguous() \
            or tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"flash_prefill: {name} must be a contiguous {list(shape)} "
            f"tensor of {[str(d) for d in dtypes]} on {dev} (got "
            f"{list(x.shape)} {x.dtype} on {x.device}, contiguous="
            f"{x.is_contiguous()})")


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0, chunk_size: int = 0, causal: bool = True
                  ) -> torch.Tensor:
    """q [B, Sq, H, D]; k, v [B, Sk, KvH, D] -> [B, Sq, H, D] in q's dtype.
    Query i attends key j iff (without ``causal``, always) j <= i, and
    i - j < window when ``window > 0``, and i // chunk_size ==
    j // chunk_size when ``chunk_size > 0``."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, window=window,
                                   chunk_size=chunk_size, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    global LAUNCHES
    dev = q.device
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"flash_prefill: q must be [B, Sq, H, D] and k, v "
                         f"[B, Sk, KvH, D] (got {list(q.shape)}, "
                         f"{list(k.shape)})")
    B, Sq, H, D = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    if KvH == 0 or H % KvH or D > MAX_HEAD_DIM:
        raise ValueError(f"flash_prefill: needs H % KvH == 0 and D <= "
                         f"{MAX_HEAD_DIM} (H={H}, KvH={KvH}, D={D})")
    _check("q", q, (B, Sq, H, D), _DTYPES, dev)
    _check("k", k, (B, Sk, KvH, D), _DTYPES, dev)
    _check("v", v, (B, Sk, KvH, D), (k.dtype,), dev)
    out = torch.empty_like(q)
    err = _launcher()(
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KvH, D, int(window), int(chunk_size), int(causal),
        D ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_prefill kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
