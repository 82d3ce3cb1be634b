"""Flash-prefill attention: the Hopper kernel's wrapper and its plain
version.

Port of ``src/repro/kernels/flash_prefill/ops.py`` (whose Pallas kernel is
``kernel.py::_flash_kernel``).  ``flash_prefill`` is causal GQA attention
over a whole prompt with optional sliding-window and chunked-local masks:
on a CUDA tensor it launches a kernel of ``csrc/flash_prefill.cu`` (built
at first use) or raises; on a CPU tensor it runs ``flash_prefill_plain``
(``ref.py``).  Unlike the reference wrapper it repeats no KV head and pads D
only to a multiple of 8 where it must: the kernels index KV head h // G.

Two kernels, chosen by operand type alone (``kernel_path``):

* bf16 q, k and v (what the models pass): the tensor-core kernel
  (``flash_prefill_tc_launch``: TMA, mbarriers, wgmma on bf16 tiles, P
  rounded to bf16);
* float32 or mixed operands: the CUDA-core kernel (``flash_prefill_launch``,
  float32 products), since a float32 caller asked for float32 products.

There is no fallback: if the chosen kernel fails to build or launch, the
wrapper raises.  ``LAUNCHES`` counts kernel launches and nothing else;
``LAUNCHES_BY_PATH`` splits them by kernel and ``LAUNCHES_BY_MASK`` by
mask.  Without ``causal`` the kernel masks no key but those past Sk, so Sq
and Sk may differ (a cross-attention prefill: prompt against memory).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.ref import \
    flash_prefill as flash_prefill_plain

NAME = "flash_prefill"
SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / \
    "flash_prefill.cu"
_FNS = None
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
#: the same launches by kernel: ``kernel_path``'s names
LAUNCHES_BY_PATH = {"tensor_core": 0, "cuda_core": 0}
#: the same launches by mask and shape: ``causal``; ``full`` (no mask,
#: Sq = Sk: an encoder's self-attention, or a prompt as long as the
#: cross-attention memory it attends); ``full_cross`` (no mask, Sq != Sk)
LAUNCHES_BY_MASK = {"causal": 0, "full": 0, "full_cross": 0}


def _launchers():
    """(tensor-core entry point, CUDA-core entry point)."""
    global _FNS
    if _FNS is None:
        lib = _build.build(NAME, SOURCE)
        tc, cc = lib.flash_prefill_tc_launch, lib.flash_prefill_launch
        tc.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        cc.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 9 + [ctypes.c_float,
                                               ctypes.c_void_p])
        tc.restype = cc.restype = ctypes.c_int
        _FNS = (tc, cc)
    return _FNS


def build() -> float:
    """Build (or load) the kernel library; seconds the build took."""
    _launchers()
    return _build.BUILD_SECONDS[NAME]


def kernel_path(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> str:
    """The kernel a CUDA call with these operand types launches:
    ``"tensor_core"`` for bf16 q, k and v, ``"cuda_core"`` otherwise."""
    if q_dtype == kv_dtype == torch.bfloat16:
        return "tensor_core"
    return "cuda_core"


def _tc_operand(x: torch.Tensor, d8: int) -> torch.Tensor:
    """``x`` as the tensor-core kernel takes it: head dim padded with zeros
    to a multiple of 8 (TMA's 16-byte rows) and a 16-byte aligned start.
    Both hold for the models' tensors, which pass unchanged."""
    if x.shape[-1] != d8:
        return F.pad(x, (0, d8 - x.shape[-1]))
    return x if x.data_ptr() % 16 == 0 else x.clone()


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
    Query i attends key j < Sk iff (without ``causal``, always) j <= i, and
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
    path = kernel_path(q.dtype, k.dtype)
    tc, cc = _launchers()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if path == "tensor_core":
        d8 = -(-D // 8) * 8
        q, k, v = (_tc_operand(x, d8) for x in (q, k, v))
        out = torch.empty_like(q)
        err = tc(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, H, KvH, d8, int(window), int(chunk_size),
                 int(causal), D ** -0.5, stream)
        if d8 != D:
            out = out[..., :D].contiguous()
    else:
        out = torch.empty_like(q)
        err = cc(int(q.dtype == torch.bfloat16),
                 int(k.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), B, Sq, Sk, H, KvH, D,
                 int(window), int(chunk_size), int(causal), D ** -0.5,
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_prefill {path} kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_PATH[path] += 1
    LAUNCHES_BY_MASK["causal" if causal else
                     "full" if Sq == Sk else "full_cross"] += 1
    return out
