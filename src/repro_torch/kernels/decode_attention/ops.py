"""GQA decode attention: the Hopper kernel's wrapper and its plain version.

Port of ``src/repro/kernels/decode_attention/ops.py`` (whose Pallas kernel
is ``kernel.py::_decode_attn_kernel``).  ``decode_attention`` attends one
query token per sequence to its KV cache: on a CUDA tensor it launches
``csrc/decode_attention.cu`` (built at first use) or raises; on a CPU
tensor it runs ``decode_attention_plain`` (``ref.py``).  ``LAUNCHES``
counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import \
    decode_attention as decode_attention_plain

NAME = "decode_attention"
SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / \
    "decode_attention.cu"
_FN = None
_DTYPES = (torch.float32, torch.bfloat16)
#: the kernel keeps D / 32 head-dim elements a lane in registers
MAX_HEAD_DIM = 256
#: blocks to aim for when splitting S: four for each of the H100's 132 SMs
TARGET_BLOCKS = 4 * 132

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.build(NAME, SOURCE).decode_attention_launch
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def build() -> float:
    """Build (or load) the kernel library; seconds the build took."""
    _launcher()
    return _build.BUILD_SECONDS[NAME]


def group_chunk(G: int) -> int:
    """Query heads one block serves: the smallest of 1, 2, 4, 8 that holds
    the group, at most 8 (larger groups take several blocks)."""
    return next(c for c in (1, 2, 4, 8) if c >= min(G, 8))


def n_splits(B: int, KvH: int, G: int, S: int) -> int:
    """Cache-row ranges S is split into, so that B * KvH * ceil(G / gc) *
    splits reaches ``TARGET_BLOCKS``, with at least 32 rows a range."""
    blocks = B * KvH * -(-G // group_chunk(G))
    want = -(-TARGET_BLOCKS // max(blocks, 1))
    return max(1, min(want, -(-S // 32)))


def _check(name: str, x: torch.Tensor, shape, dtypes, dev) -> None:
    if x.device != dev or x.dtype not in dtypes or not x.is_contiguous() \
            or tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"decode_attention: {name} must be a contiguous {list(shape)} "
            f"tensor of {[str(d) for d in dtypes]} on {dev} (got "
            f"{list(x.shape)} {x.dtype} on {x.device}, contiguous="
            f"{x.is_contiguous()})")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, window: int = 0
                     ) -> torch.Tensor:
    """q [B, H, D]; k, v [B, S, KvH, D]; lengths [B] int32 -> [B, H, D] in
    q's dtype.  Position s of sequence b is attended iff s < lengths[b] and,
    when ``window > 0``, s >= lengths[b] - window.  q and the cache may
    differ in dtype (float32 or bf16 each)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    global LAUNCHES
    dev = q.device
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError(f"decode_attention: q must be [B, H, D] and k, v "
                         f"[B, S, KvH, D] (got {list(q.shape)}, "
                         f"{list(k.shape)})")
    B, H, D = q.shape
    S, KvH = k.shape[1], k.shape[2]
    if KvH == 0 or H % KvH or D > MAX_HEAD_DIM or S == 0:
        raise ValueError(f"decode_attention: needs H % KvH == 0, D <= "
                         f"{MAX_HEAD_DIM} and S > 0 (H={H}, KvH={KvH}, D={D},"
                         f" S={S})")
    _check("q", q, (B, H, D), _DTYPES, dev)
    _check("k", k, (B, S, KvH, D), _DTYPES, dev)
    _check("v", v, (B, S, KvH, D), (k.dtype,), dev)
    _check("lengths", lengths, (B,), (torch.int32,), dev)
    G = H // KvH
    nsplit = n_splits(B, KvH, G, S)
    out = torch.empty_like(q)
    # the split pass's partial sums; freeing them on return is safe: the
    # caching allocator hands their memory only to work queued later on
    # the same stream
    part_ml = torch.empty((B, H, nsplit, 2), dtype=torch.float32, device=dev)
    part_acc = torch.empty((B, H, nsplit, D), dtype=torch.float32,
                           device=dev)
    err = _launcher()(
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
        group_chunk(G), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part_ml.data_ptr(),
        part_acc.data_ptr(), B, H, KvH, S, D, int(window), D ** -0.5, nsplit,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out
