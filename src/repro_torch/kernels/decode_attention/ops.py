"""GQA decode attention: the Hopper kernel's wrapper and its plain version.

Port of ``src/repro/kernels/decode_attention/ops.py`` (whose Pallas kernel
is ``kernel.py::_decode_attn_kernel``).  ``decode_attention`` attends one
query token per sequence to its KV cache: on a CUDA tensor it launches
``csrc/decode_attention.cu`` (built at first use) or raises; on a CPU
tensor it runs ``decode_attention_plain`` (``ref.py``).  One launch a call
(a grid of thread-block clusters); the wrapper allocates only the output
and never reads ``lengths`` back.  ``decode_attention_partial`` is the same
kernel writing, besides the float32 output, each head's merged softmax
max and sum (``ml``): a slice of a sequence's partial, which the
sequence-sharded decode (``repro_torch.distributed.collectives``) combines
across ranks; its plain version is ``ref.decode_attention_partial``.
``LAUNCHES`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import \
    decode_attention as decode_attention_plain, \
    decode_attention_partial as decode_attention_partial_plain

NAME = "decode_attention"
SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / \
    "decode_attention.cu"
_FN = None
_DTYPES = (torch.float32, torch.bfloat16)
#: the kernel keeps D / 32 head-dim elements a lane in registers
MAX_HEAD_DIM = 256
#: the H100's SMs
SMS = 132
#: caches of at most this many rows are short: a call is bound by latency,
#: not bytes, and its CTAs aim at two an SM; longer caches aim at one an
#: SM, with twice the ring, which gives every CTA an SM's share of the
#: bandwidth (measured: ``rehearse.py --plans``)
SHORT_S = 512
#: the kernel's largest (portable) thread-block cluster
MAX_CLUSTER = 8
#: row tiles in flight in a CTA's ring (``STAGES`` in the source)
STAGES = 4
#: shared memory for a CTA's ring over a short cache, so that three CTAs
#: fit an SM (twice this over a longer cache, one CTA an SM)
RING_BYTES = 64 * 1024
MAX_TILE_ROWS = 16

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.build(NAME, SOURCE).decode_attention_launch
        fn.argtypes = ([ctypes.c_int] * 5 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 6 + [ctypes.c_float,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def build() -> float:
    """Build (or load) the kernel library; seconds the build took."""
    _launcher()
    return _build.BUILD_SECONDS[NAME]


def group_chunk(G: int) -> int:
    """Query heads one CTA serves: the smallest of 1, 2, 4, 8 that holds
    the group, at most 8 (larger groups take several CTAs)."""
    return next(c for c in (1, 2, 4, 8) if c >= min(G, 8))


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, KvH: int, G: int, S: int, row_bytes: int
                ) -> tuple[int, int, int]:
    """``(gc, cluster, tile_rows)`` for a call, from its shapes alone (the
    lengths stay on the card, so a call never waits for the device): query
    heads a CTA, CTAs a cluster (each takes a share of the valid rows), and
    cache rows a tile of the CTA's ring, as many as fit its ring in
    ``STAGES`` tiles of K and V rows of ``row_bytes`` each.  A short cache
    (``SHORT_S``) aims at two CTAs an SM with ``RING_BYTES`` a ring, a
    longer one at one CTA an SM with twice that.  Clusters are the largest
    power of two, up to ``MAX_CLUSTER``, that keeps the grid within that
    (one CTA a cluster where the heads alone reach it), and never more
    CTAs than S has row tiles."""
    gc = group_chunk(G)
    heads = B * KvH * -(-G // gc)
    short = S <= SHORT_S
    ring = RING_BYTES * (1 if short else 2)
    tile_rows = max(1, min(MAX_TILE_ROWS, S,
                           ring // (STAGES * 2 * row_bytes)))
    target = SMS * (2 if short else 1)
    cluster = 1
    while (2 * cluster <= MAX_CLUSTER and 2 * cluster * heads <= target
           and 2 * cluster * tile_rows <= S):
        cluster *= 2
    return gc, cluster, tile_rows


def _refuse(q, k, v, lengths, why: str):
    raise ValueError(
        f"decode_attention: {why} (q {list(q.shape)} {q.dtype} on "
        f"{q.device}; k {list(k.shape)} {k.dtype}, v {list(v.shape)} "
        f"{v.dtype}, lengths {list(lengths.shape)} {lengths.dtype})")


def _check(q, k, v, lengths) -> int:
    """Refuse what the kernel cannot take; the row bytes of the cache."""
    dev = q.device
    if q.ndim != 3 or k.ndim != 4:
        _refuse(q, k, v, lengths, "q must be [B, H, D] and k, v "
                "[B, S, KvH, D]")
    B, H, D = q.shape
    S, KvH = k.shape[1], k.shape[2]
    if KvH == 0 or H % KvH or D > MAX_HEAD_DIM or S == 0:
        _refuse(q, k, v, lengths, f"needs H % KvH == 0, D <= "
                f"{MAX_HEAD_DIM} and S > 0")
    if not (q.dtype in _DTYPES and k.dtype in _DTYPES
            and v.dtype == k.dtype and lengths.dtype == torch.int32):
        _refuse(q, k, v, lengths, "q, k float32 or bf16, v as k, lengths "
                "int32")
    if not (k.device == dev and v.device == dev and lengths.device == dev):
        _refuse(q, k, v, lengths, "every tensor on q's device")
    if k.shape != (B, S, KvH, D) or v.shape != k.shape or \
            lengths.shape != (B,):
        _refuse(q, k, v, lengths, "shapes must agree")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and lengths.is_contiguous()):
        _refuse(q, k, v, lengths, "every tensor contiguous")
    row_bytes = D * k.element_size()
    if row_bytes % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        _refuse(q, k, v, lengths, "a cache row must be a multiple of 16 "
                "bytes and k, v 16-byte aligned")
    return row_bytes


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, window: int = 0
                     ) -> torch.Tensor:
    """q [B, H, D]; k, v [B, S, KvH, D]; lengths [B] int32 -> [B, H, D] in
    q's dtype.  Position s of sequence b is attended iff s < lengths[b] and,
    when ``window > 0``, s >= lengths[b] - window.  q and the cache may
    differ in dtype (float32 or bf16 each).  On the card a cache row (D
    elements) must fill whole 16-byte units and k, v start 16-byte
    aligned: the kernel copies rows in those units."""
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, window=window)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {dev}")
    global LAUNCHES
    row_bytes = _check(q, k, v, lengths)
    B, H, _ = q.shape
    S, KvH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    _launch(q, k, v, lengths, out, None, window,
            launch_plan(B, KvH, H // KvH, S, row_bytes))
    LAUNCHES += 1
    return out


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, lengths: torch.Tensor, *,
                             window: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The attention of q [B, H, D] (cast to float32) over the rows of
    k, v [B, S, KvH, D] that ``lengths`` [B] int32 and ``window`` select,
    as ``decode_attention`` selects them, with the softmax's statistics:
    (out [B, H, D] float32 normalised over those rows, ml [B, H, 2]
    float32: the max m of the scaled scores and the sum l of exp(score -
    m)).  A head with no row gives out 0, m = -1e30, l = 0.  A length may
    be <= 0 or > S (a slice of a longer sequence: ``lengths - offset``).
    One launch of the kernel on a CUDA tensor; the plain version on a CPU
    one."""
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_partial_plain(q, k, v, lengths,
                                              window=window)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_partial: unsupported device "
                         f"{dev}")
    global LAUNCHES
    q = q.float().contiguous()
    row_bytes = _check(q, k, v, lengths)
    B, H, _ = q.shape
    S, KvH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    ml = torch.empty((B, H, 2), dtype=torch.float32, device=dev)
    _launch(q, k, v, lengths, out, ml, window,
            launch_plan(B, KvH, H // KvH, S, row_bytes))
    LAUNCHES += 1
    return out, ml


def _launch(q, k, v, lengths, out, ml, window: int, plan) -> None:
    """One launch of the kernel on checked tensors under ``plan``, on the
    current stream (read raw: a ``torch.cuda.Stream`` object costs
    microseconds of host time, and a decode step calls this once a
    layer); ``ml`` None passes a null pointer."""
    B, H, D = q.shape
    _, S, KvH, _ = k.shape
    err = _launcher()(
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
        *plan, q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), None if ml is None else ml.data_ptr(), B, H, KvH, S,
        D, int(window), D ** -0.5,
        torch._C._cuda_getCurrentRawStream(q.device.index))
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")


def occupancy(q_dtype, kv_dtype, plan, D: int) -> tuple[int, int]:
    """(CTAs an SM holds, clusters the card holds at once) for ``plan``,
    from the CUDA occupancy calculator (needs the card)."""
    fn = _build.build(NAME, SOURCE).decode_attention_occupancy
    fn.restype = ctypes.c_int
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(int(q_dtype == torch.bfloat16), int(kv_dtype == torch.bfloat16),
             *(ctypes.c_int(x) for x in plan), ctypes.c_int(D),
             ctypes.byref(blocks), ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"decode_attention occupancy: CUDA error {err}")
    return blocks.value, clusters.value
