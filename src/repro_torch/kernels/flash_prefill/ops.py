"""Flash-prefill attention: the Hopper kernels' wrappers and their plain
versions, forward and gradient.

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

Training (``flash_attention``, a ``torch.autograd.Function``): the forward
is the same kernel asked for each row's log-sum-exp too
(``flash_prefill_lse``: a nullable output of both kernels, so serving's
launches write none), and the backward is a kernel of its own,
``csrc/flash_backward.cu`` (``flash_backward``), chosen by
``backward_path``: bf16 operands with D <= 256 (the models' path) on the
tensor cores (TMA and wgmma; three launches a call: dQ with Di =
rowsum(dO O), then dK and dV as float32 partial sums over slices of each
KV head's query heads, ``dkdv_splits`` / ``head_splits``, then their sum
in slice order: no atomics, the same bits run to run), float32 ones on
the CUDA cores (two launches a call: dQ with Di, then dK and dV summed
over each KV head's query heads).  On a CPU tensor both run their plain
versions (``ref.py``).  ``LAUNCHES_WITH_LSE`` counts the forward's
launches that wrote the LSE (they count in ``LAUNCHES`` too);
``LAUNCHES_BY_PATH`` gains ``backward_tensor_core`` and
``backward_cuda_core``, ``BACKWARD_LAUNCHES[path]`` each a backward call.
``PLAIN_CALLS`` counts calls of the plain versions, on any device.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill import ref

NAME = "flash_prefill"
SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / \
    "flash_prefill.cu"
BWD_NAME = "flash_backward"
BWD_SOURCE = SOURCE.parent / "flash_backward.cu"
_FNS = None
_BWD = None
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
#: the backward kernels' launches a call, by ``backward_path``
BACKWARD_LAUNCHES = {"tensor_core": 3, "cuda_core": 2}
#: the same launches by kernel: ``kernel_path``'s names; and the backward
#: kernels' launches (``BACKWARD_LAUNCHES`` a call) by ``backward_path``
LAUNCHES_BY_PATH = {"tensor_core": 0, "cuda_core": 0,
                    "backward_tensor_core": 0, "backward_cuda_core": 0}
#: the forward launches that also wrote each row's LSE (training), by kernel
LAUNCHES_WITH_LSE = {"tensor_core": 0, "cuda_core": 0}
#: calls of the plain versions (forward, forward with LSE, backward)
PLAIN_CALLS = {"forward": 0, "forward_lse": 0, "backward": 0}
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
        tc.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        cc.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 9 + [ctypes.c_float,
                                               ctypes.c_void_p])
        tc.restype = cc.restype = ctypes.c_int
        _FNS = (tc, cc)
    return _FNS


def _backward_launchers():
    """(tensor-core entry point, CUDA-core entry point) of the backward."""
    global _BWD
    if _BWD is None:
        lib = _build.build(BWD_NAME, BWD_SOURCE)
        tc, cc = lib.flash_backward_tc_launch, lib.flash_backward_launch
        tc.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        cc.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 9 + [ctypes.c_float,
                                               ctypes.c_void_p])
        tc.restype = cc.restype = ctypes.c_int
        _BWD = (tc, cc)
    return _BWD


def build() -> float:
    """Build (or load) the kernel libraries, forward and backward; seconds
    the builds took."""
    _build.build_many([(NAME, SOURCE), (BWD_NAME, BWD_SOURCE)])
    _launchers()
    _backward_launchers()
    return max(_build.BUILD_SECONDS[NAME], _build.BUILD_SECONDS[BWD_NAME])


def flash_prefill_plain(q, k, v, *, window: int = 0, chunk_size: int = 0,
                        causal: bool = True) -> torch.Tensor:
    """The plain version (``ref.flash_prefill``), counted."""
    PLAIN_CALLS["forward"] += 1
    return ref.flash_prefill(q, k, v, window=window, chunk_size=chunk_size,
                             causal=causal)


def flash_prefill_lse_plain(q, k, v, *, window: int = 0, chunk_size: int = 0,
                            causal: bool = True):
    """The plain forward with the LSE (``ref.flash_prefill_lse``), counted."""
    PLAIN_CALLS["forward_lse"] += 1
    return ref.flash_prefill_lse(q, k, v, window=window,
                                 chunk_size=chunk_size, causal=causal)


def flash_backward_plain(q, k, v, o, lse, do, *, window: int = 0,
                         chunk_size: int = 0, causal: bool = True):
    """The plain backward (``ref.flash_backward``), counted."""
    PLAIN_CALLS["backward"] += 1
    return ref.flash_backward(q, k, v, o, lse, do, window=window,
                              chunk_size=chunk_size, causal=causal)


def kernel_path(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> str:
    """The kernel a CUDA call with these operand types launches:
    ``"tensor_core"`` for bf16 q, k and v, ``"cuda_core"`` otherwise."""
    if q_dtype == kv_dtype == torch.bfloat16:
        return "tensor_core"
    return "cuda_core"


def backward_path(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernels a CUDA call launches: ``"tensor_core"`` for
    bf16 operands (any head dim up to ``MAX_HEAD_DIM``, padded as the
    forward pads it), ``"cuda_core"`` for float32 ones."""
    if dtype == torch.bfloat16 and head_dim <= MAX_HEAD_DIM:
        return "tensor_core"
    return "cuda_core"


#: rows of a tensor-core tile: query rows, or keys a consumer warpgroup
TILE = 64


def dkdv_keys(head_dim: int) -> int:
    """Keys a dK / dV CTA of the tensor-core backward owns: two consumer
    warpgroups of ``TILE`` keys up to D 128, one at D 256 (whose CTAs own
    one half of the output columns each)."""
    return TILE * (1 if head_dim > 128 else 2)


def _q_tiles(k0: int, k_last: int, Sq: int, window: int, chunk_size: int,
             causal: bool) -> int:
    """Query tiles of ``TILE`` rows that reach some key in [k0, k_last]:
    the queries the kernel streams past that key block."""
    lo, hi = 0, Sq
    if causal:
        lo = k0
        if window > 0:
            hi = min(hi, k_last + window)
        if chunk_size > 0:
            hi = min(hi, (k_last // chunk_size + 1) * chunk_size)
    return -(-hi // TILE) - lo // TILE if hi > lo else 0


def dkdv_splits(B: int, Sq: int, Sk: int, KvH: int, G: int, head_dim: int,
                *, sms: int, window: int = 0, chunk_size: int = 0,
                causal: bool = True) -> int:
    """Slices of each KV head's G query heads in the dK / dV launch on a
    card of ``sms`` SMs: the fewest whose heaviest CTA (``ceil(G /
    splits)`` heads over the most query tiles any key block streams) is no
    longer than an SM's mean share of the whole launch's work, so the
    causal triangle's first blocks do not outlast the rest; G when no
    split is that short.  More slices mean more partial sums to write and
    add."""
    keys = dkdv_keys(head_dim)
    tiles = [_q_tiles(k0, min(k0 + keys, Sk) - 1, Sq, window, chunk_size,
                      causal) for k0 in range(0, Sk, keys)]
    if not tiles or not max(tiles):
        return 1
    halves = 2 if head_dim > 128 else 1
    total = sum(tiles) * G * KvH * B * halves
    for splits in range(1, G + 1):
        if -(-G // splits) * max(tiles) * sms <= total:
            return splits
    return G


def head_splits(G: int, splits: int) -> list[tuple[int, int]]:
    """The query heads [g0, g1) of each slice of a KV head's G, in the
    order the dK / dV partial sums are added (the kernel's formula)."""
    return [(s * G // splits, (s + 1) * G // splits) for s in range(splits)]


_SM_COUNT: dict[int, int] = {}


def _sms(dev: torch.device) -> int:
    """The card's SM count (cached by device index)."""
    idx = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


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


def _shapes(name: str, q: torch.Tensor, k: torch.Tensor):
    """(B, Sq, H, D, Sk, KvH) of the operands, checked."""
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"{name}: q must be [B, Sq, H, D] and k, v "
                         f"[B, Sk, KvH, D] (got {list(q.shape)}, "
                         f"{list(k.shape)})")
    B, Sq, H, D = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    if KvH == 0 or H % KvH or D > MAX_HEAD_DIM:
        raise ValueError(f"{name}: needs H % KvH == 0 and D <= "
                         f"{MAX_HEAD_DIM} (H={H}, KvH={KvH}, D={D})")
    return B, Sq, H, D, Sk, KvH


def _forward(q, k, v, window: int, chunk_size: int, causal: bool,
             with_lse: bool):
    """The forward kernel on CUDA tensors: (out, lse or None)."""
    global LAUNCHES
    dev = q.device
    B, Sq, H, D, Sk, KvH = _shapes("flash_prefill", q, k)
    _check("q", q, (B, Sq, H, D), _DTYPES, dev)
    _check("k", k, (B, Sk, KvH, D), _DTYPES, dev)
    _check("v", v, (B, Sk, KvH, D), (k.dtype,), dev)
    path = kernel_path(q.dtype, k.dtype)
    tc, cc = _launchers()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev) \
        if with_lse else None
    lse_ptr = lse.data_ptr() if with_lse else None
    if path == "tensor_core":
        d8 = -(-D // 8) * 8
        q, k, v = (_tc_operand(x, d8) for x in (q, k, v))
        out = torch.empty_like(q)
        err = tc(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse_ptr, B, Sq, Sk, H, KvH, d8, int(window),
                 int(chunk_size), int(causal), D ** -0.5, stream)
        if d8 != D:
            out = out[..., :D].contiguous()
    else:
        out = torch.empty_like(q)
        err = cc(int(q.dtype == torch.bfloat16),
                 int(k.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), lse_ptr, B, Sq, Sk, H, KvH, D,
                 int(window), int(chunk_size), int(causal), D ** -0.5,
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_prefill {path} kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_PATH[path] += 1
    LAUNCHES_BY_MASK["causal" if causal else
                     "full" if Sq == Sk else "full_cross"] += 1
    if with_lse:
        LAUNCHES_WITH_LSE[path] += 1
    return out, lse


def _device(name: str, q: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    return q.device.type == "cuda"


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0, chunk_size: int = 0, causal: bool = True
                  ) -> torch.Tensor:
    """q [B, Sq, H, D]; k, v [B, Sk, KvH, D] -> [B, Sq, H, D] in q's dtype.
    Query i attends key j < Sk iff (without ``causal``, always) j <= i, and
    i - j < window when ``window > 0``, and i // chunk_size ==
    j // chunk_size when ``chunk_size > 0``."""
    if not _device("flash_prefill", q):
        return flash_prefill_plain(q, k, v, window=window,
                                   chunk_size=chunk_size, causal=causal)
    return _forward(q, k, v, window, chunk_size, causal, False)[0]


def flash_prefill_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int = 0, chunk_size: int = 0,
                      causal: bool = True):
    """``flash_prefill`` and each row's natural log-sum-exp of its scaled
    scores: (o [B, Sq, H, D], lse [B, H, Sq] float32, -inf for a row that
    reaches no key)."""
    if not _device("flash_prefill", q):
        return flash_prefill_lse_plain(q, k, v, window=window,
                                       chunk_size=chunk_size, causal=causal)
    return _forward(q, k, v, window, chunk_size, causal, True)


def flash_backward(q, k, v, o, lse, do, *, window: int = 0,
                   chunk_size: int = 0, causal: bool = True):
    """Gradients (dq, dk, dv) of ``flash_prefill`` at (q, k, v), in their
    dtypes, from the forward's o and lse and the output's gradient do: on a
    CUDA tensor the backward kernels of ``backward_path``
    (``BACKWARD_LAUNCHES`` launches), on a CPU tensor
    ``flash_backward_plain``.  q, k, v, o and do are all
    float32 or all bf16."""
    if not _device("flash_backward", q):
        return flash_backward_plain(q, k, v, o, lse, do, window=window,
                                    chunk_size=chunk_size, causal=causal)
    dev = q.device
    B, Sq, H, D, Sk, KvH = _shapes("flash_backward", q, k)
    dt = (q.dtype,)
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_backward: operands must be float32 or bf16 "
                         f"(got {q.dtype})")
    do = do.contiguous()
    for name, x, shape in (("q", q, (B, Sq, H, D)), ("k", k, (B, Sk, KvH, D)),
                           ("v", v, (B, Sk, KvH, D)),
                           ("o", o, (B, Sq, H, D)), ("do", do, (B, Sq, H, D))):
        _check(name, x, shape, dt, dev)
    _check("lse", lse, (B, H, Sq), (torch.float32,), dev)
    path = backward_path(q.dtype, D)
    tc, cc = _backward_launchers()
    stream = torch.cuda.current_stream(dev).cuda_stream
    mask = (int(window), int(chunk_size), int(causal))
    if path == "tensor_core":
        # head dim padded to a multiple of 8, 16-byte aligned starts (the
        # models' tensors pass unchanged)
        d8 = -(-D // 8) * 8
        q, k, v, o, do = (_tc_operand(x, d8) for x in (q, k, v, o, do))
        splits = dkdv_splits(B, Sq, Sk, KvH, H // KvH, d8, window=window,
                             chunk_size=chunk_size, causal=causal,
                             sms=_sms(dev))
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
            torch.empty_like(v)
        part = torch.empty((2, splits, B, Sk, KvH, d8), dtype=torch.float32,
                           device=dev)
        rows = torch.empty((2, B, H, -(-Sq // TILE) * TILE),
                           dtype=torch.float32, device=dev)
        err = tc(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), part.data_ptr(), rows[0].data_ptr(),
                 rows[1].data_ptr(), B, Sq, Sk, H, KvH, d8, *mask,
                 D ** -0.5, splits, stream)
        if d8 != D:
            dq, dk, dv = (x[..., :D].contiguous() for x in (dq, dk, dv))
    else:
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
            torch.empty_like(v)
        di = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
        err = cc(int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), di.data_ptr(),
                 B, Sq, Sk, H, KvH, D, *mask, D ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_backward {path} kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES_BY_PATH["backward_" + path] += BACKWARD_LAUNCHES[path]
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward kernel with the LSE,
    saving (q, k, v, o, lse); the backward kernel.  ``plain`` runs both
    plain versions on a CUDA tensor too (parity checks only)."""

    @staticmethod
    def forward(ctx, q, k, v, window, chunk_size, causal, plain):
        kw = dict(window=window, chunk_size=chunk_size, causal=causal)
        fwd = flash_prefill_lse_plain if plain else flash_prefill_lse
        o, lse = fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw, ctx.plain = kw, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_backward_plain if ctx.plain else flash_backward
        dq, dk, dv = bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, window: int = 0, chunk_size: int = 0,
                    causal: bool = True, plain: bool = False):
    """``flash_prefill`` with a gradient (``FlashAttention``), for
    training; no fallback: a kernel that fails to build or launch raises."""
    return FlashAttention.apply(q, k, v, window, chunk_size, causal, plain)
