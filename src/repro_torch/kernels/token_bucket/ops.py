"""Token-bucket shaper step: the Hopper kernel's wrapper and its plain
PyTorch version.

Port of ``src/repro/kernels/token_bucket/ops.py`` (whose Pallas kernel is
``kernel.py::_tb_kernel``).  ``token_bucket_step`` advances every flow's
bucket by ``elapsed`` cycles and, where ``want`` is given, admits the
flows that want to send and can pay ``cost`` (bytes in GBPS mode, one
message in IOPS mode).  On a CUDA tensor it launches
``csrc/token_bucket.cu`` (built at first use) or raises; on a CPU tensor it
runs ``token_bucket_step_plain``, which repeats the kernel's arithmetic.
``LAUNCHES`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.core.token_bucket import TBState, wrap_i32
from repro_torch.kernels import _build

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "token_bucket.cu"
_FN = None

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.build("token_bucket", _SRC).tb_step_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def build() -> float:
    """Build (or load) the kernel library; seconds the build took."""
    _launcher()
    return _build.BUILD_SECONDS["token_bucket"]


def _elapsed_tensor(elapsed, like: torch.Tensor) -> torch.Tensor:
    if isinstance(elapsed, torch.Tensor):
        return elapsed.to(torch.int32)
    return torch.full((1,), int(elapsed), dtype=torch.int32,
                      device=like.device)


def token_bucket_step_plain(state: TBState, elapsed, cost=None, want=None
                            ) -> tuple[TBState, torch.Tensor | None]:
    """The kernel's function in plain PyTorch ops (any device): the same
    floor division and modulo, and int32 wraparound via int64."""
    e = _elapsed_tensor(elapsed, state.tokens)
    interval = torch.clamp(state.interval, min=1)
    total = wrap_i32(state.cyc.long() + e)
    k = torch.div(total, interval, rounding_mode="floor")
    cyc = torch.remainder(total, interval)
    k = torch.minimum(k, torch.div(state.bkt_size,
                                   torch.clamp(state.refill_rate, min=1),
                                   rounding_mode="floor") + 1)
    tok = wrap_i32(state.tokens.long() + k.long() * state.refill_rate)
    tok = torch.minimum(tok, state.bkt_size)
    admit = None
    if want is not None:
        c = torch.where(state.mode == 0, cost, 1)
        admit = want & (tok >= c)
        tok = torch.where(admit, wrap_i32(tok.long() - c), tok)
    return state._replace(tokens=tok, cyc=cyc), admit


def _check(name: str, x: torch.Tensor, n: int, dtype, dev) -> None:
    if x.device != dev or x.dtype != dtype or not x.is_contiguous() \
            or x.shape != (n,):
        raise ValueError(
            f"token_bucket_step: {name} must be a contiguous [{n}] {dtype} "
            f"tensor on {dev} (got {tuple(x.shape)} {x.dtype} on {x.device},"
            f" contiguous={x.is_contiguous()})")


def token_bucket_step(state: TBState, elapsed, cost=None, want=None, *,
                      out: tuple[torch.Tensor, torch.Tensor] | None = None
                      ) -> tuple[TBState, torch.Tensor | None]:
    """Refill every bucket by ``elapsed`` cycles (an int, a [1] tensor
    broadcast to all flows, or a per-flow [N] int32 tensor) and, when
    ``want`` ([N] bool) is given, admit and charge ``cost`` ([N] int32).

    Returns the new state (registers shared with ``state``) and the [N]
    bool admissions (``None`` without ``want``).  ``out=(tokens, cyc)``
    names the output buffers; they may be the input buffers (in place)."""
    tokens = state.tokens
    if tokens.device.type == "cpu":
        new, admit = token_bucket_step_plain(state, elapsed, cost, want)
        if out is not None:
            out[0].copy_(new.tokens)
            out[1].copy_(new.cyc)
            new = new._replace(tokens=out[0], cyc=out[1])
        return new, admit
    if tokens.device.type != "cuda":
        raise ValueError(f"token_bucket_step: unsupported device "
                         f"{tokens.device}")
    global LAUNCHES
    dev, n = tokens.device, tokens.shape[0]
    for name in TBState._fields:
        _check(name, getattr(state, name), n, torch.int32, dev)
    e = _elapsed_tensor(elapsed, tokens)
    if e.device != dev or e.dtype != torch.int32 or e.ndim != 1 \
            or e.shape[0] not in (1, n) or not e.is_contiguous():
        raise ValueError("token_bucket_step: elapsed must be a contiguous "
                         f"[1] or [{n}] int32 tensor on {dev}")
    if (want is None) != (cost is None):
        raise ValueError("token_bucket_step: pass cost and want together")
    if want is not None:
        _check("cost", cost, n, torch.int32, dev)
        _check("want", want, n, torch.bool, dev)
    tok_out, cyc_out = out if out is not None else (torch.empty_like(tokens),
                                                    torch.empty_like(tokens))
    _check("out tokens", tok_out, n, torch.int32, dev)
    _check("out cyc", cyc_out, n, torch.int32, dev)
    admit = torch.empty_like(tokens, dtype=torch.bool) \
        if want is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    err = _launcher()(
        n, ptr(tokens), ptr(state.cyc), ptr(state.refill_rate),
        ptr(state.bkt_size), ptr(state.interval), ptr(state.mode), ptr(e),
        0 if e.shape[0] == 1 else 1, ptr(cost), ptr(want), ptr(tok_out),
        ptr(cyc_out), ptr(admit), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"token_bucket kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return state._replace(tokens=tok_out, cyc=cyc_out), admit
