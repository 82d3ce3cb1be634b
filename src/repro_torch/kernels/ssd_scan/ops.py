"""Mamba2 SSD chunked scan: the Hopper kernels' wrapper and its plain
versions.

Port of ``src/repro/kernels/ssd_scan/ops.py`` (whose Pallas kernel is
``kernel.py::_ssd_kernel``).  ``ssd_scan`` runs the selective-SSM
recurrence over a whole prompt: on a CUDA tensor it launches a kernel
(built at first use) or raises; on a CPU tensor it runs ``ssd_scan_plain``
(``ref.py``, the sequential recurrence).  Unlike the reference wrapper it
broadcasts no group to the heads and pads nothing: the kernels read group
h // (H // G) and mask the ragged last chunk.

Two kernels, chosen by operand type alone (``kernel_path``):

* bf16 x, B and C (what the model passes): the tensor-core kernel
  (``csrc/ssd_scan_tc.cu``: chunks of 128 in parallel, C B^T once per
  (batch, group, chunk), the four products in bf16 ``wgmma`` with float32
  sums, a short pass carrying the float32 state across chunks);
  ``ref.ssd_scan_chunked`` is its arithmetic on the CPU;
* float32 or mixed operands: the CUDA-core kernel (``csrc/ssd_scan.cu``,
  float32 products, each block walking the chunks in turn), since a
  float32 caller asked for float32 products.

There is no fallback: if the chosen kernel fails to build or launch, the
wrapper raises.  ``LAUNCHES`` counts wrapper calls that launched a kernel
(the tensor-core path's three launches count once) and nothing else;
``LAUNCHES_BY_PATH`` splits them by kernel.

Training (``SSDScan``, a ``torch.autograd.Function``; ``ssd_scan_grad``):
on CUDA a call whose output needs a gradient (grad enabled and an input
that requires grad) goes through it, so ``ssd_scan`` never returns an
output that autograd would take for a constant.  Its forward is the same
kernel asked for the state entering each chunk too (a nullable output of
both kernels, so serving's launches write none to the caller;
``LAUNCHES_WITH_SPREV`` counts the launches that did), and its backward is
kernels of their own (``ssd_scan_backward``, ``BACKWARD_LAUNCHES``
launches a call, into ``LAUNCHES_BY_PATH["backward_" + path]``), chosen by
``backward_path``: bf16 operands with N <= 128 (the models' path) on the
tensor cores (``csrc/ssd_scan_tc_bwd.cu``: TMA and bf16 wgmma, float32
sums, four launches; its head-slice launch gives each CTA a run of
``backward_slices`` of a group's heads), anything else in float32
arithmetic on the CUDA cores (``csrc/ssd_scan_bwd.cu``, five launches).
Both sum each group's heads in a fixed order, without atomics: two calls
give the same bits.  On a CPU tensor
``ssd_scan_grad`` trains through the sequential plain scan's torch ops,
which ``plain=True`` runs on a CUDA tensor too (parity checks);
``PLAIN_CALLS`` counts those calls on any device.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.ops import _sms
from repro_torch.kernels.ssd_scan import ref

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NAME = "ssd_scan"
SOURCE = _CSRC / "ssd_scan.cu"
TC_NAME = "ssd_scan_tc"
TC_SOURCE = _CSRC / "ssd_scan_tc.cu"
BWD_NAME = "ssd_scan_bwd"
BWD_SOURCE = _CSRC / "ssd_scan_bwd.cu"
TC_BWD_NAME = "ssd_scan_tc_bwd"
TC_BWD_SOURCE = _CSRC / "ssd_scan_tc_bwd.cu"
_FNS = None
_DTYPES = (torch.float32, torch.bfloat16)
MAX_STATE = 256
#: the backward kernels' largest head dim P
MAX_HEAD_DIM_BWD = 64
#: the tensor-core backward's largest state size N
MAX_STATE_TC_BWD = 128
#: tokens a chunk of the saved states (both forward kernels' and the
#: backward's)
CHUNK = 128
#: bytes of scratch the tensor-core kernel and the backward need, by shape
_WORKSPACE: dict[tuple, int] = {}

#: wrapper calls that launched a kernel since import (or since a caller
#: reset it to 0)
LAUNCHES = 0
#: the backward kernels' launches a call, by ``backward_path``
BACKWARD_LAUNCHES = {"tensor_core": 4, "cuda_core": 5}
#: a head-slice CTA's fixed cost (the B and C tiles, B C^T, its partial sum
#: written), in heads (``backward_slices``)
SLICE_OVERHEAD_HEADS = 1
#: the same launches by kernel: ``kernel_path``'s names; and the backward
#: kernels' launches (``BACKWARD_LAUNCHES`` a call) by ``backward_path``
LAUNCHES_BY_PATH = {"tensor_core": 0, "cuda_core": 0,
                    "backward_tensor_core": 0, "backward_cuda_core": 0}
#: the forward launches that also wrote the state entering each chunk
#: (training), by kernel
LAUNCHES_WITH_SPREV = {"tensor_core": 0, "cuda_core": 0}
#: calls of the sequential plain scan (``ssd_scan_plain``), on any device
PLAIN_CALLS = {"scan": 0}


def _launchers():
    """(tensor-core entry point, its workspace size, CUDA-core entry point,
    the backwards' {path: (entry point, its workspace size)})."""
    global _FNS
    if _FNS is None:
        srcs = [(TC_NAME, TC_SOURCE), (NAME, SOURCE), (BWD_NAME, BWD_SOURCE),
                (TC_BWD_NAME, TC_BWD_SOURCE)]
        _build.build_many(srcs)
        tc_lib, cc_lib, bw_lib, tb_lib = (_build.build(*s) for s in srcs)
        tc, ws = tc_lib.ssd_scan_tc_launch, tc_lib.ssd_scan_tc_workspace_bytes
        cc = cc_lib.ssd_scan_launch
        bw, bws = bw_lib.ssd_scan_bwd_launch, \
            bw_lib.ssd_scan_bwd_workspace_bytes
        tb, tbs = tb_lib.ssd_scan_tc_bwd_launch, \
            tb_lib.ssd_scan_tc_bwd_workspace_bytes
        tc.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        cc.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        bw.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 12
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        tb.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        ws.argtypes = bws.argtypes = [ctypes.c_int] * 6
        tbs.argtypes = [ctypes.c_int] * 7
        tc.restype = cc.restype = bw.restype = tb.restype = ctypes.c_int
        ws.restype = bws.restype = tbs.restype = ctypes.c_longlong
        _FNS = (tc, ws, cc, {"cuda_core": (bw, bws),
                             "tensor_core": (tb, tbs)})
    return _FNS


def build() -> float:
    """Build (or load) the four kernel libraries; seconds the builds
    took."""
    _launchers()
    return max(_build.BUILD_SECONDS[n]
               for n in (TC_NAME, NAME, BWD_NAME, TC_BWD_NAME))


def ssd_scan_plain(x, a, B, C):
    """The sequential recurrence (``ref.ssd_scan``), counted in
    ``PLAIN_CALLS``; autograd differentiates its torch ops.  On meta
    tensors (shapes alone: the dry run's FLOP count) the chunked form
    ``ref.ssd_scan_chunked``, the kernel's arithmetic, whose loop runs a
    chunk a step where the recurrence's runs a token a step."""
    PLAIN_CALLS["scan"] += 1
    if x.device.type == "meta":
        return ref.ssd_scan_chunked(x, a, B, C)
    return ref.ssd_scan(x, a, B, C)


def kernel_path(x_dtype: torch.dtype, bc_dtype: torch.dtype) -> str:
    """The kernel a CUDA call with these operand types launches:
    ``"tensor_core"`` for bf16 x, B and C, ``"cuda_core"`` otherwise."""
    if x_dtype == bc_dtype == torch.bfloat16:
        return "tensor_core"
    return "cuda_core"


def _check(name: str, t: torch.Tensor, shape, dtypes, dev) -> None:
    if t.device != dev or t.dtype not in dtypes or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"ssd_scan: {name} must be a contiguous {list(shape)} tensor of "
            f"{[str(d) for d in dtypes]} on {dev} (got {list(t.shape)} "
            f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()})")


def backward_path(x_dtype: torch.dtype, bc_dtype: torch.dtype, P: int,
                  N: int) -> str:
    """The backward kernel a CUDA call launches: ``"tensor_core"``
    (``csrc/ssd_scan_tc_bwd.cu``) for bf16 x, B and C with N <=
    ``MAX_STATE_TC_BWD`` (the models' shapes), ``"cuda_core"``
    (``csrc/ssd_scan_bwd.cu``, float32 arithmetic) otherwise."""
    if x_dtype == bc_dtype == torch.bfloat16 and N <= MAX_STATE_TC_BWD:
        return "tensor_core"
    return "cuda_core"


@functools.lru_cache(maxsize=None)
def backward_slices(Bsz: int, L: int, H: int, G: int, *, sms: int) -> int:
    """Slices of each group's H // G heads in the tensor-core backward's
    head-slice launch on a card of ``sms`` SMs (``csrc/ssd_scan_tc_bwd.cu``,
    launch 3: a CTA a chunk and slice, its heads in turn): the fewest that
    minimise the launch's waves times a CTA's heads plus its fixed cost
    (``SLICE_OVERHEAD_HEADS``), so the CTAs fill the card without a
    second wave of short ones.  Between 1 and H // G; ``ref.slice_bounds``
    gives each slice's heads.  Cached: the wrapper asks on every call."""
    hpg = H // G
    ctas = Bsz * -(-L // CHUNK) * G
    best, best_cost = 1, None
    for s in range(1, hpg + 1):
        cost = -(-ctas * s // sms) * (-(-hpg // s) + SLICE_OVERHEAD_HEADS)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def tc_backward_slices(Bsz: int, L: int, H: int, G: int, dev) -> int:
    """``backward_slices`` on the card of ``dev``."""
    return backward_slices(Bsz, L, H, G, sms=_sms(torch.device(dev)))


def _tc_pad(t: torch.Tensor, *last: int) -> torch.Tensor:
    """``t`` as the tensor-core backward takes it: its last ``len(last)``
    dims zero-padded to ``last`` (P and N to multiples of 8: TMA's 16-byte
    rows) and a 16-byte aligned start.  Both hold for the models' tensors,
    which pass unchanged; the zeros add nothing to any sum."""
    if tuple(t.shape[-len(last):]) != last:
        pad = []
        for size, want in zip(reversed(t.shape[-len(last):]), reversed(last)):
            pad += [0, want - size]
        t = F.pad(t, pad)
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _workspace(key: tuple, size_fn, dev) -> torch.Tensor:
    n = _WORKSPACE.get(key)
    if n is None:
        n = _WORKSPACE[key] = size_fn(*key[1:])
    return torch.empty(n, dtype=torch.uint8, device=dev)


def needs_grad(*ts) -> bool:
    """Whether autograd needs the gradient of an output computed from
    ``ts``: grad enabled and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _shapes(x, a, B, C) -> tuple:
    if x.ndim != 4 or a.ndim != 3 or B.ndim != 4:
        raise ValueError(f"ssd_scan: x must be [Bsz, L, H, P], a [Bsz, L, H] "
                         f"and B, C [Bsz, L, G, N] (got {list(x.shape)}, "
                         f"{list(a.shape)}, {list(B.shape)})")
    Bsz, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if G == 0 or H % G or N > MAX_STATE or N % 4:
        raise ValueError(f"ssd_scan: needs H % G == 0, N <= {MAX_STATE} and "
                         f"N % 4 == 0 (H={H}, G={G}, N={N})")
    dev = x.device
    _check("x", x, (Bsz, L, H, P), _DTYPES, dev)
    _check("a", a, (Bsz, L, H), (torch.float32,), dev)
    _check("B", B, (Bsz, L, G, N), _DTYPES, dev)
    _check("C", C, (Bsz, L, G, N), (B.dtype,), dev)
    return Bsz, L, H, P, G, N


def _kernel_forward(x, a, B, C, keep_sprev: bool = False):
    """One forward launch on CUDA tensors: (y, final state, the state
    entering each chunk [Bsz, nc, H, P, N] when ``keep_sprev``, else
    None; bf16 from the tensor-core kernel, float32 from the CUDA-core
    one, chunk 0's left unwritten)."""
    global LAUNCHES
    Bsz, L, H, P, G, N = _shapes(x, a, B, C)
    dev = x.device
    path = kernel_path(x.dtype, B.dtype)
    tc, ws, cc, _ = _launchers()
    stream = torch.cuda.current_stream(dev).cuda_stream
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    sprev = None
    if keep_sprev:
        sprev = torch.empty(
            (Bsz, -(-L // CHUNK), H, P, N), device=dev,
            dtype=torch.bfloat16 if path == "tensor_core" else torch.float32)
    sp_ptr = sprev.data_ptr() if sprev is not None else None
    if path == "tensor_core":
        work = _workspace((TC_NAME, Bsz, L, H, P, G, N), ws, dev)
        err = tc(x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
                 y.data_ptr(), state.data_ptr(), work.data_ptr(), sp_ptr,
                 Bsz, L, H, P, G, N, stream)
    else:
        err = cc(int(x.dtype == torch.bfloat16),
                 int(B.dtype == torch.bfloat16), x.data_ptr(), a.data_ptr(),
                 B.data_ptr(), C.data_ptr(), y.data_ptr(), state.data_ptr(),
                 sp_ptr, Bsz, L, H, P, G, N, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan {path} kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_PATH[path] += 1
    if keep_sprev:
        LAUNCHES_WITH_SPREV[path] += 1
    return y, state, sprev


def ssd_scan_backward(x, a, B, C, s_prev, dy, d_state):
    """Gradients (dx, da, dB, dC) of ``ssd_scan`` at (x, a, B, C), each in
    its input's dtype, from the cotangents dy [Bsz, L, H, P] (x's dtype)
    and d_state [Bsz, H, P, N] float32 (either may be None: zero) and the
    forward's ``s_prev`` (``_kernel_forward(..., keep_sprev=True)``): on a
    CUDA tensor the backward kernel (``BACKWARD_LAUNCHES`` launches), on a
    CPU tensor its plain version ``ref.ssd_scan_chunked_backward`` (which
    recomputes the states and ignores ``s_prev``)."""
    if x.device.type == "cpu":
        return ref.ssd_scan_chunked_backward(x, a, B, C, dy, d_state)
    Bsz, L, H, P, G, N = _shapes(x, a, B, C)
    dev = x.device
    if P > MAX_HEAD_DIM_BWD:
        raise ValueError(f"ssd_scan backward: head dim P={P} > "
                         f"{MAX_HEAD_DIM_BWD}")
    if dy is None:
        dy = torch.zeros_like(x)
    dy = dy.contiguous()
    _check("dy", dy, (Bsz, L, H, P), (x.dtype,), dev)
    if d_state is not None:
        d_state = d_state.contiguous()
        _check("d_state", d_state, (Bsz, H, P, N), (torch.float32,), dev)
    nc = -(-L // CHUNK)
    sp_bf16 = s_prev.dtype == torch.bfloat16
    _check("s_prev", s_prev, (Bsz, nc, H, P, N),
           (torch.bfloat16 if kernel_path(x.dtype, B.dtype) == "tensor_core"
            else torch.float32,), dev)
    path = backward_path(x.dtype, B.dtype, P, N)
    fn, size = _launchers()[3][path]
    if L == 0:
        return tuple(torch.empty_like(t) for t in (x, a, B, C))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if path == "tensor_core":
        slices = tc_backward_slices(Bsz, L, H, G, dev)
        P8, N8 = -(-P // 8) * 8, -(-N // 8) * 8
        x8, dy8 = (_tc_pad(t, P8) for t in (x, dy))
        B8, C8 = (_tc_pad(t, N8) for t in (B, C))
        sp8 = _tc_pad(s_prev, P8, N8)
        ds8 = None if d_state is None else _tc_pad(d_state, P8, N8)
        dx, dB, dC = (torch.empty_like(t) for t in (x8, B8, C8))
        da = torch.empty_like(a)
        work = _workspace(("backward_" + path, Bsz, L, H, P8, G, N8, slices),
                          size, dev)
        err = fn(x8.data_ptr(), a.data_ptr(), B8.data_ptr(), C8.data_ptr(),
                 dy8.data_ptr(), ds8.data_ptr() if ds8 is not None else None,
                 sp8.data_ptr(), dx.data_ptr(), da.data_ptr(), dB.data_ptr(),
                 dC.data_ptr(), work.data_ptr(), Bsz, L, H, P8, G, N8, slices,
                 stream)
        if P8 != P:
            dx = dx[..., :P].contiguous()
        if N8 != N:
            dB, dC = dB[..., :N].contiguous(), dC[..., :N].contiguous()
    else:
        dx, da, dB, dC = (torch.empty_like(t) for t in (x, a, B, C))
        work = _workspace(("backward_" + path, Bsz, L, H, P, G, N), size, dev)
        err = fn(int(x.dtype == torch.bfloat16),
                 int(B.dtype == torch.bfloat16), int(sp_bf16), x.data_ptr(),
                 a.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
                 d_state.data_ptr() if d_state is not None else None,
                 s_prev.data_ptr(), dx.data_ptr(), da.data_ptr(),
                 dB.data_ptr(), dC.data_ptr(), work.data_ptr(), Bsz, L, H, P,
                 G, N, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan backward {path} kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES_BY_PATH["backward_" + path] += BACKWARD_LAUNCHES[path]
    return dx, da, dB, dC


class SSDScan(torch.autograd.Function):
    """The SSD scan with a gradient: ``fwd(x, a, B, C)`` -> (y, final
    state, saved tensor or None) and ``bwd(x, a, B, C, saved, dy,
    d_state)`` -> (dx, da, dB, dC), with dy or d_state None where that
    output has no gradient.  On the card they are the kernels
    (``ssd_scan_grad``); a CPU test passes the chunked mirrors."""

    @staticmethod
    def forward(ctx, x, a, B, C, fwd, bwd):
        ctx.set_materialize_grads(False)
        y, state, saved = fwd(x, a, B, C)
        ctx.save_for_backward(x, a, B, C, saved)
        ctx.bwd = bwd
        return y, state

    @staticmethod
    def backward(ctx, dy, d_state):
        x, a, B, C, saved = ctx.saved_tensors
        if dy is None and d_state is None:
            return None, None, None, None, None, None
        dx, da, dB, dC = ctx.bwd(x, a, B, C, saved, dy, d_state)
        return dx, da, dB, dC, None, None


def ssd_scan_grad(x, a, B, C, *, plain: bool = False):
    """``ssd_scan`` with a gradient, for training: on a CUDA tensor
    ``SSDScan`` over the forward kernel and the backward kernel (no
    fallback: a kernel that fails to build or launch raises); on a CPU
    tensor, or with ``plain``, the sequential plain scan, through whose
    torch ops autograd runs."""
    if plain or x.device.type == "cpu":
        return ssd_scan_plain(x, a, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if x.shape[-1] > MAX_HEAD_DIM_BWD:
        raise ValueError(f"ssd_scan backward: head dim P={x.shape[-1]} > "
                         f"{MAX_HEAD_DIM_BWD}")
    return SSDScan.apply(x, a, B, C,
                         functools.partial(_kernel_forward, keep_sprev=True),
                         ssd_scan_backward)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [Bsz, L, H, P]; a [Bsz, L, H] float32; B, C [Bsz, L, G, N] ->
    (y [Bsz, L, H, P] in x's dtype, final state [Bsz, H, P, N] float32).
    x, B and C are float32 or bf16 (B and C of one type).  On CUDA a call
    whose output needs a gradient goes through ``SSDScan``."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, a, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if needs_grad(x, a, B, C):
        return ssd_scan_grad(x, a, B, C)
    y, state, _ = _kernel_forward(x, a, B, C)
    return y, state
