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
``LAUNCHES_BY_PATH`` splits them by kernel.  Neither kernel has a
backward yet: on CUDA the wrapper refuses a call whose output would need a
gradient (grad enabled and an input that requires grad) with a
``RuntimeError``, rather than return an output that autograd would treat
as a constant.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan as ssd_scan_plain

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NAME = "ssd_scan"
SOURCE = _CSRC / "ssd_scan.cu"
TC_NAME = "ssd_scan_tc"
TC_SOURCE = _CSRC / "ssd_scan_tc.cu"
_FNS = None
_DTYPES = (torch.float32, torch.bfloat16)
MAX_STATE = 256
#: bytes of scratch the tensor-core kernel needs, by shape
_WORKSPACE: dict[tuple, int] = {}

#: wrapper calls that launched a kernel since import (or since a caller
#: reset it to 0)
LAUNCHES = 0
#: the same launches by kernel: ``kernel_path``'s names
LAUNCHES_BY_PATH = {"tensor_core": 0, "cuda_core": 0}


def _launchers():
    """(tensor-core entry point, its workspace size, CUDA-core entry
    point)."""
    global _FNS
    if _FNS is None:
        _build.build_many([(TC_NAME, TC_SOURCE), (NAME, SOURCE)])
        tc_lib, cc_lib = _build.build(TC_NAME, TC_SOURCE), \
            _build.build(NAME, SOURCE)
        tc, ws = tc_lib.ssd_scan_tc_launch, tc_lib.ssd_scan_tc_workspace_bytes
        cc = cc_lib.ssd_scan_launch
        tc.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        ws.argtypes = [ctypes.c_int] * 6
        cc.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        tc.restype = cc.restype = ctypes.c_int
        ws.restype = ctypes.c_longlong
        _FNS = (tc, ws, cc)
    return _FNS


def build() -> float:
    """Build (or load) both kernel libraries; seconds the builds took."""
    _launchers()
    return max(_build.BUILD_SECONDS[TC_NAME], _build.BUILD_SECONDS[NAME])


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


def ssd_scan(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [Bsz, L, H, P]; a [Bsz, L, H] float32; B, C [Bsz, L, G, N] ->
    (y [Bsz, L, H, P] in x's dtype, final state [Bsz, H, P, N] float32).
    x, B and C are float32 or bf16 (B and C of one type)."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, a, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, a, B, C)):
        # the kernel's output has no gradient: autograd would take it for a
        # constant and drop every gradient into x, a, B and C
        raise RuntimeError(
            "ssd_scan: the SSD-scan kernel has no backward yet, so it cannot "
            "run in a graph that needs gradients (training an ssd layer on "
            "CUDA); run under torch.no_grad() or train on the CPU")
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
    path = kernel_path(x.dtype, B.dtype)
    tc, ws, cc = _launchers()
    stream = torch.cuda.current_stream(dev).cuda_stream
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    if path == "tensor_core":
        shape = (Bsz, L, H, P, G, N)
        n_work = _WORKSPACE.get(shape)
        if n_work is None:
            n_work = _WORKSPACE[shape] = ws(*shape)
        work = torch.empty(n_work, dtype=torch.uint8, device=dev)
        err = tc(x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
                 y.data_ptr(), state.data_ptr(), work.data_ptr(), Bsz, L, H,
                 P, G, N, stream)
    else:
        err = cc(int(x.dtype == torch.bfloat16),
                 int(B.dtype == torch.bfloat16), x.data_ptr(), a.data_ptr(),
                 B.data_ptr(), C.data_ptr(), y.data_ptr(), state.data_ptr(),
                 Bsz, L, H, P, G, N, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan {path} kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_PATH[path] += 1
    return y, state
