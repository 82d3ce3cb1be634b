"""Heterogeneous accelerator models (Arcus §2.2 "non-linearity").

Each accelerator has (1) a non-linear compute-throughput vs. input-message-
size curve (Fig. 7(a): logarithmic / exponential / ad-hoc) and (2) an
egress/ingress bandwidth ratio R = Eb/Ib in {=1, >1, <1, fixed-egress}
(AES, decompression, compression, SHA-3-512 respectively).

The simulator consumes these as pure arrays: for the dataplane we
pre-tabulate service time and egress size as functions of message size on a
log2 grid and interpolate inside the tick.  Port of
``src/repro/core/accelerator.py``: the specs, catalogue and tables are the
reference's numpy code, copied; the interpolation is float32 torch, bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

CURVE_LINEAR = "linear"
CURVE_LOG = "log"
CURVE_EXP = "exp"
CURVE_ADHOC = "adhoc"

R_EQUAL = "equal"        # R = 1        (e.g. AES-256-CTR)
R_EXPAND = "expand"      # R > 1        (decompression)
R_SHRINK = "shrink"      # R < 1        (compression)
R_FIXED = "fixed"        # Eb fixed     (SHA-3-512: 64B digest)


@dataclasses.dataclass(frozen=True)
class AcceleratorSpec:
    name: str
    peak_gbps: float               # max compute throughput at ideal msg size
    curve: str = CURVE_EXP
    curve_ref_bytes: float = 1024.0  # knee of the curve
    r_kind: str = R_EQUAL
    r_value: float = 1.0           # egress = r_value * ingress (expand/shrink)
    fixed_egress_bytes: int = 64   # for R_FIXED
    overhead_ns: float = 120.0     # fixed per-message pipeline overhead
    parallelism: int = 1           # independent lanes
    # optional explicit service-time anchors ((bytes, us), ...): overrides
    # the curve; log-space interpolated.  Used for devices whose cost is
    # operation- rather than bandwidth-dominated (e.g. SSD reads vs writes).
    service_us_at: tuple = ()
    # per-resource demand overrides: ((resource_name, per_ingress_byte,
    # per_egress_byte), ...).  Axes without an override charge 1.0 per byte
    # in each direction — combined with the device's egress curve that
    # already makes R_EXPAND devices egress/memory-heavy (2.5 egress bytes
    # per ingress byte on 'decompress') and fixed-egress SHA-style devices
    # ingress-heavy (64B digests).  Explicit overrides model devices whose
    # shared-resource footprint is decoupled from their message bytes
    # (e.g. a compute-bound systolic engine barely touching memory bw).
    res_demand: tuple = ()

    # ------------------------------------------------------------------
    def resource_demand(self, resource_name: str) -> tuple[float, float]:
        """(per-ingress-byte, per-egress-byte) demand coefficients of this
        device on the named resource axis (see ``res_demand``)."""
        for nm, ic, ec in self.res_demand:
            if nm == resource_name:
                return float(ic), float(ec)
        return 1.0, 1.0

    # ------------------------------------------------------------------
    def throughput_gbps(self, msg_bytes: np.ndarray) -> np.ndarray:
        """Compute throughput sustained when fed messages of this size."""
        m = np.asarray(msg_bytes, np.float64)
        ref = self.curve_ref_bytes
        if self.curve == CURVE_LINEAR:
            f = np.ones_like(m)
        elif self.curve == CURVE_LOG:
            # saturates slowly; small messages very inefficient
            f = np.log2(1.0 + m / ref) / np.log2(1.0 + 65536.0 / ref)
            f = np.minimum(f, 1.0)
        elif self.curve == CURVE_EXP:
            f = 1.0 - np.exp(-m / ref)
        elif self.curve == CURVE_ADHOC:
            # uniquely ad-hoc (Fig. 7a): efficiency dips when messages are
            # not multiples of the internal block (e.g. 4KB) + slow ramp.
            base = 1.0 - np.exp(-m / ref)
            block = 4096.0
            frag = np.where(m >= block, (m % block) / block, 0.0)
            f = base * (1.0 - 0.35 * frag)
        else:
            raise ValueError(self.curve)
        return self.peak_gbps * np.maximum(f, 1e-3)

    def service_time_s(self, msg_bytes: np.ndarray) -> np.ndarray:
        """Time one lane takes to process a message of the given size."""
        m = np.asarray(msg_bytes, np.float64)
        if self.service_us_at:
            xs = np.log2([b for b, _ in self.service_us_at])
            ys = np.log2([u * 1e-6 for _, u in self.service_us_at])
            return np.exp2(np.interp(np.log2(np.maximum(m, 1.0)), xs, ys))
        bps = self.throughput_gbps(m) * 1e9 / 8.0
        return m / bps + self.overhead_ns * 1e-9

    def effective_gbps(self, msg_bytes) -> float:
        """Sustained single-lane throughput incl. per-message overhead."""
        m = float(np.asarray(msg_bytes, np.float64))
        return m * 8 / float(self.service_time_s(m)) / 1e9 * self.parallelism

    def egress_bytes(self, msg_bytes: np.ndarray) -> np.ndarray:
        m = np.asarray(msg_bytes, np.float64)
        if self.r_kind == R_FIXED:
            return np.full_like(m, float(self.fixed_egress_bytes))
        return m * self.r_value


# ---------------------------------------------------------------------------
# Catalogue used across the paper's experiments
# ---------------------------------------------------------------------------

CATALOG = {
    # The 32 Gbps IPSec accelerator of Sec 3.1 (full load at MTU-size msgs;
    # tiny messages collapse throughput, Fig. 3b).
    "ipsec32": AcceleratorSpec("ipsec32", peak_gbps=32.0, curve=CURVE_EXP,
                               curve_ref_bytes=200.0, r_kind=R_EQUAL,
                               overhead_ns=10.0),
    # Synthetic 50 Gbps accelerator of CaseP studies (linear, no interface
    # effects — isolates communication contention).
    "synthetic50": AcceleratorSpec("synthetic50", peak_gbps=50.0,
                                   curve=CURVE_LINEAR, r_kind=R_EQUAL,
                                   overhead_ns=40.0),
    "aes256": AcceleratorSpec("aes256", peak_gbps=40.0, curve=CURVE_EXP,
                              curve_ref_bytes=512.0, r_kind=R_EQUAL),
    "sha3_512": AcceleratorSpec("sha3_512", peak_gbps=24.0, curve=CURVE_LOG,
                                curve_ref_bytes=2048.0, r_kind=R_FIXED,
                                fixed_egress_bytes=64),
    "compress": AcceleratorSpec("compress", peak_gbps=20.0, curve=CURVE_ADHOC,
                                curve_ref_bytes=4096.0, r_kind=R_SHRINK,
                                r_value=0.4),
    "decompress": AcceleratorSpec("decompress", peak_gbps=20.0,
                                  curve=CURVE_ADHOC, curve_ref_bytes=4096.0,
                                  r_kind=R_EXPAND, r_value=2.5),
    # pipelined packet-rate crypto engines (SmartNIC datapath: good at
    # small messages, unlike the bulk-oriented log/exp engines above)
    "sha1_hmac": AcceleratorSpec("sha1_hmac", peak_gbps=28.0, curve=CURVE_EXP,
                                 curve_ref_bytes=48.0, r_kind=R_FIXED,
                                 fixed_egress_bytes=20, overhead_ns=100.0,
                                 parallelism=2),
    "aes128_cbc": AcceleratorSpec("aes128_cbc", peak_gbps=36.0, curve=CURVE_EXP,
                                  curve_ref_bytes=48.0, r_kind=R_EQUAL,
                                  overhead_ns=100.0, parallelism=2),
    # NVMe-backed storage engine for the FIO / storage experiments: service
    # time dominated by ~100us flash access, hidden by deep queue
    # parallelism (RAID-0 x4 x QD16).
    "nvme_raid0": AcceleratorSpec("nvme_raid0", peak_gbps=26.0,
                                  curve=CURVE_LINEAR, r_kind=R_EQUAL,
                                  overhead_ns=100_000.0, parallelism=64),
    # Checksum accelerator for the RocksDB offload experiment.
    "crc32c": AcceleratorSpec("crc32c", peak_gbps=48.0, curve=CURVE_EXP,
                              curve_ref_bytes=256.0, r_kind=R_FIXED,
                              fixed_egress_bytes=4),
}


# ---------------------------------------------------------------------------
# Tabulation for the jitted dataplane
# ---------------------------------------------------------------------------

#: log2-spaced grid of message sizes used for in-scan interpolation
GRID_LOG2_MIN, GRID_LOG2_MAX, GRID_N = 5, 20, 31  # 32B ... 1MB


def size_grid() -> np.ndarray:
    return np.logspace(GRID_LOG2_MIN, GRID_LOG2_MAX, GRID_N, base=2.0)


@dataclasses.dataclass
class AccelTable:
    """Pre-tabulated per-accelerator service curves for A accelerators."""

    n: int
    service_cycles: np.ndarray   # [A, GRID_N] float32 — service time in cycles
    egress_bytes: np.ndarray     # [A, GRID_N] float32
    parallelism: np.ndarray      # [A] int32
    names: Sequence[str] = dataclasses.field(default_factory=list)
    # host-side source specs (resource-demand derivation); hand-built or
    # padded tables may carry fewer specs than rows — spec_of() guards.
    specs: Sequence[AcceleratorSpec] = dataclasses.field(default_factory=list)

    def spec_of(self, accel_id: int) -> AcceleratorSpec | None:
        return (self.specs[accel_id]
                if 0 <= accel_id < len(self.specs) else None)

    @staticmethod
    def build(specs: Sequence[AcceleratorSpec], clock_hz: float = 250e6
              ) -> "AccelTable":
        grid = size_grid()
        sc = np.stack([s.service_time_s(grid) * clock_hz for s in specs])
        eg = np.stack([s.egress_bytes(grid) for s in specs])
        return AccelTable(
            n=len(specs),
            service_cycles=sc.astype(np.float32),
            egress_bytes=eg.astype(np.float32),
            parallelism=np.array([s.parallelism for s in specs], np.int32),
            names=[s.name for s in specs],
            specs=list(specs),
        )



# ---------------------------------------------------------------------------
# Bitwise float32 grid interpolation
# ---------------------------------------------------------------------------
#
# The service and egress tables feed integer cycle counts, so the port
# reproduces the reference's float32 bits, not just its values.  Neither
# ``torch.log`` nor ``torch.log2`` does: XLA on the CPU expands ``log`` into
# the Cephes-style polynomial below and LLVM contracts some of its
# multiply-adds into fused ones (read from the compiled x86 code).  Every
# fused multiply-add is emulated exactly: the float32 product is exact in
# float64, and the float64 sum rounded once to float32 agrees with the fused
# result on every input this grid sees (held over all integers 1..2^20 by
# tests/test_torch_accelerator.py).  Basic IEEE ops round the same way on
# the CPU and the GPU, so the CPU result is the CUDA result.

_F32 = np.float32
_LOG_P = [float(_F32(v)) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]
_LOG_Q1 = float(_F32(-2.12194440e-4))
_LOG_Q2 = float(_F32(0.693359375))
_SQRTHF = float(_F32(0.707106781186547524))
_MIN_NORM = float(np.finfo(np.float32).tiny)
_INV_LN2 = float(_F32(1.0 / np.log(2.0)))       # XLA's log2 = log * this
_CLIP_HI = float(_F32(GRID_N - 1.001))


def fma32(a, b, c):
    """Fused float32 multiply-add ``a * b + c`` with one rounding.

    The float32 product is exact in float64.  The float64 sum is rounded to
    odd (an inexact sum with an even last bit steps one ulp towards its
    exact error, found by TwoSum); rounding that to float32 is then the
    correctly rounded result, since float64 carries more than 24 + 2 bits
    (Boldo & Melquiond).  A plain float64 sum would round twice."""
    t = lambda x: x.double() if isinstance(x, torch.Tensor) else x  # noqa: E731
    p, c = t(a) * t(b), t(c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.float()


def xla_log(m):
    """Natural log of a float32 tensor, bitwise as XLA's CPU ``log``."""
    m = torch.clamp(m, min=_MIN_NORM)
    bits = m.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    x = ((bits & -2139095041) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    lt = x < _SQRTHF
    x = (x - 1.0) + torch.where(lt, x, torch.zeros_like(x))
    e = e - lt.float()
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = fma32(fma32(p[0], x, p[1]), x, p[2])
    y1 = fma32(fma32(p[3], x, p[4]), x, p[5])
    y2 = fma32(fma32(p[6], x, p[7]), x, p[8])
    y = fma32(y, x3, y1)
    y = fma32(y, x3, y2)
    y = fma32(y, x3, e * _LOG_Q1)
    r = fma32(-0.5, x2, x) + y
    return fma32(e, _LOG_Q2, r)


def log2(m):
    """``jnp.log2`` of a float32 tensor, bitwise (an unfused multiply)."""
    return xla_log(m) * _INV_LN2


def grid_position(msg_bytes):
    """(i0, frac) of message sizes on the log2 size grid, bitwise as the
    reference's compiled engine computes them.

    Under ``jit`` XLA folds ``(log2 - 5) / 15 * 30`` into
    ``fma(log, 1/ln2, -5) * 2``; that compiled form, not the op-by-op one,
    is what the engine's service and egress stages see."""
    m = torch.clamp(msg_bytes.to(torch.float32), min=1.0)
    x = fma32(xla_log(m), _INV_LN2, -5.0) * 2.0
    x = torch.clamp(x, 0.0, _CLIP_HI)
    i0 = x.to(torch.int32)
    return i0, x - i0.to(torch.float32)


#: sizes past this all clip to the grid's last interval (log2 > 20)
GRID_TAB_MAX = 2**20 + 1
_GRID_TABS: dict = {}


def grid_position_table(device) -> tuple[torch.Tensor, torch.Tensor]:
    """``grid_position`` of every integer size 0..GRID_TAB_MAX on
    ``device`` (built once per device).  Message sizes are integers, so
    ``tab[clamp(size, 0, GRID_TAB_MAX)]`` is ``grid_position(size)`` bit
    for bit: the same elementwise function, tabulated, with every larger
    size clipped to the last grid interval exactly as GRID_TAB_MAX is."""
    key = str(torch.device(device))
    if key not in _GRID_TABS:
        m = torch.arange(GRID_TAB_MAX + 1, dtype=torch.float32, device=device)
        i0, frac = grid_position(m)
        _GRID_TABS[key] = (i0.long(), frac)
    return _GRID_TABS[key]


def grid_blend(table, accel_id, i0, frac):
    """Blend the two grid points around ``i0`` (the compiled form fuses the
    second product into the add)."""
    row = table[accel_id]
    i0 = i0.long()
    if row.ndim > 1:
        v0 = torch.gather(row, -1, i0[..., None])[..., 0]
        v1 = torch.gather(row, -1, (i0 + 1)[..., None])[..., 0]
    else:
        v0, v1 = row.gather(0, i0), row.gather(0, i0 + 1)
    return fma32(v1, frac, v0 * (1.0 - frac))


def interp_grid(table, accel_id, msg_bytes):
    """Interpolate a [A, GRID_N] table at (accel_id, msg_bytes), bitwise as
    ``jax.jit(repro.core.accelerator.interp_grid)``.  ``accel_id`` is an int
    or a tensor broadcasting against ``msg_bytes``."""
    return grid_blend(table, accel_id, *grid_position(msg_bytes))
