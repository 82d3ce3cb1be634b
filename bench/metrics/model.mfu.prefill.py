"""The prefill call's share of the card's peak: model FLOPs of the window's
prefills (``bench/arith.py``) over their wall time times the H100 SXM's
dense bf16 peak, in percent: the whole of the call that the flash-prefill
kernel's roofline is a part of."""
from bench import arith


def read(run):
    p = run.window(run.log.prefills)
    seconds = sum(c.t1 - c.t0 for c in p)
    if not p or seconds <= 0:
        return None
    flops = sum(arith.prefill_flops(run.cfg, c.tokens) for c in p)
    return 100.0 * flops / (seconds * arith.PEAK_BF16_FLOPS)
