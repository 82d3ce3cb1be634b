"""The flash-prefill kernel's share of its roofline over the traced
stretch: the least time its launches could take (from their operations
and bytes, ``bench/arith.py``: one causal call a layer a prefill) over
their device time, in percent.  Nothing to read where the stretch holds no
prefill.  Should the trace hold fewer launches than the calls, each is
taken at the calls' mean bound."""
from bench import arith

KERNEL = "flash_prefill"


def read(run):
    if run.trace is None:
        return None
    calls = [c for c in run.log.prefills if c.traced]
    n, seconds = run.trace.kernel(KERNEL)
    if not calls or not n or seconds <= 0:
        return None
    mean = sum(arith.bound_s(*arith.flash_prefill_call(run.cfg, c.tokens))
               for c in calls) / len(calls)
    return 100.0 * mean * n / seconds
