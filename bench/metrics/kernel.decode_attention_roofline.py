"""The decode-attention kernel's share of its roofline over the traced
stretch: the least time its launches could take (one a layer a decode
step, over every slot at its cache length, ``bench/arith.py``) over their
device time, in percent.  Should the trace hold fewer launches than the
calls, each is taken at the calls' mean bound."""
from bench import arith

KERNEL = "decode_attention"


def read(run):
    if run.trace is None:
        return None
    calls = [c for c in run.log.decodes if c.traced]
    n, seconds = run.trace.kernel(KERNEL)
    if not calls or not n or seconds <= 0:
        return None
    dtype = run.engine["cache_dtype"]
    mean = sum(arith.bound_s(*arith.decode_attention_call(
        run.cfg, c.lengths, dtype)) for c in calls) / len(calls)
    return 100.0 * mean * n / seconds
