"""The median wait of reserved requests due in the window, from the due
time to the start of their prefill (queueing for a slot, and shaping)."""
from bench.stats import percentile


def read(run):
    return percentile(((r.admit_start - r.due) * 1e3
                       for r in run.reserved_due() if r.times), 50)
