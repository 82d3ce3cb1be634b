"""Reserved tenants' gaps between consecutive output tokens: the 95th
percentile over every such gap that ends in the window.  A round that
admits prefills before its decode step lengthens these gaps."""
from bench.stats import percentile


def read(run):
    gaps = []
    for r in run.log.recs.values():
        if r.reserved:
            t = r.times
            gaps.extend((b - a) * 1e3 for a, b in zip(t, t[1:])
                        if run.t0 <= b <= run.t1)
    return percentile(gaps, 95)
