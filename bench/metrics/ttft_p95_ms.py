"""Reserved tenants' time to first token, from each request's due time by
the harness's clock: the 95th percentile over every reserved request due
in the window that got its first token (in the window or the drain after
it; one that never did counts in ``failed``).  The background leaves the
reserved tenants a share of the slots, so this is the wait for a bucket
and for the prefills and decode step ahead, and the request's own
prefill."""
from bench.stats import percentile


def read(run):
    return percentile(((r.first - r.due) * 1e3 for r in run.reserved_due()
                       if r.times), 95)
