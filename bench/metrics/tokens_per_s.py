"""Output tokens generated in the window by every tenant (a prefill's first
token included), over the window's seconds."""


def read(run):
    n = sum(sum(1 for t in r.times if run.t0 <= t <= run.t1)
            for r in run.log.recs.values())
    return n / (run.t1 - run.t0)
