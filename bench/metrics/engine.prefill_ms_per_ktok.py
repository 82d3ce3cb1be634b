"""The engine's prefill call: the window's prefill-call wall time per 1,000
prompt tokens."""


def read(run):
    p = run.window(run.log.prefills)
    tokens = sum(c.tokens for c in p)
    return sum(c.t1 - c.t0 for c in p) * 1e6 / tokens if tokens else None
