"""The engine's decode call: the window's decode-call wall time over its
decode steps."""


def read(run):
    d = run.window(run.log.decodes)
    return sum(c.t1 - c.t0 for c in d) * 1e3 / len(d) if d else None
