"""The scheduler's host time: a round's wall ms outside the engine's
``admit`` and ``step``, averaged over the window's rounds."""


def read(run):
    rounds = run.window(run.log.rounds)
    if not rounds:
        return None
    return sum((r.t1 - r.t0 - r.engine_s) for r in rounds) * 1e3 / len(rounds)
