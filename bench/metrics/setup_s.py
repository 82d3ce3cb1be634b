"""From the process's start to the window's: imports, kernel libraries
loaded (built on a checkout's first run), weights drawn on the card, the
decode graph captured, every slot filled with a background request."""


def read(run):
    return run.setup_s
