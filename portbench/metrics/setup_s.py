"""Seconds from the process's start to the window's start: imports, the
kernels' build or load, the engine, the weights drawn on the card, and
the checked blocks that warm every shape (host clock)."""
KIND = "end_to_end"
UNIT = "s"


def read(run):
    return run["setup_s"]
