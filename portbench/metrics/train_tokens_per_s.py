"""Positions through the decoder per second: K T B (S + P) for every whole
block the window completed, over the seconds from the window's start to
the device sync that ends its last whole block (host clock)."""
KIND = "end_to_end"
UNIT = "tokens/s"


def read(run):
    window = run.get("window")
    return None if window is None else window["tokens_per_s"]
