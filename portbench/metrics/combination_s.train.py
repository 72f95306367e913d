"""The engine's combination (``metrics["combine_s"]``: host clock around
the tiled mix, ending in a device sync), averaged over the window's whole
blocks."""
KIND = "per_layer"
UNIT = "s"


def read(run):
    window = run.get("window")
    return None if window is None else window["combine_s"]
