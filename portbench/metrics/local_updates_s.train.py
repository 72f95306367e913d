"""The engine's local updates (``metrics["local_s"]``: host clock around
the T local steps of all agents, ending in a device sync), averaged over
the window's whole blocks."""
KIND = "per_layer"
UNIT = "s"


def read(run):
    window = run.get("window")
    return None if window is None else window["local_s"]
