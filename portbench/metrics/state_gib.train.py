"""Bytes of the engine's state after set-up (parameters, optimizer,
pipeline, graph and participation state), in GiB."""
KIND = "per_layer"
UNIT = "GiB"


def read(run):
    return run["state_bytes"] / 2 ** 30 if run.get("state_bytes") else None
