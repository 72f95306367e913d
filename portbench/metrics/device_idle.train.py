"""Share of an untraced block in which no operation runs on the device:
1 - the device's busy seconds a block, from the traced blocks (the union
of their device intervals over the number of traced blocks), over the
mean block of the same run's untraced window (its seconds over its whole
blocks).  The profiler slows the host, so the traced blocks' own window
would read the idle share too high; the device's work a block is what
the trace reads well."""
KIND = "per_layer"
UNIT = "%"


def read(run):
    traced, window = run.get("trace"), run.get("window")
    if not traced or traced["busy_s"] <= 0 or window is None:
        return None
    busy_per_block = traced["busy_s"] / traced["blocks"]
    block_s = window["seconds"] / window["blocks"]
    return 100.0 * (1.0 - busy_per_block / block_s)
