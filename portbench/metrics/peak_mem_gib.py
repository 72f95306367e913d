"""``torch.cuda.max_memory_allocated()`` over set-up and window, in GiB."""
KIND = "end_to_end"
UNIT = "GiB"


def read(run):
    return run["peak_bytes"] / 2 ** 30 if run.get("peak_bytes") else None
