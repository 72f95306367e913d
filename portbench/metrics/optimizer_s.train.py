"""Host seconds a traced block in the optimizer update: the spans
``local.update`` (the gradient transform and ``w - mu u`` of each local
step), over the blocks traced with the device's activity alone
(:mod:`portbench.span_time`)."""
from portbench.span_time import per_block

KIND = "per_layer"
UNIT = "s"


def read(run):
    return per_block(run, "local.update")
