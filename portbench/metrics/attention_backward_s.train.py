"""Host seconds a traced block in the plain float32 attention backward:
the spans ``model.attention.backward`` (one a layer, agent and local
step), over the blocks traced with the device's activity alone
(:mod:`portbench.span_time`); None in a cell without attention."""
from portbench.span_time import per_block

KIND = "per_layer"
UNIT = "s"


def read(run):
    return per_block(run, "model.attention.backward")
