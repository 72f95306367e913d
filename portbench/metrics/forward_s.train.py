"""Host seconds a traced block in the model's forward: the spans
``local.forward`` (one agent's loss, a span for each agent and local
step), over the blocks traced with the device's activity alone
(:mod:`portbench.span_time`)."""
from portbench.span_time import per_block

KIND = "per_layer"
UNIT = "s"


def read(run):
    return per_block(run, "local.forward")
