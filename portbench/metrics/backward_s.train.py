"""Host seconds a traced block in the backward: the spans
``local.backward`` (the one ``torch.autograd.grad`` call of each local
step), over the blocks traced with the device's activity alone
(:mod:`portbench.span_time`)."""
from portbench.span_time import per_block

KIND = "per_layer"
UNIT = "s"


def read(run):
    return per_block(run, "local.backward")
