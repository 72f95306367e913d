"""The whole step's share of the card's bf16 dense peak: the frozen
useful operations of the window's whole blocks
(:func:`portbench.counts.block_flops`) over the window's seconds, over
989 TFLOP/s."""
from portbench import counts

KIND = "per_layer"
UNIT = "%"


def read(run):
    window = run.get("window")
    if window is None or run["device"] != "cuda":
        return None
    flops = run["block_flops"] * window["blocks"]
    return 100.0 * flops / window["seconds"] / counts.PEAKS["bfloat16"]
