"""``flash_attention_backward``'s share of its roofline over the traced
blocks: launches of the main backward kernel times the bound of one causal
launch at the cell's (B, S + P, H, Kv, Dh), over the device time of its
three kernels (the row sums, the main kernel and dq's conversion).  The
bound is the larger of five products over the S (S + 1) / 2 kept pairs of
each head (5 x 2 x Dh operations a pair) at the bf16 peak, and the bytes of
q, k, v, out and dO read and dq, dk and dv written.  None in a cell without
attention, and where no such kernel ran (a program whose attention
backward is the plain float32 one)."""
from portbench import counts
from portbench.trace import kernel_time

KIND = "per_layer"
UNIT = "%"

KERNELS = ("flash_attention_bf16_backward_prep",
           "flash_attention_bf16_backward_kernel",
           "flash_attention_bf16_backward_dq")


def bound_s(B: int, S: int, H: int, Kv: int, Dh: int) -> float:
    """The least time of one causal bf16 backward launch."""
    pairs = S * (S + 1) // 2
    flops = 5 * 2 * B * H * pairs * Dh
    nbytes = 2 * (4 * B * S * H * Dh + 4 * B * S * Kv * Dh)
    return counts.bound_s(flops, nbytes, "bfloat16")


def read(run):
    traced, m = run.get("trace"), run["model"]
    if not traced or not m.get("num_heads") or m["dtype"] != "bfloat16":
        return None
    launches = kernel_time(traced, KERNELS[1])[0]
    seconds = sum(kernel_time(traced, name)[1] for name in KERNELS)
    if not launches or seconds <= 0:
        return None
    t = run["traffic"]
    return 100.0 * launches * bound_s(
        t["batch"], t["seq"] + t.get("image_positions", 0), m["num_heads"],
        m["num_kv_heads"], m["head_dim"]) / seconds
