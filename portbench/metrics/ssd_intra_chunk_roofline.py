"""``ssd_intra_chunk``'s share of its roofline over the traced blocks:
launches times the bound of one launch at the cell's (b, s, h, p, n, Q)
with B and C in the model's dtype, over the kernel's device time."""
from portbench import counts
from portbench.trace import kernel_time

KIND = "per_layer"
UNIT = "%"


def read(run):
    traced, m = run.get("trace"), run["model"]
    if not traced or not m.get("ssm_state"):
        return None
    n, seconds = kernel_time(traced, "ssd_intra_chunk_kernel")
    if not n:
        return None
    t = run["traffic"]
    heads = m["ssm_expand"] * m["d_model"] // m["ssm_head_dim"]
    s = -(-t["seq"] // m["ssm_chunk"]) * m["ssm_chunk"]
    bound = counts.bound_s(*counts.ssd_intra_chunk(
        t["batch"], s, heads, m["ssm_head_dim"], m["ssm_state"],
        m["ssm_chunk"], 2 if m["dtype"] == "bfloat16" else 4))
    return 100.0 * n * bound / seconds
