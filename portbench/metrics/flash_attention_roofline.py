"""``flash_attention``'s share of its roofline over the traced blocks:
launches times the bound of one causal launch at the cell's (B, S + P,
H, Kv, Dh) in the model's dtype, over the kernel's device time."""
from portbench import counts
from portbench.trace import kernel_time

KIND = "per_layer"
UNIT = "%"


def read(run):
    traced, m = run.get("trace"), run["model"]
    if not traced or not m.get("num_heads"):
        return None
    bf16 = m["dtype"] == "bfloat16"
    n, seconds = kernel_time(traced, "flash_attention_bf16_kernel" if bf16
                             else "flash_attention_kernel")
    if not n:
        return None
    t = run["traffic"]
    bound = counts.bound_s(*counts.flash_attention(
        t["batch"], t["seq"] + t.get("image_positions", 0), m["num_heads"],
        m["num_kv_heads"], m["head_dim"], 2 if bf16 else 4))
    return 100.0 * n * bound / seconds
