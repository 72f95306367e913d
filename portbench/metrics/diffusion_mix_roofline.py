"""``diffusion_mix``'s share of its roofline over the traced blocks: one
combination of the (K, M) stack a block (the engine combines once a
block), times the bound of one whole combination, over the kernel's
device time in those blocks.  The count takes no notice of how the
program tiles a combination into launches."""
from portbench import counts
from portbench.trace import kernel_time

KIND = "per_layer"
UNIT = "%"


def read(run):
    traced, t = run.get("trace"), run["traffic"]
    if not traced:
        return None
    n, seconds = kernel_time(traced, "diffusion_mix_kernel")
    if not n:
        return None
    K, M = t["agents"], t["params_per_agent"]
    bound = counts.bound_s(*counts.diffusion_mix(K, M))
    return 100.0 * traced["blocks"] * bound / seconds
