"""``quant_expert_gemm``'s share of its roofline in the traced slice: the
least time of its calls (every int8 expert stack of every tick, over the
capacity buffer that all the slots route into) over the device time of its
kernels."""
from portbench.harness import flops, readers

LAYER = "kernels (kernels/csrc via ops.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "decode_tok_s"
KERNEL = "quant_expert_gemm_kernel"


def read(run):
    if run.trace is None:
        return None
    calls = flops.moe_expert_calls(run.cfg, run.plan, run.system.slots)
    bound = len(run.passes(traced=True)) * sum(
        flops.expert_gemm_bound_s(*c) for c in calls)
    return readers.kernel_roofline_pct(run, KERNEL, bound)
