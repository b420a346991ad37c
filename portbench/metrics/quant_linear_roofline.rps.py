"""``quant_linear``'s share of its roofline in the traced slice: the least
time of its calls (each pass's int8 block GEMMs over the padded rows, from
``flops.encoder_gemms``) over the device time of its kernels."""
from portbench.harness import flops, readers

LAYER = "kernels (kernels/csrc via ops.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "encode_rps"
KERNEL = "quant_linear_kernel"


def read(run):
    if run.trace is None:
        return None
    bound = sum(flops.quant_linear_bound_s(run.cfg, run.plan,
                                           rows_bucket * len_bucket)
                for rows_bucket, len_bucket in
                (run.system.bucket_of(p) for p in run.passes(traced=True)))
    return readers.kernel_roofline_pct(run, KERNEL, bound)
