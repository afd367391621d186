"""gicp_step_kernel, every form: Σ bound (bytes once, the problem's fp32 operations) / Σ device time, in %."""
from portbench import readers


def read(ctx):
    return readers.kernel_roofline(ctx, "gicp_step")
