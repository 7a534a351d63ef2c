"""torch_ops.device_ms.sweep: device ms a sweep step of everything that is
not one of the program's hand-written kernels (the batched heating's
tensors: the cache's interpolation, exp, the layer product, Planck rows,
folds, the adjustment's copies), from the traced window."""

PROGRAM_KERNELS = (r"radau_kernel|linesum_kernel|window_kernel|correction_gather_kernel"
                   r"|olr_kernel|monoflux_kernel|fused_\w*kernel")


def read(run):
    if run.trace is None or run.kind != "sweep" or not run.trace.device:
        return None
    return run.trace.device_us(exclude=PROGRAM_KERNELS) / 1e3 / run.trace.units
