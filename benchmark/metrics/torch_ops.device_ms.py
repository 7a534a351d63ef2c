"""torch_ops.device_ms: device ms a call of everything that is not one of
the program's hand-written kernels (PyTorch's own kernels, copies and
fills: the layer optical depth, Planck rows, the Radau cache's
interpolation, the flux assembly), from the traced window."""

PROGRAM_KERNELS = (r"radau_kernel|linesum_kernel|window_kernel|correction_gather_kernel"
                   r"|olr_kernel|monoflux_kernel|fused_\w*kernel")


def read(run):
    if run.trace is None or run.kind != "column_calls" or not run.trace.device:
        return None
    us = run.trace.device_us(exclude=PROGRAM_KERNELS)
    return us / 1e3 / run.trace.units
