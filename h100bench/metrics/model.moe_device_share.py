"""model.moe_device_share: in percent, the device time of the routed
experts' grouped GEMM (PyTorch's: CUTLASS's device_kernel and the kernel
that lays out its groups' problems) over the union of device activity in
the traced span, from torch.profiler (CUPTI). None where the trace has no
such kernel."""


def _grouped_gemm(name):
    """CUTLASS's device_kernel (the profiler may leave its long name
    mangled: _ZN7cutlass13device_kernel...) or prepare_grouped_gemm_data."""
    return ("cutlass" in name and "device_kernel" in name) or "grouped_gemm" in name


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    kernel_s = sum(s for name, s in run.trace.device_ops if _grouped_gemm(name))
    return 100.0 * kernel_s / run.trace.busy_s if kernel_s else None
