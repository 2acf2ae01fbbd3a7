"""kernel.moe_expert_roofline: in percent, the least time of the routed
experts' grouped GEMMs' work in the traced span over the device time of
their kernels there (PyTorch's grouped GEMM: CUTLASS's device_kernel and the
kernel that lays out its groups' problems). Work, from the program's own
counters (RequestStats.device_counts: per launch, the (layer, expert)
weight sets read and the (token, expert) pairs computed, stamped when they
reached the host, a wave's shared over its rows), each launch stamped in the
span, counted by the configuration's architecture (run.shapes
.moe_expert_work): every weight set read once, each pair's rows in and out
of both projections, 6 x hidden x expert width operations a pair; each
launch takes the larger of bytes over 3.35 TB/s and operations over 989
TFLOP/s. None where the trace has no such kernel or the program or the
architecture no such count."""

from h100bench import roofline


def _grouped_gemm(name):
    """CUTLASS's device_kernel (the profiler may leave its long name
    mangled: _ZN7cutlass13device_kernel...) or prepare_grouped_gemm_data."""
    return ("cutlass" in name and "device_kernel" in name) or "grouped_gemm" in name


def read(run):
    if run.trace is None:
        return None
    kernel_s = sum(s for name, s in run.trace.device_ops if _grouped_gemm(name))
    work = getattr(run.shapes, "moe_expert_work", None)
    if not kernel_s or work is None:
        return None
    a, b = run.trace_span
    least = 0.0
    for t in run.turns:
        if not t.ok:
            continue
        for stamp in getattr(t.stats, "device_counts", None) or ():
            if a < stamp[0] <= b:
                least += roofline.least_s(*work(stamp[1], stamp[2]))
    return 100.0 * least / kernel_s if least else None
