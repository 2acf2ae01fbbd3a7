"""kernel.block_copy_roofline: in percent, the bytes of the blocks saved and loaded, each
read once and written once, over 3.35 TB/s, over the device time of K1 / K2
(bulk_copy, vector_copy) in the traced span. The saves and loads counted are
those whose calls began and ended inside the span (serve.TimedAdapter)."""

from h100bench import roofline


def read(run):
    if run.trace is None or not run.trace.kernel_s.get("block_copy"):
        return None
    a, b = run.trace_span
    nbytes = sum(n for t0, t1, n in run.saves + run.loads if a <= t0 and t1 <= b)
    least = 2 * nbytes / roofline.HBM_BYTES_PER_S
    return 100.0 * least / run.trace.kernel_s["block_copy"] if least else None
