"""device.idle_share: in percent, 1 - the union of the device's activity over the traced
span, from torch.profiler (CUPTI)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
