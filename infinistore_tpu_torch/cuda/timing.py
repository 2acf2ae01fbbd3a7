"""Kernel timing on one CUDA card, shared by ``chip_smoke.py`` and the
probes under this directory: per-launch CUDA-event times behind an L2 flush,
the host's time per call of a wrapper, and a function's least time on an
H100 (its bytes over the memory rate, or its operations over the peak rate
of its input type). The package's entry points do not import it.
"""

import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; f32 CUDA cores


class Timer:
    """Per-launch CUDA-event timing with the L2 cache flushed before each
    launch (the main path finds its KV cold). Before each start event the
    card spins (``torch.cuda._sleep``, about 1 ms) while the host queues the
    flush, the events and the call, so the card reaches the start event only
    after the launch is queued and the wrapper's host work stays out of the
    measurement. The median of the launches is reported."""

    SPIN_CYCLES = 2_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 11, warmup: int = 2, spin: int = 1) -> float:
        """Median ms of ``fn``; ``spin`` multiplies the spin, for calls that
        queue many launches (their host work must stay inside it too)."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(self.SPIN_CYCLES * spin)
            self.flush.zero_()
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]


def host_us(torch, fn, calls: int = 50) -> float:
    """The host's time per call of ``fn`` (its launches queued, not run):
    the card is kept busy by a spin, so the queue never waits on it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(Timer.SPIN_CYCLES * 20)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed * 1e6 / calls


def bound_ms(nbytes: float, flops: float, dtype_name: str):
    """(least ms, what bounds it): the larger of ``nbytes`` over the memory
    rate and ``flops`` over the peak rate of ``dtype_name``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())
