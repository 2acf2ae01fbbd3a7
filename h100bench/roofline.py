"""The card's rates and the least time one H100 takes for a piece of work.

The least time of a piece of work is the larger of its bytes over the memory
rate and its operations over the bf16 tensor-core rate (copied from the
port's kernel timing arithmetic, ``bound_ms``, so that a later change to the
program cannot move this yardstick). What a piece of work is, in bytes and
operations, each architecture counts (``arch/<model_type>.py``).
"""

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 rate, at
# the card's full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_s(nbytes: float, flops: float) -> float:
    """Least seconds for the work: bytes over HBM, or operations over bf16."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
