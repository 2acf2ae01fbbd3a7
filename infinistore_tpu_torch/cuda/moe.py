"""The routed experts' grouped GEMM: one launch multiplies every (token,
expert) pair's row by its own expert's weights.

``grouped_gemm(x, w, ends)``: ``x`` [P, K] holds the pairs' rows sorted by
expert, ``w`` [E, K, N] the experts' weights, ``ends`` [E] int32 the
cumulative row counts (expert e's rows are ``ends[e - 1] .. ends[e] - 1``);
the result is [P, N] in x's dtype, row i = x[i] @ w[expert of row i],
accumulated in f32.

This routing has no counterpart among the TPU kernels, so on CUDA tensors it
is PyTorch's grouped GEMM, ``torch._grouped_mm`` (on the H100 a CUTLASS
kernel, ``cutlass::device_kernel`` in a device trace, after a small kernel
that lays out the groups' problems from ``ends``). The row ends stay on the
device and nothing is read back, so a CUDA graph can capture the launch (the
decode waves' graphs do). ``chip_smoke.py``'s kernel phase times it at a
decode wave and a prefill chunk against its bound and the plain version.

On CPU tensors the plain version: one matmul per expert over its rows.
"""

import torch


def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """The plain version: each expert's rows times its weights."""
    out = x.new_empty((x.shape[0], w.shape[2]))
    start = 0
    for expert, end in enumerate(ends.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[expert]
        start = end
    return out


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """[P, K] rows sorted by expert times their experts' [E, K, N] weights
    (module docstring); PyTorch's grouped GEMM on CUDA, the plain version on
    CPU."""
    if x.device.type == "cpu":
        return grouped_gemm_plain(x, w, ends)
    return torch._grouped_mm(x, w, offs=ends)
