"""Random weights drawn from the run's seed on the device, for any
architecture (``arch/<model_type>.py`` gives the layout).

The benchmark makes the weights, hands them to the program, and makes them
again for the reference: each layer comes from a ``torch.Generator`` of its
own, seeded from (seed, layer), in one draw, so the reference can remake any
layer alone, bit for bit, on the same device. A layout is a list of (name,
shape, std) in draw order; a tensor whose name ends in ``norm`` is
1 + N(0, std^2), so that a program that skipped it would be seen, every
other one N(0, std^2).
"""

from typing import Dict

import torch

_MIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9)

# A configuration's ``torch_dtype``: the type the weights are served in.
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _generator(seed: int, index: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * _MIX[0] + (index + 1) * _MIX[1]) % (1 << 63))
    return g


def _draw(layout, seed: int, index: int, device, dtype) -> Dict[str, torch.Tensor]:
    """One draw for the whole layout, scaled in float32, cast once; the
    tensors are views into one buffer."""
    total = sum(torch.Size(shape).numel() for _, shape, _ in layout)
    raw = torch.randn(total, generator=_generator(seed, index, device), device=device,
                      dtype=torch.float32)
    out = torch.empty(total, device=device, dtype=dtype)
    tensors, off = {}, 0
    for name, shape, std in layout:
        n = torch.Size(shape).numel()
        part = raw[off:off + n] * std
        if name.endswith("norm"):
            part += 1.0
        out[off:off + n] = part
        tensors[name] = out[off:off + n].view(shape)
        off += n
    return tensors
