"""Random weights of a Llama block, drawn from the run's seed on the device.

The benchmark makes the weights, hands them to the program, and makes them
again for the reference: each layer comes from a ``torch.Generator`` of its
own, seeded from (seed, layer), in one draw, so the reference can remake any
layer alone, bit for bit, on the same device. The names and shapes are the
port's parameter dict (``models/llama.py``): ``wq`` [dim, heads, head_dim],
``wk`` / ``wv`` [dim, kv_heads, head_dim], ``wo`` [heads, head_dim, dim],
``w_gate_up`` [dim, 2, ffn] (gate, then up), ``w_down`` [ffn, dim],
``embed`` [vocab, dim], ``lm_head`` [dim, vocab].

Matrices are N(0, 1 / fan_in); the embedding is N(0, 1); norm weights are
1 + N(0, 0.1^2), so that a program that skipped them would be seen.
"""

from typing import Dict, List, Tuple

import torch

from .roofline import Shapes

_MIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9)


def _generator(seed: int, index: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * _MIX[0] + (index + 1) * _MIX[1]) % (1 << 63))
    return g


def _layer_layout(s: Shapes) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, std) of one layer's tensors, in draw order."""
    hd = s.head_dim
    return [
        ("attn_norm", (s.dim,), 0.1),
        ("wq", (s.dim, s.n_heads, hd), s.dim ** -0.5),
        ("wk", (s.dim, s.n_kv_heads, hd), s.dim ** -0.5),
        ("wv", (s.dim, s.n_kv_heads, hd), s.dim ** -0.5),
        ("wo", (s.n_heads, hd, s.dim), (s.n_heads * hd) ** -0.5),
        ("ffn_norm", (s.dim,), 0.1),
        ("w_gate_up", (s.dim, 2, s.ffn_dim), s.dim ** -0.5),
        ("w_down", (s.ffn_dim, s.dim), s.ffn_dim ** -0.5),
    ]


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


def layer(s: Shapes, seed: int, index: int, device, dtype) -> Dict[str, torch.Tensor]:
    """Layer ``index``'s tensors, keyed by their names within the layer."""
    return _draw(_layer_layout(s), seed, index, device, dtype)


def outer(s: Shapes, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The embedding, the final norm and the output head."""
    layout = [
        ("embed", (s.vocab, s.dim), 1.0),
        ("final_norm", (s.dim,), 0.1),
        ("lm_head", (s.dim, s.vocab), s.dim ** -0.5),
    ]
    return _draw(layout, seed, s.n_layers, device, dtype)


def params(s: Shapes, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The whole parameter dict in the port's names (``l{i}.wq`` ...)."""
    p = dict(outer(s, seed, device, dtype))
    for i in range(s.n_layers):
        for name, t in layer(s, seed, i, device, dtype).items():
            p[f"l{i}.{name}"] = t
    return p
