"""The Llama block (Mistral-7B-v0.3 and Phi-3-mini-4k-instruct share it):
its work counts, the port's model configuration, its weights from the seed
and its plain reference (``reference/model.py``).

The counts count what the inputs need, never what a kernel happens to do: a
K and V byte is read once per layer whatever the kernel reads again, and a
padded row or a page no token attends costs nothing. ``roofline.least_s``
turns a piece's (bytes, operations) into its least time on the card.

The weights' names and shapes are the port's parameter dict
(``models/llama.py``): ``wq`` [dim, heads, head_dim], ``wk`` / ``wv``
[dim, kv_heads, head_dim], ``wo`` [heads, head_dim, dim], ``w_gate_up``
[dim, 2, ffn] (gate, then up), ``w_down`` [ffn, dim], ``embed`` [vocab,
dim], ``lm_head`` [dim, vocab]. Matrices are N(0, 1 / fan_in); the
embedding is N(0, 1); norm weights are 1 + N(0, 0.1^2) (``weights.py``).
"""

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from .. import weights


@dataclass(frozen=True)
class Shapes:
    """What the arithmetic needs of a configuration (a Llama block)."""

    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    ffn_dim: int
    vocab: int
    block_tokens: int
    dtype_bytes: int = 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def matmul_params(self) -> int:
        """Weights multiplied per token in all layers: q, k, v, o, gate, up,
        down (the embedding is a lookup and the output head is counted
        apart)."""
        hd = self.head_dim
        attn = self.dim * (self.n_heads * hd) * 2 + self.dim * (self.n_kv_heads * hd) * 2
        ffn = 3 * self.dim * self.ffn_dim
        return self.n_layers * (attn + ffn)

    def kv_bytes_per_token(self) -> int:
        """K and V of one token over all layers."""
        return self.n_layers * 2 * self.n_kv_heads * self.head_dim * self.dtype_bytes

    def block_bytes(self) -> int:
        """One cache block (``block_tokens`` tokens) over all layers, K and V."""
        return self.block_tokens * self.kv_bytes_per_token()

    def attention_flops(self, context: int) -> float:
        """QK and PV of one query row against ``context`` keys, all layers."""
        return 4.0 * self.n_layers * self.n_heads * self.head_dim * context

    def head_flops(self) -> float:
        """The output head for one row of logits."""
        return 2.0 * self.dim * self.vocab

    def token_flops(self, context: int, logits: bool) -> float:
        """One token's forward at ``context`` keys (itself included): the
        matmul work, its attention and, with ``logits``, the output head."""
        return (2.0 * self.matmul_params() + self.attention_flops(context)
                + (self.head_flops() if logits else 0.0))

    def prefill_flops(self, start: int, n: int, logits_rows: int) -> float:
        """Tokens ``start .. start + n - 1`` computed against everything
        before them (causal), with ``logits_rows`` rows of the output head."""
        # sum over p of (p + 1) keys = n * start + n * (n + 1) / 2
        keys = n * start + n * (n + 1) / 2
        return (2.0 * self.matmul_params() * n
                + 4.0 * self.n_layers * self.n_heads * self.head_dim * keys
                + self.head_flops() * logits_rows)

    def decode_attention_work(self, position: int) -> tuple:
        """(bytes, flops) of one decode row at ``position``: its context's K
        and V read once in every layer, its q read and its output written."""
        context = position + 1
        q_out = self.n_layers * 2 * self.n_heads * self.head_dim * self.dtype_bytes
        return self.kv_bytes_per_token() * context + q_out, self.attention_flops(context)

    def resume_attention_work(self, start: int, n: int) -> tuple:
        """(bytes, flops) of a resumed suffix: ``n`` rows from ``start`` that
        attend the loaded prefix and themselves (causal). The context's K and
        V are read once, the rows' q read and outputs written once."""
        keys = n * start + n * (n + 1) / 2
        q_out = self.n_layers * 2 * self.n_heads * self.head_dim * self.dtype_bytes * n
        nbytes = self.kv_bytes_per_token() * (start + n) + q_out
        return nbytes, 4.0 * self.n_layers * self.n_heads * self.head_dim * keys


def shapes(cfg: dict) -> Shapes:
    """From a configuration file's published keys (``configs/*.json``)."""
    return Shapes(
        dim=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        ffn_dim=cfg["intermediate_size"],
        vocab=cfg["vocab_size"],
        block_tokens=cfg["block_tokens"],
        dtype_bytes={"bfloat16": 2, "float32": 4}[cfg["torch_dtype"]],
    )


def program(cfg: dict, device=None):
    """The port's model configuration (``LlamaConfig``; it holds no device)."""
    from infinistore_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab=cfg["vocab_size"], dim=cfg["hidden_size"], n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
        ffn_dim=cfg["intermediate_size"], block_tokens=cfg["block_tokens"],
        rope_theta=float(cfg["rope_theta"]), dtype=weights.DTYPES[cfg["torch_dtype"]],
    )


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


def layer(s: Shapes, seed: int, index: int, device, dtype) -> Dict[str, torch.Tensor]:
    """Layer ``index``'s tensors, keyed by their names within the layer."""
    return weights._draw(_layer_layout(s), seed, index, device, dtype)


def outer(s: Shapes, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The embedding, the final norm and the output head."""
    layout = [
        ("embed", (s.vocab, s.dim), 1.0),
        ("final_norm", (s.dim,), 0.1),
        ("lm_head", (s.dim, s.vocab), s.dim ** -0.5),
    ]
    return weights._draw(layout, seed, s.n_layers, device, dtype)


def params(cfg: dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The whole parameter dict in the port's names (``l{i}.wq`` ...)."""
    s = shapes(cfg)
    p = dict(outer(s, seed, device, dtype))
    for i in range(s.n_layers):
        for name, t in layer(s, seed, i, device, dtype).items():
            p[f"l{i}.{name}"] = t
    return p


def reference(cfg: dict, seed: int, device, weight_dtype, quant=None):
    """The plain float32 reference (``reference/model.py``), its weights
    remade from the seed in ``weight_dtype``; ``quant="fp8"`` is the
    control."""
    from ..reference.model import Reference

    return Reference(shapes(cfg), float(cfg["rope_theta"]), cfg["rms_norm_eps"], seed, device,
                     weight_dtype=weight_dtype, quant=quant)
