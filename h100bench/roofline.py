"""The work a Llama-block model needs, counted from its configuration's shapes,
and the least time one H100 takes for it.

Every function counts what the inputs need, never what a kernel happens to
do: a K and V byte is read once per layer whatever the kernel reads again,
and a padded row or a page no token attends costs nothing. The least time
of a piece of work is the larger of its bytes over the memory rate and its
operations over the bf16 tensor-core rate (copied from the port's kernel
timing arithmetic, ``bound_ms``, so that a later change to the program
cannot move this yardstick).
"""

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 rate, at
# the card's full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


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

    @classmethod
    def of(cls, config: dict) -> "Shapes":
        """From a configuration file's published keys (``configs/*.json``)."""
        return cls(
            dim=config["hidden_size"],
            n_layers=config["num_hidden_layers"],
            n_heads=config["num_attention_heads"],
            n_kv_heads=config["num_key_value_heads"],
            ffn_dim=config["intermediate_size"],
            vocab=config["vocab_size"],
            block_tokens=config["block_tokens"],
            dtype_bytes={"bfloat16": 2, "float32": 4}[config["torch_dtype"]],
        )


def least_s(nbytes: float, flops: float) -> float:
    """Least seconds for the work: bytes over HBM, or operations over bf16."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def matmul_params(s: Shapes) -> int:
    """Weights multiplied per token in all layers: q, k, v, o, gate, up, down
    (the embedding is a lookup and the output head is counted apart)."""
    hd = s.head_dim
    attn = s.dim * (s.n_heads * hd) * 2 + s.dim * (s.n_kv_heads * hd) * 2
    ffn = 3 * s.dim * s.ffn_dim
    return s.n_layers * (attn + ffn)


def kv_bytes_per_token(s: Shapes) -> int:
    """K and V of one token over all layers."""
    return s.n_layers * 2 * s.n_kv_heads * s.head_dim * s.dtype_bytes


def block_bytes(s: Shapes) -> int:
    """One cache block (``block_tokens`` tokens) over all layers, K and V."""
    return s.block_tokens * kv_bytes_per_token(s)


def attention_flops(s: Shapes, context: int) -> float:
    """QK and PV of one query row against ``context`` keys, all layers."""
    return 4.0 * s.n_layers * s.n_heads * s.head_dim * context


def head_flops(s: Shapes) -> float:
    """The output head for one row of logits."""
    return 2.0 * s.dim * s.vocab


def token_flops(s: Shapes, context: int, logits: bool) -> float:
    """One token's forward at ``context`` keys (itself included): the matmul
    work, its attention and, with ``logits``, the output head."""
    return 2.0 * matmul_params(s) + attention_flops(s, context) + (head_flops(s) if logits else 0.0)


def prefill_flops(s: Shapes, start: int, n: int, logits_rows: int) -> float:
    """Tokens ``start .. start + n - 1`` computed against everything before
    them (causal), with ``logits_rows`` rows of the output head."""
    # sum over p of (p + 1) keys = n * start + n * (n + 1) / 2
    keys = n * start + n * (n + 1) / 2
    return 2.0 * matmul_params(s) * n + 4.0 * s.n_layers * s.n_heads * s.head_dim * keys + (
        head_flops(s) * logits_rows
    )


def decode_attention_work(s: Shapes, position: int) -> tuple:
    """(bytes, flops) of one decode row at ``position``: its context's K and V
    read once in every layer, its q read and its output written."""
    context = position + 1
    q_out = s.n_layers * 2 * s.n_heads * s.head_dim * s.dtype_bytes
    return kv_bytes_per_token(s) * context + q_out, attention_flops(s, context)


def resume_attention_work(s: Shapes, start: int, n: int) -> tuple:
    """(bytes, flops) of a resumed suffix: ``n`` rows from ``start`` that
    attend the loaded prefix and themselves (causal). The context's K and V
    are read once, the rows' q read and outputs written once."""
    keys = n * start + n * (n + 1) / 2
    q_out = s.n_layers * 2 * s.n_heads * s.head_dim * s.dtype_bytes * n
    nbytes = kv_bytes_per_token(s) * (start + n) + q_out
    return nbytes, 4.0 * s.n_layers * s.n_heads * s.head_dim * keys
