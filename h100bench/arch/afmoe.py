"""AFMoE (``model_type`` ``afmoe``; Arcee's Trinity-Mini): its work counts,
the port's model configuration, its weights from the seed and its plain
reference (``reference/afmoe.py``).

The layer (the configuration file's ``assumed``): an embedding scaled by
sqrt(hidden); per layer RMSNorm, q, k, v projections at an explicit head_dim
with a per-head RMSNorm of q and k, RoPE on the sliding layers alone,
causal attention (sliding layers over their last ``sliding_window`` keys),
the output gated by sigmoid(a W_gate), projected and RMSNorm'd before its
residual; RMSNorm, then the first ``num_dense_layers`` a SwiGLU, the others
a routed mixture (sigmoid scores, top ``num_experts_per_tok`` of scores +
expert_bias, weights normalised and scaled by ``route_scale``) plus a shared
expert, RMSNorm'd before the residual; a final RMSNorm and the untied head.

The counts count what the inputs need, as ``arch/llama.py``'s do: a K and V
byte once per layer, a padded row nothing. A sliding layer's row attends
``min(context, sliding_window)`` keys. A token's matmul weights are the
attention's (q, k, v, o, gate), the dense SwiGLU or the shared one, and its
``num_experts_per_tok`` routed experts (the f32 router is not counted).
``moe_expert_work`` gives the routed experts' grouped GEMM its (bytes,
operations) from the program's counters: every distinct expert's weights
once per launch, and each (token, expert) pair's rows in and out.

The weights' names and shapes are the port's parameter dict
(``models/llama.py``, ``LlamaConfig``'s AFMoE fields): ``wq`` / ``w_attn_gate``
[dim, heads, head_dim], ``wk`` / ``wv`` [dim, kv_heads, head_dim], ``wo``
[heads, head_dim, dim], ``q_norm`` / ``k_norm`` [head_dim], the sandwich norms
[dim]; dense layers ``w_gate_up`` [dim, 2, ffn] (gate, then up), ``w_down``;
routed layers ``router`` [dim, experts], ``expert_bias`` [experts],
``w_gate_up_moe`` [experts, dim, 2, expert_ffn], ``w_down_moe``,
``w_gate_up_shared`` [dim, 2, expert_ffn], ``w_down_shared``. Matrices are
N(0, 1 / fan_in); the embedding N(0, 1 / hidden), as muP initialises it,
so that the embedding times sqrt(hidden) is of unit RMS (an N(0, 1)
embedding would carry an RMS of 45 down the residual stream, where bf16's
spacing is 0.25 and the layers' unit-RMS additions are rounding noise); norm
weights 1 + N(0, 0.1^2); ``expert_bias`` N(0, 0.01^2), so that it moves some
choices.
"""

import importlib.util
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from .. import weights

SLIDING = "sliding_attention"


def _require_program() -> None:
    """Fail at once, before anything is built, on a checkout whose program
    has no AFMoE block: its model's source (read, not imported, so that the
    reference stays apart from the program) must declare the fields
    ``program`` sets."""
    found = importlib.util.find_spec("infinistore_tpu_torch")
    path = os.path.join(os.path.dirname(found.origin), "models", "llama.py") if found else ""
    src = open(path).read() if os.path.exists(path) else ""
    missing = [f for f in ("head_size", "layer_types", "moe_top_k", "attn_gate")
               if f"\n    {f}: " not in src]
    if missing:
        raise RuntimeError(f"afmoe: the program's LlamaConfig has no {', '.join(missing)}: "
                           "this checkout cannot run an AFMoE configuration")


_require_program()


@dataclass(frozen=True)
class Shapes:
    """What the arithmetic needs of a configuration (an AFMoE block)."""

    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ffn_dim: int  # the dense layers' SwiGLU
    expert_ffn: int
    n_experts: int
    top_k: int
    n_shared: int
    n_dense: int
    window: int
    layer_types: Tuple[str, ...]
    vocab: int
    block_tokens: int
    dtype_bytes: int = 2

    @property
    def n_sliding(self) -> int:
        return sum(t == SLIDING for t in self.layer_types)

    @property
    def n_full(self) -> int:
        return self.n_layers - self.n_sliding

    def matmul_params(self) -> int:
        """Weights multiplied per token in all layers: q, k, v, o, the gate,
        and the dense SwiGLU or the shared expert and ``top_k`` routed ones
        (the embedding is a lookup and the output head is counted apart)."""
        q = self.n_heads * self.head_dim
        attn = self.dim * q * 3 + self.dim * self.n_kv_heads * self.head_dim * 2
        dense = 3 * self.dim * self.ffn_dim
        moe = 3 * self.dim * self.expert_ffn * (self.n_shared + self.top_k)
        n_moe = self.n_layers - self.n_dense
        return self.n_layers * attn + self.n_dense * dense + n_moe * moe

    def kv_bytes_per_token(self) -> int:
        """K and V of one token over all layers."""
        return self.n_layers * 2 * self.n_kv_heads * self.head_dim * self.dtype_bytes

    def block_bytes(self) -> int:
        """One cache block (``block_tokens`` tokens) over all layers, K and V."""
        return self.block_tokens * self.kv_bytes_per_token()

    def _layer_keys(self, context: int) -> int:
        """Keys one row at ``context`` keys attends, summed over the layers."""
        return self.n_full * context + self.n_sliding * min(context, self.window)

    def attention_flops(self, context: int) -> float:
        """QK and PV of one query row against ``context`` keys, all layers."""
        return 4.0 * self.n_heads * self.head_dim * self._layer_keys(context)

    def head_flops(self) -> float:
        """The output head for one row of logits."""
        return 2.0 * self.dim * self.vocab

    def token_flops(self, context: int, logits: bool) -> float:
        """One token's forward at ``context`` keys (itself included): the
        matmul work, its attention and, with ``logits``, the output head."""
        return (2.0 * self.matmul_params() + self.attention_flops(context)
                + (self.head_flops() if logits else 0.0))

    def _window_sum(self, start: int, n: int) -> float:
        """sum over p in [start, start + n) of min(p + 1, window)."""
        a, b, w = start + 1, start + n, self.window  # contexts a .. b
        below = max(0, min(b, w) - a + 1)  # contexts a .. min(b, w) count themselves
        lo = a
        tri = (lo + lo + below - 1) * below / 2 if below else 0.0
        return tri + w * (n - below)

    def _keys(self, start: int, n: int) -> float:
        """Keys the rows ``start .. start + n - 1`` attend (causal), summed
        over rows and layers."""
        full = n * start + n * (n + 1) / 2
        return self.n_full * full + self.n_sliding * self._window_sum(start, n)

    def prefill_flops(self, start: int, n: int, logits_rows: int) -> float:
        """Tokens ``start .. start + n - 1`` computed against everything
        before them (causal, sliding layers within their window), with
        ``logits_rows`` rows of the output head."""
        return (2.0 * self.matmul_params() * n
                + 4.0 * self.n_heads * self.head_dim * self._keys(start, n)
                + self.head_flops() * logits_rows)

    def _layer_kv_bytes(self) -> int:
        return 2 * self.n_kv_heads * self.head_dim * self.dtype_bytes

    def decode_attention_work(self, position: int) -> tuple:
        """(bytes, flops) of one decode row at ``position``: the K and V of
        the keys it attends read once in every layer (a sliding layer's
        window alone), its q read and its output written."""
        context = position + 1
        q_out = self.n_layers * 2 * self.n_heads * self.head_dim * self.dtype_bytes
        return (self._layer_kv_bytes() * self._layer_keys(context) + q_out,
                self.attention_flops(context))

    def resume_attention_work(self, start: int, n: int) -> tuple:
        """(bytes, flops) of a resumed suffix: ``n`` rows from ``start`` that
        attend the loaded prefix and themselves (causal, sliding layers
        within their window). Each layer reads the K and V of the keys any
        of its rows attends once, the rows' q read and outputs written
        once."""
        end = start + n
        read = self.n_full * end + self.n_sliding * (end - max(0, start + 1 - self.window))
        q_out = self.n_layers * 2 * self.n_heads * self.head_dim * self.dtype_bytes * n
        return (self._layer_kv_bytes() * read + q_out,
                4.0 * self.n_heads * self.head_dim * self._keys(start, n))

    def expert_bytes(self) -> int:
        """One routed expert's weights: gate, up and down."""
        return 3 * self.dim * self.expert_ffn * self.dtype_bytes

    def moe_expert_work(self, expert_reads: float, token_pairs: float) -> tuple:
        """(bytes, flops) of the routed experts' grouped GEMMs over launches
        that read ``expert_reads`` (layer, expert) weight sets and computed
        ``token_pairs`` (token, expert) pairs: each set's weights once, each
        pair's rows in and out of both projections (dim in, 2 x ffn out;
        ffn in, dim out), and 6 x dim x ffn operations a pair."""
        row_bytes = (2 * self.dim + 3 * self.expert_ffn) * self.dtype_bytes
        return (expert_reads * self.expert_bytes() + token_pairs * row_bytes,
                6.0 * self.dim * self.expert_ffn * token_pairs)


def shapes(cfg: dict) -> Shapes:
    """From a configuration file's published keys (``configs/*.json``)."""
    return Shapes(
        dim=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["head_dim"],
        ffn_dim=cfg["intermediate_size"],
        expert_ffn=cfg["moe_intermediate_size"],
        n_experts=cfg["num_experts"],
        top_k=cfg["num_experts_per_tok"],
        n_shared=cfg["num_shared_experts"],
        n_dense=cfg["num_dense_layers"],
        window=cfg["sliding_window"],
        layer_types=tuple(cfg["layer_types"]),
        vocab=cfg["vocab_size"],
        block_tokens=cfg["block_tokens"],
        dtype_bytes={"bfloat16": 2, "float32": 4}[cfg["torch_dtype"]],
    )


def _check(cfg: dict) -> None:
    """The published keys this module's equations take as given."""
    want = {"score_func": "sigmoid", "n_group": 1, "topk_group": 1, "hidden_act": "silu",
            "mup_enabled": True, "tie_word_embeddings": False}
    for key, value in want.items():
        if cfg.get(key) != value:
            raise ValueError(f"afmoe: {key} = {cfg.get(key)!r}; this module computes {value!r}")


# The RoutingLog of the last program configuration made here: the run's
# check (``reference``) takes the program's expert choices from it.
_LOG = None

# The reference takes the program's routed experts for a (row, layer) where
# its own choice is within this much of the program's: the program's set is
# a top-k of the reference's scores + bias once each is moved by at most half
# of it (``reference/afmoe.py``: near-ties). Measured on the H100 at the
# cell's size (four seeds, 1.9 M routed pairs): where the program's choice
# differed, the reference's scores put it at most 0.0056-0.0090 below the
# best left out at the first routed layer (bf16 through two dense layers)
# and at most 0.0183-0.0206 at the deepest (one pair of 46,528 past 0.02);
# each planted routing fault (the bias left out of the choice, the top k one
# rank down, route_scale left out) reads a gap above 1 under it. A distance
# past it refuses that pair alone: at 0.01 a run refused about a thousand
# and still read under the limit.
NEAR_TIE = 0.02


def program(cfg: dict, device=None):
    """The port's model configuration (``LlamaConfig``'s AFMoE fields), with
    a fresh ``RoutingLog`` for the run's check."""
    global _LOG
    from infinistore_tpu_torch.engine import RoutingLog
    from infinistore_tpu_torch.models.llama import LlamaConfig

    _check(cfg)
    _LOG = RoutingLog()
    return LlamaConfig(
        vocab=cfg["vocab_size"], dim=cfg["hidden_size"], n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
        ffn_dim=cfg["intermediate_size"], n_experts=cfg["num_experts"],
        block_tokens=cfg["block_tokens"], rope_theta=float(cfg["rope_theta"]),
        dtype=weights.DTYPES[cfg["torch_dtype"]], head_size=cfg["head_dim"],
        norm_eps=float(cfg["rms_norm_eps"]), layer_types=tuple(cfg["layer_types"]),
        sliding_window=cfg["sliding_window"], rope_sliding_only=True, qk_norm=True,
        attn_gate=True, sandwich_norm=True, embed_scale=math.sqrt(cfg["hidden_size"]),
        moe_top_k=cfg["num_experts_per_tok"], moe_ffn_dim=cfg["moe_intermediate_size"],
        n_shared_experts=cfg["num_shared_experts"], n_dense_layers=cfg["num_dense_layers"],
        route_scale=float(cfg["route_scale"]), route_norm=bool(cfg["route_norm"]),
        routing_log=_LOG,
    )


def _layer_layout(s: Shapes, index: int) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, std) of layer ``index``'s tensors, in draw order."""
    hd, q = s.head_dim, s.n_heads * s.head_dim
    layout = [
        ("attn_norm", (s.dim,), 0.1),
        ("wq", (s.dim, s.n_heads, hd), s.dim ** -0.5),
        ("wk", (s.dim, s.n_kv_heads, hd), s.dim ** -0.5),
        ("wv", (s.dim, s.n_kv_heads, hd), s.dim ** -0.5),
        ("q_norm", (hd,), 0.1),
        ("k_norm", (hd,), 0.1),
        ("w_attn_gate", (s.dim, s.n_heads, hd), s.dim ** -0.5),
        ("wo", (s.n_heads, hd, s.dim), q ** -0.5),
        ("post_attn_norm", (s.dim,), 0.1),
        ("ffn_norm", (s.dim,), 0.1),
        ("post_ffn_norm", (s.dim,), 0.1),
    ]
    if index < s.n_dense:
        return layout + [
            ("w_gate_up", (s.dim, 2, s.ffn_dim), s.dim ** -0.5),
            ("w_down", (s.ffn_dim, s.dim), s.ffn_dim ** -0.5),
        ]
    f, fs = s.expert_ffn, s.n_shared * s.expert_ffn
    return layout + [
        ("router", (s.dim, s.n_experts), s.dim ** -0.5),
        ("expert_bias", (s.n_experts,), 0.01),
        ("w_gate_up_moe", (s.n_experts, s.dim, 2, f), s.dim ** -0.5),
        ("w_down_moe", (s.n_experts, f, s.dim), f ** -0.5),
        ("w_gate_up_shared", (s.dim, 2, fs), s.dim ** -0.5),
        ("w_down_shared", (fs, s.dim), fs ** -0.5),
    ]


def layer(s: Shapes, seed: int, index: int, device, dtype) -> Dict[str, torch.Tensor]:
    """Layer ``index``'s tensors, keyed by their names within the layer."""
    return weights._draw(_layer_layout(s, index), seed, index, device, dtype)


def outer(s: Shapes, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The embedding, the final norm and the output head."""
    layout = [
        ("embed", (s.vocab, s.dim), s.dim ** -0.5),
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
    """The plain float32 reference (``reference/afmoe.py``), its weights
    remade from the seed in ``weight_dtype``; ``quant="fp8"`` is the
    control. Both take the last program's expert choices at their near-ties
    (``NEAR_TIE``), where that program recorded them."""
    from ..reference.afmoe import Reference

    _check(cfg)
    choices = _LOG.lookup if _LOG is not None else None
    return Reference(shapes(cfg), cfg, seed, device, weight_dtype=weight_dtype, quant=quant,
                     program_choices=choices, near_tie=NEAR_TIE)
