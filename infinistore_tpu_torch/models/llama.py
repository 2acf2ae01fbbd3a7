"""Small Llama-style transformer with a paged KV cache, in PyTorch (port of
``infinistore_tpu/models/llama.py``: the paged-inference path and the
training step).

GQA attention, RoPE (rotate-half), RMSNorm, SwiGLU; the KV cache uses the
paged layout of ``cuda/paged.py`` ([num_blocks, block_tokens, n_kv_heads,
head_dim] per layer), so prefill output streams to the store with
``LayerwiseKVWriter`` and decode resumes from fetched blocks. Parameters are
a flat dict of tensors with the JAX package's names and shapes, so the same
weights run in both packages (``params_from_numpy``).

The model math is the JAX package's: RMSNorm epsilon 1e-6, the same cast
order, f32 softmax statistics. Attention runs the hand-written kernels on
CUDA (K4 flash prefill, K3 paged decode, K6 ragged wave decode; K2 writes
prefill's K/V into the cache) and their plain versions on CPU. Projections are plain matmuls.

``LlamaConfig``'s later fields widen the block to the AFMoE family
(Trinity-Mini, Hugging Face ``AfmoeForCausalLM``); each defaults to the
block above, bit for bit. Per layer, with a = RMSNorm_in(h):

- an explicit ``head_size`` (q may be wider than the hidden size), the
  RMSNorm epsilon ``norm_eps``;
- ``layer_types`` / ``sliding_window``: a sliding layer's rows attend their
  last ``sliding_window`` keys (K3, K4 and K6 skip what lies before);
  ``rope_sliding_only``: RoPE on sliding layers, none on full ones;
- ``qk_norm``: RMSNorm over each head of q and k before RoPE;
  ``attn_gate``: o = o * sigmoid(a W_gate) before the output projection;
  ``sandwich_norm``: h = h + RMSNorm_post(o W_o), and the same after the FFN;
  ``embed_scale``: the embedding times a constant (sqrt(hidden) for muP);
- ``moe_top_k`` > 0 with ``n_experts``: after ``n_dense_layers`` dense
  layers, a routed mixture: router scores sigmoid(m W_router) in f32, the
  top k of scores + ``expert_bias`` chosen (the bias moves the choice only),
  weights the chosen scores over their sum (``route_norm``) times
  ``route_scale``; each chosen expert's SwiGLU of width ``moe_ffn_dim`` runs
  in the grouped GEMM (``cuda/moe.py``), and ``n_shared_experts`` shared
  experts are always added.

The forward entry points take an optional ``counts`` (``LaunchCounts``):
device-side counters of the launch's routed experts and skipped keys, which
the engine brings to the host with the copy it already makes.

Numerics on CUDA (``_set_numerics``): f32 matmuls at full f32 precision —
TF32 off for matmuls and cuDNN, the counterpart of ``Precision.HIGHEST`` —
and bf16 GEMMs accumulate in f32 without reduced-precision reductions.

The caches are updated IN PLACE; the functions return the same tensors in
the JAX package's ``(logits, caches)`` shape.

Training (``loss_fn``, ``train_step``) differentiates with ``torch.autograd``
through the dense ``_attention`` (an explicit causal mask): no kernel runs,
as the JAX package trains through its XLA path. ``train_step`` updates the
parameters in place.
"""

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..cuda import _ext
from ..cuda.flash_prefill import flash_prefill_attention
from ..cuda.moe import grouped_gemm
from ..cuda.paged import PagedKVCacheSpec, scatter_blocks_many
from ..cuda.paged_attention import paged_decode_attention_batched, paged_decode_attention_rows

Params = Dict[str, torch.Tensor]
Caches = List[Tuple[torch.Tensor, torch.Tensor]]


def _set_numerics() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


@dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 512
    dim: int = 128
    n_layers: int = 2
    n_heads: int = 8
    n_kv_heads: int = 4
    ffn_dim: int = 256
    # > 0 switches every FFN to the JAX package's dense soft mixture of
    # experts: a router's softmax gates weight every expert for every token
    # (not top-k), with expert-major weights [n_experts, ...].
    n_experts: int = 0
    block_tokens: int = 8
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # The AFMoE widening (module docstring); every default keeps the block
    # above. Attention head width (0: dim // n_heads).
    head_size: int = 0
    norm_eps: float = 1e-6
    # Per layer "sliding_attention" or "full_attention" (empty: all full).
    layer_types: Tuple[str, ...] = ()
    sliding_window: int = 0
    rope_sliding_only: bool = False
    qk_norm: bool = False
    attn_gate: bool = False
    sandwich_norm: bool = False
    embed_scale: float = 1.0
    # Top-k routed mixture (with n_experts > 0); 0 keeps the soft mixture.
    moe_top_k: int = 0
    moe_ffn_dim: int = 0
    n_shared_experts: int = 0
    n_dense_layers: int = 0
    route_scale: float = 1.0
    route_norm: bool = True
    # Where the engine records each computed token's routed experts
    # (``engine.RoutingLog``), or None; it is no part of the model.
    routing_log: Any = field(default=None, compare=False, repr=False)

    @property
    def head_dim(self) -> int:
        return self.head_size or self.dim // self.n_heads

    def layer_window(self, layer: int) -> int:
        """The sliding window of ``layer``'s attention (0: full)."""
        if self.layer_types and self.layer_types[layer] == "sliding_attention":
            return self.sliding_window
        return 0

    def layer_rope(self, layer: int) -> bool:
        return not self.rope_sliding_only or self.layer_window(layer) > 0

    def ffn_kind(self, layer: int) -> str:
        """``dense`` SwiGLU, the ``soft`` mixture or the ``topk`` routed one."""
        if self.n_experts <= 0:
            return "dense"
        if self.moe_top_k <= 0:
            return "soft"
        return "dense" if layer < self.n_dense_layers else "topk"

    @property
    def counts_launches(self) -> bool:
        """Whether a launch has routed experts or windows to count."""
        return (self.n_experts > 0 and self.moe_top_k > 0) or (
            self.sliding_window > 0 and "sliding_attention" in self.layer_types)

    def kv_spec(self, num_blocks: int) -> PagedKVCacheSpec:
        """Paged-KV cache spec matching this model's layers/heads/dtype."""
        return PagedKVCacheSpec(
            num_layers=self.n_layers,
            num_blocks=num_blocks,
            block_tokens=self.block_tokens,
            num_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
            dtype=self.dtype,
        )


def _param_shapes(config: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    hd = config.head_dim
    shapes = {
        "embed": (config.vocab, config.dim),
        "final_norm": (config.dim,),
        "lm_head": (config.dim, config.vocab),
    }
    for layer in range(config.n_layers):
        pre = f"l{layer}."
        shapes[pre + "attn_norm"] = (config.dim,)
        shapes[pre + "wq"] = (config.dim, config.n_heads, hd)
        shapes[pre + "wk"] = (config.dim, config.n_kv_heads, hd)
        shapes[pre + "wv"] = (config.dim, config.n_kv_heads, hd)
        shapes[pre + "wo"] = (config.n_heads, hd, config.dim)
        if config.qk_norm:
            shapes[pre + "q_norm"] = (hd,)
            shapes[pre + "k_norm"] = (hd,)
        if config.attn_gate:
            shapes[pre + "w_attn_gate"] = (config.dim, config.n_heads, hd)
        if config.sandwich_norm:
            shapes[pre + "post_attn_norm"] = (config.dim,)
            shapes[pre + "post_ffn_norm"] = (config.dim,)
        shapes[pre + "ffn_norm"] = (config.dim,)
        kind = config.ffn_kind(layer)
        if kind == "soft":
            e = config.n_experts
            shapes[pre + "router"] = (config.dim, e)
            shapes[pre + "w_gate_up_moe"] = (e, config.dim, 2, config.ffn_dim)
            shapes[pre + "w_down_moe"] = (e, config.ffn_dim, config.dim)
        elif kind == "topk":
            e, f = config.n_experts, config.moe_ffn_dim
            shapes[pre + "router"] = (config.dim, e)
            shapes[pre + "expert_bias"] = (e,)
            shapes[pre + "w_gate_up_moe"] = (e, config.dim, 2, f)
            shapes[pre + "w_down_moe"] = (e, f, config.dim)
            if config.n_shared_experts:
                fs = config.n_shared_experts * f
                shapes[pre + "w_gate_up_shared"] = (config.dim, 2, fs)
                shapes[pre + "w_down_shared"] = (fs, config.dim)
        else:
            shapes[pre + "w_gate_up"] = (config.dim, 2, config.ffn_dim)
            shapes[pre + "w_down"] = (config.ffn_dim, config.dim)
    return shapes


def init_params(config: LlamaConfig, generator: torch.Generator, device="cuda") -> Params:
    """He-scaled params as a flat dict (layer-prefixed keys), drawn from
    ``generator`` on its own device and placed on ``device``. Norm weights
    are ones; an MoE config has ``router`` / ``w_gate_up_moe`` /
    ``w_down_moe`` in place of each layer's dense FFN weights."""
    dev = _ext.resolve_device(device)
    _set_numerics()
    p: Params = {}
    for name, shape in _param_shapes(config).items():
        if name.endswith("norm"):
            p[name] = torch.ones(shape, dtype=config.dtype, device=dev)
            continue
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        p[name] = (w * (1.0 / math.sqrt(shape[0]))).to(device=dev, dtype=config.dtype)
    return p


def params_from_numpy(np_params, config: LlamaConfig, device="cuda") -> Params:
    """Carry parameters across from numpy (e.g. the JAX package's
    ``init_params`` output through ``np.asarray``). bfloat16 arrays arrive as
    ``ml_dtypes.bfloat16`` and are reinterpreted bit for bit."""
    dev = _ext.resolve_device(device)
    _set_numerics()
    want = _param_shapes(config)
    if set(np_params) != set(want):
        raise ValueError(f"parameter names differ: {sorted(set(np_params) ^ set(want))}")
    out: Params = {}
    for name, arr in np_params.items():
        arr = np.ascontiguousarray(np.asarray(arr))
        if tuple(arr.shape) != want[name]:
            raise ValueError(f"{name}: shape {arr.shape}, expected {want[name]}")
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr.copy())
        out[name] = t.to(device=dev, dtype=config.dtype)
    return out


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # Variance and rsqrt in f32; the factor is cast to x's dtype BEFORE the
    # multiply, as in the JAX package.
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE. x: [..., seq, heads, head_dim], positions: [..., seq]."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    angles = positions[..., :, None].float() * freqs  # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, KVH, D]
    v: torch.Tensor,  # [B, T, KVH, D]
    mask: torch.Tensor,  # [B, S, T] True = attend
) -> torch.Tensor:
    """Dense attention with the framework-wide numeric contract: logits and
    softmax statistics in float32 (bf16 operands widened, so products are
    exact and sums f32), output cast back to the query dtype."""
    groups = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(groups, dim=2)
    v = v.repeat_interleave(groups, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    logits = logits.masked_fill(~mask[:, None, :, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)


class LaunchCounts:
    """Counters of one forward launch, kept on the device: per routed-expert
    layer the distinct experts whose weights it read, the (token, expert)
    pairs it computed and the most rows one expert took, and per sliding
    layer the keys its window skipped. ``real`` ([rows] 0/1, or None for
    every row) leaves a wave's tail padding out of the counts. ``total()``:
    one int64 [4] tensor (expert reads and pairs summed over the layers, the
    largest expert's rows, keys skipped), built with no read back, so a
    CUDA graph can capture it. With ``choices``, each routed layer's [rows,
    k] expert ids are kept too (``choice_rows()``: [rows, layers, k]
    int16)."""

    FIELDS = ("moe_expert_reads", "moe_token_pairs", "moe_max_expert_rows",
              "window_keys_skipped")

    def __init__(self, real: Optional[torch.Tensor] = None, choices: bool = False):
        self.real = real
        self.moe: List[torch.Tensor] = []
        self.skipped: List[torch.Tensor] = []
        self.choices: Optional[List[torch.Tensor]] = [] if choices else None

    def add_moe(self, choice: torch.Tensor, n_experts: int) -> None:
        """``choice`` [rows, k]: the experts each row chose."""
        ones = (torch.ones_like(choice) if self.real is None
                else self.real.to(choice.dtype)[:, None].expand_as(choice))
        rows = torch.zeros(n_experts, dtype=torch.int64, device=choice.device).scatter_add_(
            0, choice.reshape(-1), ones.reshape(-1).to(torch.int64))
        self.moe.append(torch.stack([(rows > 0).sum(), rows.sum(), rows.max()]))
        if self.choices is not None:
            self.choices.append(choice.to(torch.int16))

    def choice_rows(self) -> torch.Tensor:
        return torch.stack(self.choices, dim=1)

    def add_window(self, seq_lens: torch.Tensor, window: int) -> None:
        """``seq_lens`` [rows]: each row's keys before its window's cut."""
        cut = (seq_lens.to(torch.int64) - window).clamp(min=0)
        if self.real is not None:
            cut = cut * self.real.to(torch.int64)
        self.skipped.append(cut.sum())

    def total(self) -> torch.Tensor:
        parts = self.moe + self.skipped
        if not parts:
            return torch.zeros(4, dtype=torch.int64)
        zero = torch.zeros((), dtype=torch.int64, device=parts[0].device)
        if self.moe:
            moe = torch.stack(self.moe)
            reads, pairs, most = moe[:, 0].sum(), moe[:, 1].sum(), moe[:, 2].max()
        else:
            reads = pairs = most = zero
        skipped = torch.stack(self.skipped).sum() if self.skipped else zero
        return torch.stack([reads, pairs, most, skipped])


def _real_rows(positions: torch.Tensor, row_of: torch.Tensor) -> torch.Tensor:
    """1 for a ragged wave's rows, 0 for its tail padding (a repeat of the
    row before it: same request, same position), on the device."""
    real = torch.ones_like(positions, dtype=torch.int64)
    real[1:] = ((positions[1:] != positions[:-1]) | (row_of[1:] != row_of[:-1])).to(torch.int64)
    return real


def _block(params: Params, layer: int, x, k, v, q_positions, mask, config, counts=None):
    """Shared transformer block math given already-materialised K/V context.

    x: [B, S, dim]; k/v: [B, T, KVH, D]. ``mask`` is [B, S, T] (True =
    attend), or None for plain causal — the None form runs the flash
    prefill path (no S x T logits; K4 has no backward, so training passes
    an explicit mask and keeps the dense, differentiable ``_attention``)."""
    return _ffn(params, layer,
                _attend(params, layer, x, k, v, q_positions, mask, config, counts), config,
                counts)


def _attend(params: Params, layer: int, x, k, v, q_positions, mask, config, counts=None):
    """Attention half of the block with its residual (``_block`` less the
    FFN; the expert-parallel step puts its own FFN after it). A sliding
    layer's keys are those of its window (K4's ``window``, or the explicit
    mask narrowed, keys at positions 0 .. T - 1)."""
    q = _q_proj(params, layer, x, q_positions, config)
    window = config.layer_window(layer)
    if mask is None:
        attn = flash_prefill_attention(q, k, v, causal=True, window=window)
        if window and counts is not None:
            counts.add_window(q_positions.reshape(-1) + 1, window)
    else:
        if window:
            keys = torch.arange(k.shape[1], device=mask.device)
            mask = mask & (keys[None, None, :] > q_positions[..., None] - window)
        attn = _attention(q, k, v, mask)
    return _attn_residual(params, layer, x, attn.flatten(-2), config)


def _attn_residual(params: Params, layer: int, x, attn, config):
    """x + the attention's output projection (attn [..., H * D]): gated by
    sigmoid(a W_gate) first (``attn_gate``, a = RMSNorm_in(x)), and
    RMSNorm'd after (``sandwich_norm``)."""
    pre = f"l{layer}."
    if config.attn_gate:
        h = _rms_norm(x, params[pre + "attn_norm"], config.norm_eps)
        attn = attn * torch.sigmoid(h @ params[pre + "w_attn_gate"].reshape(config.dim, -1))
    out = attn @ params[pre + "wo"].reshape(-1, config.dim)
    if config.sandwich_norm:
        out = _rms_norm(out, params[pre + "post_attn_norm"], config.norm_eps)
    return x + out


def _swiglu(h, w_gate_up, w_down):
    """down(silu(gate(h)) * up(h)) with ``w_gate_up`` [dim, 2, F]."""
    gate_up = (h @ w_gate_up.reshape(w_gate_up.shape[0], -1)).unflatten(
        -1, (2, w_gate_up.shape[-1])
    )
    ffn = F.silu(gate_up[..., 0, :]) * gate_up[..., 1, :]
    return ffn @ w_down


def _ffn(params: Params, layer: int, x, config, counts=None):
    """FFN half of the block: dense SwiGLU, the soft mixture of experts
    (``n_experts > 0``) or the routed top-k one (``moe_top_k > 0``, past the
    ``n_dense_layers``), RMSNorm'd after with ``sandwich_norm``."""
    pre = f"l{layer}."
    h = _rms_norm(x, params[pre + "ffn_norm"], config.norm_eps)
    kind = config.ffn_kind(layer)
    if kind == "soft":
        return x + _moe(params, pre, h, config)
    if kind == "topk":
        out = _moe_topk(params, pre, h, config, counts)
    else:
        out = _swiglu(h, params[pre + "w_gate_up"], params[pre + "w_down"])
    if config.sandwich_norm:
        out = _rms_norm(out, params[pre + "post_ffn_norm"], config.norm_eps)
    return x + out


def route(h2, router, expert_bias, config):
    """The routed mixture's choice and weights for [N, dim] rows: scores
    sigmoid(h2 W_router) in f32; the top ``moe_top_k`` of scores +
    ``expert_bias`` chosen ([N, k] expert ids, in the order topk gives);
    their weights the bare scores, over their sum plus 1e-20 with
    ``route_norm``, times ``route_scale`` ([N, k] f32)."""
    scores = torch.sigmoid(h2.float() @ router.float())
    choice = torch.topk(scores + expert_bias.float(), config.moe_top_k, dim=-1).indices
    weights = scores.gather(-1, choice)
    if config.route_norm:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return choice, weights * config.route_scale


def routed_experts(h2, choice, weights, w_gate_up, w_down):
    """sum_j weights[:, j] * SwiGLU_{choice[:, j]}(h2) in f32 ([N, dim]):
    the (row, expert) pairs sorted by expert (a stable sort), one grouped
    GEMM for every pair's gate and up (``w_gate_up`` [E, dim, 2, F]) and one
    for its down (``w_down`` [E, F, dim]), with the experts' row ends
    computed and kept on the device; each row's k outputs weighted and
    summed in f32 in choice order."""
    n, k = choice.shape
    e, dim, _, f = w_gate_up.shape
    flat = choice.reshape(-1)
    order = torch.argsort(flat, stable=True)
    rows = torch.zeros(e, dtype=torch.int64, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    ends = torch.cumsum(rows, 0).to(torch.int32)
    gate_up = grouped_gemm(h2[order // k], w_gate_up.reshape(e, dim, 2 * f), ends)
    y = grouped_gemm(F.silu(gate_up[:, :f]) * gate_up[:, f:], w_down, ends)
    out = torch.empty_like(y).index_copy_(0, order, y)
    return (out.view(n, k, -1).float() * weights[..., None]).sum(dim=1)


def _moe_topk(params: Params, pre: str, h, config, counts=None):
    """The routed mixture of one layer (``route``, ``routed_experts``) plus
    its shared experts, summed in f32 and cast once to h's dtype."""
    lead = h.shape[:-1]
    h2 = h.reshape(-1, config.dim)
    choice, weights = route(h2, params[pre + "router"], params[pre + "expert_bias"], config)
    out = routed_experts(h2, choice, weights, params[pre + "w_gate_up_moe"],
                         params[pre + "w_down_moe"])
    if counts is not None:
        counts.add_moe(choice, config.n_experts)
    if config.n_shared_experts:
        out = out + _swiglu(h2, params[pre + "w_gate_up_shared"],
                            params[pre + "w_down_shared"]).float()
    return out.to(h.dtype).reshape(*lead, config.dim)


def _moe(params: Params, pre: str, h, config):
    """The JAX package's dense soft mixture: router logits in f32, softmax,
    gates cast to the activation dtype, then every expert for every token
    (``_expert_sum``)."""
    lead = h.shape[:-1]
    h2 = h.reshape(-1, config.dim)  # [N, dim]
    gates = torch.softmax((h2 @ params[pre + "router"]).float(), dim=-1).to(h.dtype)  # [N, E]
    out = _expert_sum(h2, gates, params[pre + "w_gate_up_moe"], params[pre + "w_down_moe"])
    return out.reshape(*lead, config.dim)


def _expert_sum(h2, gates, w_gate_up, w_down):
    """``sum_e gates[:, e] * SwiGLU_e(h2) @ w_down[e]`` over the experts and
    ffn columns the weights hold: ``w_gate_up`` [E, dim, 2, F], ``w_down``
    [E, F, dim], ``gates`` [N, E]; [N, dim] out.

    The reference's three-operand contraction ``bse,bsef,efd->bsd`` runs in
    one fixed order: the gates scale each expert's SwiGLU output first
    (elementwise, in the activation dtype), then one GEMM contracts the
    joint (expert, ffn) axis against ``w_down`` viewed as ``[E * F, dim]``,
    so each output sums over all experts in one f32 accumulation. The
    expert-parallel step runs the same function on each rank's slice."""
    e, dim, _, f = w_gate_up.shape
    # One batched GEMM over the experts' [dim, 2 * F] weights: [E, N, 2 * F].
    gate_up = h2[None] @ w_gate_up.reshape(e, dim, 2 * f)
    ffn = F.silu(gate_up[..., :f]) * gate_up[..., f:]  # [E, N, F]
    weighted = (ffn * gates.t()[..., None]).permute(1, 0, 2).reshape(-1, e * f)  # [N, E * F]
    return weighted @ w_down.reshape(e * f, w_down.shape[-1])


def _q_proj(params: Params, layer: int, x, positions, config):
    pre = f"l{layer}."
    h = _rms_norm(x, params[pre + "attn_norm"], config.norm_eps)
    q = (h @ params[pre + "wq"].reshape(config.dim, -1)).unflatten(
        -1, (config.n_heads, config.head_dim)
    )
    if config.qk_norm:
        q = _rms_norm(q, params[pre + "q_norm"], config.norm_eps)
    return _rope(q, positions, config.rope_theta) if config.layer_rope(layer) else q


def _kv_proj(params: Params, layer: int, x, positions, config):
    pre = f"l{layer}."
    h = _rms_norm(x, params[pre + "attn_norm"], config.norm_eps)
    kv_shape = (config.n_kv_heads, config.head_dim)
    k = (h @ params[pre + "wk"].reshape(config.dim, -1)).unflatten(-1, kv_shape)
    v = (h @ params[pre + "wv"].reshape(config.dim, -1)).unflatten(-1, kv_shape)
    if config.qk_norm:
        k = _rms_norm(k, params[pre + "k_norm"], config.norm_eps)
    if config.layer_rope(layer):
        k = _rope(k, positions, config.rope_theta)
    return k, v


def _on(params: Params, x, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=params["embed"].device)


# ---------------------------------------------------------------------------
# Paged-cache inference. The cache is shared across sequences via the block
# table: the paged-attention model the store serves.
# ---------------------------------------------------------------------------


def prefill(
    params: Params,
    tokens,  # [S] int, S % block_tokens == 0
    caches: Caches,  # per layer (K, V) paged tensors, updated in place
    block_table,  # [S // block_tokens] int cache block ids
    config: LlamaConfig,
    counts: Optional[LaunchCounts] = None,
) -> Tuple[torch.Tensor, Caches]:
    """Full prompt pass; writes K/V into the paged cache blocks listed in
    block_table. Returns (last-token logits [vocab], caches).

    The chain of the layer entry points: ``embed_prompt``, ``prefill_layer``
    for each layer, ``lm_logits`` over the last row only (the only row whose
    logits are returned), so a streamed prefill (``disagg.stream_prefill``)
    writes the same bytes and its logits are this function's bit for bit."""
    _set_numerics()
    tokens = _on(params, tokens, torch.long)
    block_table = _on(params, block_table, torch.int32)
    s = tokens.shape[0]
    bt = config.block_tokens
    if s % bt or block_table.shape != (s // bt,):
        raise ValueError(
            f"prefill needs S % block_tokens == 0 and one table entry per block "
            f"(S={s}, block_tokens={bt}, table {tuple(block_table.shape)})"
        )
    x = embed_prompt(params, tokens, config)  # [1, S, dim]
    new_caches: Caches = []
    for layer, (k_cache, v_cache) in enumerate(caches):
        x, k_cache, v_cache = prefill_layer(params, x, k_cache, v_cache, block_table,
                                            config, layer, counts=counts)
        new_caches.append((k_cache, v_cache))
    return lm_logits(params, x[:, -1:], config)[0, -1], new_caches


def decode_step(
    params: Params,
    token,  # [] int
    position,  # [] int absolute position of `token`
    caches: Caches,
    block_table,  # [max_blocks] int (padded with any valid id)
    config: LlamaConfig,
    max_blocks: int,
) -> Tuple[torch.Tensor, Caches]:
    """One decode token against the paged cache (the B=1 wrapper over
    ``decode_step_batched``). ``max_blocks`` must equal the padded
    block_table length. Returns (logits [vocab], caches)."""
    block_table = _on(params, block_table, torch.int32)
    if block_table.shape[0] != max_blocks:
        raise ValueError(
            f"block_table has {block_table.shape[0]} entries, expected "
            f"max_blocks={max_blocks} (pad the table to the static bound)"
        )
    logits, new_caches = decode_step_batched(
        params,
        _on(params, token, torch.long).reshape(1),
        _on(params, position, torch.int32).reshape(1),
        caches,
        block_table[None],
        config,
        max_blocks,
    )
    return logits[0], new_caches


def verify_step_batched(
    params: Params,
    tokens,  # [B, K] int, one token chunk per live request
    positions,  # [B, K] int absolute position of each token
    caches: Caches,  # SHARED paged cache across the wave
    block_tables,  # [B, max_blocks] int (rows padded)
    config: LlamaConfig,
    max_blocks: int,
    counts: Optional[LaunchCounts] = None,
) -> Tuple[torch.Tensor, Caches]:
    """THE paged-inference body: a wave of B requests each advancing a
    K-token chunk against the shared cache in one launch per layer.

    Each row inserts its K/V at (table[pos // bt], pos % bt), then one
    batched fused attention launch covers all B*K rows, each masked to its
    own position + 1. Requests own disjoint blocks; duplicate rows within a
    request write identical bytes. The chain of ``embed_wave``,
    ``decode_wave_layer`` for each layer and ``lm_logits``, the functions the
    disaggregated decode (``disagg``) runs layer by layer. Returns ([B, K,
    vocab] logits, caches)."""
    _set_numerics()
    tokens = _on(params, tokens, torch.long)
    positions = _on(params, positions, torch.int32)
    block_tables = _on(params, block_tables, torch.int32)
    if tuple(positions.shape) != tuple(tokens.shape):
        raise ValueError(
            f"positions must match tokens' {list(tokens.shape)}, got {tuple(positions.shape)}"
        )
    x = embed_wave(params, tokens, config)  # [B, K, dim]
    index = wave_index(positions, block_tables, config, max_blocks)
    new_caches: Caches = []
    for layer, (k_cache, v_cache) in enumerate(caches):
        x, k_cache, v_cache = decode_wave_layer(
            params, x, positions, k_cache, v_cache, block_tables, config, layer, max_blocks,
            index=index, counts=counts,
        )
        new_caches.append((k_cache, v_cache))
    return lm_logits(params, x, config), new_caches


def decode_step_batched(
    params: Params,
    tokens,  # [B] int, one next-token per live request
    positions,  # [B] int absolute position of each token
    caches: Caches,  # SHARED paged cache across the wave
    block_tables,  # [B, max_blocks] int (rows padded)
    config: LlamaConfig,
    max_blocks: int,
) -> Tuple[torch.Tensor, Caches]:
    """One decode step for a WAVE of requests sharing the paged cache (every
    live request advances one token). The K=1 view of
    ``verify_step_batched``. Returns ([B, vocab] logits, caches)."""
    logits, new_caches = verify_step_batched(
        params,
        _on(params, tokens, torch.long)[:, None],
        _on(params, positions, torch.int32)[:, None],
        caches,
        block_tables,
        config,
        max_blocks,
    )
    return logits[:, 0], new_caches


def verify_step_ragged(
    params: Params,
    tokens,  # [T] int, the wave's chunks concatenated row-major
    positions,  # [T] int absolute position of each flat token
    row_of,  # [T] int owning request per flat token (sorted)
    pages,  # [P] int flat attention page list (RaggedWaveMeta)
    page_rows,  # [P + 1] int owning flat token per page
    page_starts,  # [T] int first page per flat token
    caches: Caches,  # SHARED paged cache across the wave
    block_tables,  # [B, max_blocks] int (rows padded)
    config: LlamaConfig,
    max_blocks: int,
    counts: Optional[LaunchCounts] = None,
) -> Tuple[torch.Tensor, Caches]:
    """The ragged form of ``verify_step_batched``: a mixed wave whose request
    chunks keep their own lengths, as one flat [T] token list with per-token
    request and page metadata instead of a [B, K] rectangle.

    Each flat token inserts its K/V at (table[pos // bt], pos % bt) and
    attends its own prefix masked to pos + 1, so per-token semantics are
    ``verify_step_batched``'s. Tail padding repeats the last flat row (same
    bytes to the same slot); ``block_tables`` rows no flat token references
    neither scatter nor attend. Attention is one K6 launch per layer on CUDA
    over the flat page list. ``counts`` leaves the tail padding out.
    Returns ([T, vocab] logits, caches)."""
    _set_numerics()
    tokens = _on(params, tokens, torch.long)
    positions = _on(params, positions, torch.int32)
    row_of = _on(params, row_of, torch.long)
    pages, page_rows, page_starts = (
        _on(params, x, torch.int32) for x in (pages, page_rows, page_starts))
    block_tables = _on(params, block_tables, torch.int32)
    t = tokens.shape[0]
    if tuple(positions.shape) != (t,) or tuple(row_of.shape) != (t,):
        raise ValueError(
            f"positions/row_of must match tokens' [{t}], got "
            f"{tuple(positions.shape)}/{tuple(row_of.shape)}"
        )
    if tuple(page_starts.shape) != (t,):
        raise ValueError(f"page_starts must be [{t}], got {tuple(page_starts.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[1] != max_blocks:
        raise ValueError(
            f"block_tables must be [B, {max_blocks}], got {tuple(block_tables.shape)}"
        )
    bt = config.block_tokens
    x = embed_wave(params, tokens, config)[None]  # [1, T, dim]
    pos2d = positions[None]  # [1, T]
    if counts is not None and counts.real is None:
        counts.real = _real_rows(positions, row_of)

    row_tables = block_tables[row_of]  # [T, max_blocks]
    block_idx = torch.gather(row_tables, 1, (positions // bt).long()[:, None])[:, 0].long()
    slots = (positions % bt).long()
    seq_lens = positions + 1

    new_caches: Caches = []
    for layer, (k_cache, v_cache) in enumerate(caches):
        k, v = _kv_proj(params, layer, x, pos2d, config)  # [1, T, KVH, D]
        k_cache[block_idx, slots] = k[0].to(k_cache.dtype)
        v_cache[block_idx, slots] = v[0].to(v_cache.dtype)
        q = _q_proj(params, layer, x, pos2d, config)  # [1, T, H, D]
        window = config.layer_window(layer)
        attn = paged_decode_attention_rows(
            q[0].contiguous(), k_cache, v_cache, row_tables, seq_lens,
            pages, page_rows, page_starts, window=window,
        ).reshape(1, t, -1)  # [1, T, H*D]
        if window and counts is not None:
            counts.add_window(seq_lens, window)
        x = _attn_residual(params, layer, x, attn, config)
        x = _ffn(params, layer, x, config, counts)
        new_caches.append((k_cache, v_cache))
    return lm_logits(params, x, config)[0], new_caches


def prefill_continue(
    params: Params,
    tokens,  # [S_c] int, the suffix chunk
    start_pos,  # int, absolute position of tokens[0]
    caches: Caches,
    block_table,  # [max_blocks] int (padded)
    config: LlamaConfig,
    max_blocks: int,
    counts: Optional[LaunchCounts] = None,
) -> Tuple[torch.Tensor, Caches]:
    """Chunked continuation prefill: compute a multi-token suffix against an
    already-populated paged prefix in one call per layer (the engine's
    resume path after a prefix hit). The B=1 view of ``verify_step_batched``:
    every suffix row attends its own prefix in one K3 launch per layer on
    CUDA. Returns ([S_c, vocab] logits, caches)."""
    block_table = _on(params, block_table, torch.int32)
    if block_table.shape[0] != max_blocks:
        raise ValueError(
            f"block_table has {block_table.shape[0]} entries, expected "
            f"max_blocks={max_blocks} (pad the table to the static bound)"
        )
    tokens = _on(params, tokens, torch.long)
    positions = int(start_pos) + torch.arange(tokens.shape[0], dtype=torch.int32,
                                              device=tokens.device)
    logits, new_caches = verify_step_batched(
        params, tokens[None], positions[None], caches, block_table[None], config, max_blocks,
        counts=counts,
    )
    return logits[0], new_caches


def speculative_verify(
    params: Params,
    draft,  # [D] int draft tokens (draft[0] already validated by the caller
    #         against its previous step's logits)
    start_pos,  # int, absolute position of draft[0]
    caches: Caches,
    block_table,  # [max_blocks] int (padded)
    config: LlamaConfig,
    max_blocks: int,
    pad_to: int = 0,
):
    """Score a whole speculative draft in ONE chunked pass and accept its
    longest greedy-consistent prefix.

    ``prefill_continue`` processes all D draft tokens at once (each row
    attends its own prefix; K3 on CUDA); row i's argmax is the target
    model's next token after ``draft[:i+1]``, so ``draft[i+1]`` is accepted
    iff it equals that argmax. Returns ``(n_accepted, next_token, caches)``
    where ``next_token`` is the model's continuation after the accepted
    prefix, the token the engine emits beside the accepted draft.

    Rejected draft positions did write K/V into their slots, but every later
    decode masks attention at ``position + 1``, so those slots are never
    attended and are overwritten when real tokens reach them: the caller
    only rewinds its position counter.

    ``pad_to``: a fixed chunk length >= D for engines that keep one launch
    shape across rounds. The draft is padded with its last token (the pad
    rows' K/V land beyond the accepted point, like any rejection) and
    acceptance is computed over the true D only."""
    draft_host = np.asarray(draft, dtype=np.int32)
    d = int(draft_host.shape[0])
    if d == 0:
        raise ValueError("speculative_verify needs a non-empty draft")
    span = pad_to or d
    if int(start_pos) + span > max_blocks * config.block_tokens:
        # An out-of-table block index would write past the request's blocks.
        raise ValueError(
            f"draft span [{int(start_pos)}, {int(start_pos) + span}) exceeds "
            f"the table's {max_blocks * config.block_tokens}-token capacity"
        )
    if pad_to:
        if pad_to < d:
            raise ValueError(f"pad_to={pad_to} < draft length {d}")
        draft_host = np.concatenate(
            [draft_host, np.full(pad_to - d, draft_host[-1], np.int32)]
        )
    logits, caches = prefill_continue(
        params, draft_host, int(start_pos), caches, block_table, config, max_blocks,
    )
    # ONE device-to-host transfer per round: the [D] argmaxes; the draft
    # comparison stays on the host.
    preds = logits.argmax(dim=-1).cpu().numpy()  # preds[i] follows draft[:i+1]
    ok = preds[: d - 1] == draft_host[1:d]  # draft[i+1] consistent?
    n_accepted = 1 + int(np.argmin(ok)) if not ok.all() else d
    next_token = int(preds[n_accepted - 1])
    return n_accepted, next_token, caches


# ---------------------------------------------------------------------------
# Layerwise inference entry points (the disaggregated prefill -> decode
# handoff, ``disagg.py``). ``prefill`` and ``verify_step_batched`` are chains
# of these functions, so a prefill engine can ship layer l's KV while layer
# l + 1 computes and a decode engine can gate each layer's attention on that
# layer's install alone, with one copy of each layer's math: the streamed
# prefill, the fallback recompute and ``prefill`` write the same bytes, and
# the watermarked, blocking and whole-step decodes give the same logits.
# ---------------------------------------------------------------------------


def _embed(params: Params, tokens, config: Optional[LlamaConfig]) -> torch.Tensor:
    x = params["embed"][_on(params, tokens, torch.long)]
    if config is not None and config.embed_scale != 1.0:
        x = x * config.embed_scale
    return x


def embed_prompt(params: Params, tokens, config: Optional[LlamaConfig] = None) -> torch.Tensor:
    """[S] prompt tokens -> [1, S, dim] activations (the layerwise prefill
    chain's entry), times ``config.embed_scale``."""
    return _embed(params, tokens, config)[None]


def prefill_layer(
    params: Params,
    x: torch.Tensor,  # [1, S, dim] activations entering this layer
    k_cache: torch.Tensor,  # this layer's paged K tensor, updated in place
    v_cache: torch.Tensor,  # this layer's paged V tensor, updated in place
    block_table,  # [S // block_tokens] int cache block ids
    config: LlamaConfig,
    layer: int,
    counts: Optional[LaunchCounts] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer of the whole-prompt prefill: project this layer's K/V, run
    the block (K4 on CUDA) and scatter the K/V into the layer's cache blocks
    (K2, one launch for K and V). Returns ``(x_next, k_cache, v_cache)``:
    ``x_next`` feeds ``layer + 1`` while the caller ships the freshly
    scattered K/V."""
    _set_numerics()
    block_table = _on(params, block_table, torch.int32)
    s = x.shape[1]
    bt = config.block_tokens
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    k, v = _kv_proj(params, layer, x, positions, config)
    x = _block(params, layer, x, k, v, positions, None, config, counts)
    block = (s // bt, bt, config.n_kv_heads, config.head_dim)
    k_cache, v_cache = scatter_blocks_many(
        (k_cache, v_cache), block_table, (k[0].reshape(block), v[0].reshape(block)))
    return x, k_cache, v_cache


def lm_logits(params: Params, x: torch.Tensor,
              config: Optional[LlamaConfig] = None) -> torch.Tensor:
    """Final norm + LM head over [B, S, dim] activations (the layerwise
    chains' exit; [B, S, vocab] logits); the norm's epsilon is
    ``config.norm_eps`` (1e-6 without a config)."""
    eps = config.norm_eps if config is not None else 1e-6
    return _rms_norm(x, params["final_norm"], eps) @ params["lm_head"]


def embed_wave(params: Params, tokens, config: Optional[LlamaConfig] = None) -> torch.Tensor:
    """[B, K] wave tokens -> [B, K, dim] activations (the layerwise decode
    chain's entry), times ``config.embed_scale``."""
    return _embed(params, tokens, config)


def wave_index(positions, block_tables, config: LlamaConfig, max_blocks: int):
    """Where a wave's rows write and what they attend, shared by every layer
    of a step: ``(block_idx [B*K], slots [B*K], row_tables [B*K, max_blocks],
    seq_lens [B*K])``. Validates the shapes."""
    bsz, kk = positions.shape
    if tuple(block_tables.shape) != (bsz, max_blocks):
        raise ValueError(
            f"block_tables must be [{bsz}, {max_blocks}] (one padded row per "
            f"request), got {tuple(block_tables.shape)}"
        )
    bt = config.block_tokens
    flat_pos = positions.reshape(-1)  # [B*K]
    block_idx = torch.gather(block_tables, 1, (positions // bt).long()).reshape(-1).long()
    slots = (flat_pos % bt).long()
    row_tables = block_tables.repeat_interleave(kk, dim=0)  # [B*K, max_blocks]
    return block_idx, slots, row_tables, flat_pos + 1


def decode_wave_layer(
    params: Params,
    x: torch.Tensor,  # [B, K, dim] activations entering this layer
    positions,  # [B, K] int absolute positions
    k_cache: torch.Tensor,  # this layer's paged K tensor, updated in place
    v_cache: torch.Tensor,  # this layer's paged V tensor, updated in place
    block_tables,  # [B, max_blocks] int (rows padded)
    config: LlamaConfig,
    layer: int,
    max_blocks: int,
    *,
    index=None,
    counts: Optional[LaunchCounts] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer of ``verify_step_batched``'s wave body: insert the wave's
    K/V at (table[pos // bt], pos % bt) (indexed assignment), paged attention
    over this layer's cache (K3 on CUDA), residual + FFN. Returns ``(x_next,
    k_cache, v_cache)``. ``index``: the step's ``wave_index``, which a chain
    computes once for all its layers (computed here when None).

    The watermark-gated decode (``disagg.overlapped_decode``) calls this
    only after this layer's prefix KV is installed, and the blocking path
    chains the same function, so the two agree bit for bit."""
    _set_numerics()
    if index is None:
        positions = _on(params, positions, torch.int32)
        block_tables = _on(params, block_tables, torch.int32)
        index = wave_index(positions, block_tables, config, max_blocks)
    block_idx, slots, row_tables, seq_lens = index
    bsz, kk = x.shape[:2]
    k, v = _kv_proj(params, layer, x, positions, config)  # [B, K, KVH, D]
    k_cache[block_idx, slots] = k.reshape(bsz * kk, *k.shape[2:]).to(k_cache.dtype)
    v_cache[block_idx, slots] = v.reshape(bsz * kk, *v.shape[2:]).to(v_cache.dtype)
    q = _q_proj(params, layer, x, positions, config)  # [B, K, H, D]
    window = config.layer_window(layer)
    attn = paged_decode_attention_batched(
        q.reshape(bsz * kk, *q.shape[2:]), k_cache, v_cache, row_tables, seq_lens,
        window=window,
    ).reshape(bsz, kk, -1)  # [B, K, H*D]
    if window and counts is not None:
        counts.add_window(seq_lens, window)
    x = _attn_residual(params, layer, x, attn, config)
    x = _ffn(params, layer, x, config, counts)
    return x, k_cache, v_cache


# ---------------------------------------------------------------------------
# Training (dense attention, no cache): the JAX package's loss_fn and
# train_step, with torch.autograd in the place of jax.value_and_grad. The
# pipeline (``pipeline.py``) and the expert-parallel step
# (``expert_parallel.py``) share the pieces below.
# ---------------------------------------------------------------------------


def _causal(b: int, s: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions ``arange(S)`` for each of B rows, and the explicit causal
    mask [B, S, S] that keeps ``_block`` on the differentiable
    ``_attention``."""
    positions = torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)
    return positions, positions[:, :, None] >= positions[:, None, :]


def _next_token_nll(params: Params, x: torch.Tensor, tokens: torch.Tensor,
                    config: Optional[LlamaConfig] = None) -> torch.Tensor:
    """Final RMSNorm, f32 logits from the ``lm_head`` product, log-softmax
    over ``logits[:, :-1]``: the [B, S - 1] NLL of ``tokens[:, 1:]``."""
    logp = torch.log_softmax(lm_logits(params, x, config).float()[:, :-1], dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None])[..., 0]


def loss_fn(params: Params, tokens, config: LlamaConfig) -> torch.Tensor:
    """Next-token cross entropy over a [B, S] token batch (f32 scalar)."""
    _set_numerics()
    tokens = _on(params, tokens, torch.long)
    b, s = tokens.shape
    positions, mask = _causal(b, s, tokens.device)
    x = _embed(params, tokens, config)
    for layer in range(config.n_layers):
        k, v = _kv_proj(params, layer, x, positions, config)
        x = _block(params, layer, x, k, v, positions, mask, config)
    return _next_token_nll(params, x, tokens, config).mean()


def _loss_and_grads(params: Params, loss_of) -> Tuple[torch.Tensor, Params]:
    """``loss_of(leaves)`` and its gradient with respect to every parameter:
    the counterpart of ``jax.value_and_grad``. The leaves share the
    parameters' storage; the returned loss is detached."""
    leaves = {name: p.detach().requires_grad_() for name, p in params.items()}
    loss = loss_of(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _sgd_(params: Params, grads: Params, lr: float) -> None:
    """``p - lr * g.astype(p.dtype)`` in place: the gradient is cast to the
    parameter's dtype first and ``lr * g`` rounds there, as in the JAX
    package's update."""
    with torch.no_grad():
        for name, p in params.items():
            p.sub_(grads[name].to(p.dtype) * lr)


def train_step(params: Params, tokens, config: LlamaConfig,
               lr: float = 1e-3) -> Tuple[Params, torch.Tensor]:
    """One SGD step on next-token loss; returns ``(params, loss)``.

    The parameters are updated IN PLACE (the same dict and tensors come
    back): the counterpart of the JAX package's ``donate_argnums=(0,)``,
    which at Llama-3-8B width saves a second copy of the weights. Copy them
    first to keep the old values. Gradients come from ``torch.autograd``
    through the dense attention (``loss_fn``'s explicit mask), so no kernel
    runs; the soft-MoE FFN differentiates like the dense one."""
    loss, grads = _loss_and_grads(params, lambda p: loss_fn(p, tokens, config))
    _sgd_(params, grads, lr)
    return params, loss
