"""Small Llama-style transformer with a paged KV cache, in PyTorch (port of
the paged-inference path of ``infinistore_tpu/models/llama.py``).

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

Numerics on CUDA (``_set_numerics``): f32 matmuls at full f32 precision —
TF32 off for matmuls and cuDNN, the counterpart of ``Precision.HIGHEST`` —
and bf16 GEMMs accumulate in f32 without reduced-precision reductions.

The caches are updated IN PLACE; the functions return the same tensors in
the JAX package's ``(logits, caches)`` shape.
"""

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..cuda import _ext
from ..cuda.flash_prefill import flash_prefill_attention
from ..cuda.paged import PagedKVCacheSpec, scatter_blocks_many
from ..cuda.paged_attention import paged_decode_attention_batched, paged_decode_attention_rows

Params = Dict[str, torch.Tensor]
Caches = List[Tuple[torch.Tensor, torch.Tensor]]

_MOE_TODO = (
    "the soft mixture-of-experts FFN (n_experts > 0) is not ported yet; "
    "see ROADMAP.md Queue A"
)


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
    # > 0 selects the soft mixture-of-experts FFN of the JAX package, which
    # the port does not run yet (NotImplementedError).
    n_experts: int = 0
    block_tokens: int = 8
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

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
    if config.n_experts > 0:
        raise NotImplementedError(_MOE_TODO)
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
        shapes[pre + "ffn_norm"] = (config.dim,)
        shapes[pre + "w_gate_up"] = (config.dim, 2, config.ffn_dim)
        shapes[pre + "w_down"] = (config.ffn_dim, config.dim)
    return shapes


def init_params(config: LlamaConfig, generator: torch.Generator, device="cuda") -> Params:
    """He-scaled dense params as a flat dict (layer-prefixed keys), drawn
    from ``generator`` on its own device and placed on ``device``. Norm
    weights are ones."""
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


def _rms_norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # Variance and rsqrt in f32; the factor is cast to x's dtype BEFORE the
    # multiply, as in the JAX package.
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * w


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


def _block(params: Params, layer: int, x, k, v, q_positions, mask, config):
    """Shared transformer block math given already-materialised K/V context.

    x: [B, S, dim]; k/v: [B, T, KVH, D]. ``mask`` is [B, S, T] (True =
    attend), or None for plain causal — the None form runs the flash
    prefill path (no S x T logits)."""
    pre = f"l{layer}."
    q = _q_proj(params, layer, x, q_positions, config)
    if mask is None:
        attn = flash_prefill_attention(q, k, v, causal=True)
    else:
        attn = _attention(q, k, v, mask)
    x = x + attn.flatten(-2) @ params[pre + "wo"].reshape(-1, config.dim)
    return _ffn(params, layer, x, config)


def _ffn(params: Params, layer: int, x, config):
    """FFN half of the block (dense SwiGLU)."""
    if config.n_experts > 0:
        raise NotImplementedError(_MOE_TODO)
    pre = f"l{layer}."
    h = _rms_norm(x, params[pre + "ffn_norm"])
    gate_up = (h @ params[pre + "w_gate_up"].reshape(config.dim, -1)).unflatten(
        -1, (2, config.ffn_dim)
    )
    ffn = F.silu(gate_up[..., 0, :]) * gate_up[..., 1, :]
    return x + ffn @ params[pre + "w_down"]


def _q_proj(params: Params, layer: int, x, positions, config):
    pre = f"l{layer}."
    h = _rms_norm(x, params[pre + "attn_norm"])
    q = (h @ params[pre + "wq"].reshape(config.dim, -1)).unflatten(
        -1, (config.n_heads, config.head_dim)
    )
    return _rope(q, positions, config.rope_theta)


def _kv_proj(params: Params, layer: int, x, positions, config):
    pre = f"l{layer}."
    h = _rms_norm(x, params[pre + "attn_norm"])
    kv_shape = (config.n_kv_heads, config.head_dim)
    k = (h @ params[pre + "wk"].reshape(config.dim, -1)).unflatten(-1, kv_shape)
    v = (h @ params[pre + "wv"].reshape(config.dim, -1)).unflatten(-1, kv_shape)
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
    x = embed_prompt(params, tokens)  # [1, S, dim]
    new_caches: Caches = []
    for layer, (k_cache, v_cache) in enumerate(caches):
        x, k_cache, v_cache = prefill_layer(params, x, k_cache, v_cache, block_table,
                                            config, layer)
        new_caches.append((k_cache, v_cache))
    return lm_logits(params, x[:, -1:])[0, -1], new_caches


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
    x = embed_wave(params, tokens)  # [B, K, dim]
    index = wave_index(positions, block_tables, config, max_blocks)
    new_caches: Caches = []
    for layer, (k_cache, v_cache) in enumerate(caches):
        x, k_cache, v_cache = decode_wave_layer(
            params, x, positions, k_cache, v_cache, block_tables, config, layer, max_blocks,
            index=index,
        )
        new_caches.append((k_cache, v_cache))
    return lm_logits(params, x), new_caches


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
) -> Tuple[torch.Tensor, Caches]:
    """The ragged form of ``verify_step_batched``: a mixed wave whose request
    chunks keep their own lengths, as one flat [T] token list with per-token
    request and page metadata instead of a [B, K] rectangle.

    Each flat token inserts its K/V at (table[pos // bt], pos % bt) and
    attends its own prefix masked to pos + 1, so per-token semantics are
    ``verify_step_batched``'s. Tail padding repeats the last flat row (same
    bytes to the same slot); ``block_tables`` rows no flat token references
    neither scatter nor attend. Attention is one K6 launch per layer on CUDA
    over the flat page list. Returns ([T, vocab] logits, caches)."""
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
    x = params["embed"][tokens][None]  # [1, T, dim]
    pos2d = positions[None]  # [1, T]

    row_tables = block_tables[row_of]  # [T, max_blocks]
    block_idx = torch.gather(row_tables, 1, (positions // bt).long()[:, None])[:, 0].long()
    slots = (positions % bt).long()
    seq_lens = positions + 1

    new_caches: Caches = []
    for layer, (k_cache, v_cache) in enumerate(caches):
        k, v = _kv_proj(params, layer, x, pos2d, config)  # [1, T, KVH, D]
        k_cache[block_idx, slots] = k[0].to(k_cache.dtype)
        v_cache[block_idx, slots] = v[0].to(v_cache.dtype)
        pre = f"l{layer}."
        q = _q_proj(params, layer, x, pos2d, config)  # [1, T, H, D]
        attn = paged_decode_attention_rows(
            q[0].contiguous(), k_cache, v_cache, row_tables, seq_lens,
            pages, page_rows, page_starts,
        ).reshape(1, t, -1)  # [1, T, H*D]
        x = x + attn @ params[pre + "wo"].reshape(-1, config.dim)
        x = _ffn(params, layer, x, config)
        new_caches.append((k_cache, v_cache))
    x = _rms_norm(x, params["final_norm"])
    logits = x @ params["lm_head"]
    return logits[0], new_caches


def prefill_continue(
    params: Params,
    tokens,  # [S_c] int, the suffix chunk
    start_pos,  # int, absolute position of tokens[0]
    caches: Caches,
    block_table,  # [max_blocks] int (padded)
    config: LlamaConfig,
    max_blocks: int,
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
    )
    return logits[0], new_caches


# ---------------------------------------------------------------------------
# Layerwise inference entry points (the disaggregated prefill -> decode
# handoff, ``disagg.py``). ``prefill`` and ``verify_step_batched`` are chains
# of these functions, so a prefill engine can ship layer l's KV while layer
# l + 1 computes and a decode engine can gate each layer's attention on that
# layer's install alone, with one copy of each layer's math: the streamed
# prefill, the fallback recompute and ``prefill`` write the same bytes, and
# the watermarked, blocking and whole-step decodes give the same logits.
# ---------------------------------------------------------------------------


def embed_prompt(params: Params, tokens) -> torch.Tensor:
    """[S] prompt tokens -> [1, S, dim] activations (the layerwise prefill
    chain's entry)."""
    return params["embed"][_on(params, tokens, torch.long)][None]


def prefill_layer(
    params: Params,
    x: torch.Tensor,  # [1, S, dim] activations entering this layer
    k_cache: torch.Tensor,  # this layer's paged K tensor, updated in place
    v_cache: torch.Tensor,  # this layer's paged V tensor, updated in place
    block_table,  # [S // block_tokens] int cache block ids
    config: LlamaConfig,
    layer: int,
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
    x = _block(params, layer, x, k, v, positions, None, config)
    block = (s // bt, bt, config.n_kv_heads, config.head_dim)
    k_cache, v_cache = scatter_blocks_many(
        (k_cache, v_cache), block_table, (k[0].reshape(block), v[0].reshape(block)))
    return x, k_cache, v_cache


def lm_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head over [B, S, dim] activations (the layerwise
    chains' exit; [B, S, vocab] logits)."""
    return _rms_norm(x, params["final_norm"]) @ params["lm_head"]


def embed_wave(params: Params, tokens) -> torch.Tensor:
    """[B, K] wave tokens -> [B, K, dim] activations (the layerwise decode
    chain's entry)."""
    return params["embed"][_on(params, tokens, torch.long)]


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
    pre = f"l{layer}."
    q = _q_proj(params, layer, x, positions, config)  # [B, K, H, D]
    attn = paged_decode_attention_batched(
        q.reshape(bsz * kk, *q.shape[2:]), k_cache, v_cache, row_tables, seq_lens,
    ).reshape(bsz, kk, -1)  # [B, K, H*D]
    x = x + attn @ params[pre + "wo"].reshape(-1, config.dim)
    x = _ffn(params, layer, x, config)
    return x, k_cache, v_cache
