"""Long-context prefill under sequence parallelism, ring attention inside
(port of ``infinistore_tpu/models/long_context.py``).

The full transformer forward with the SEQUENCE split over the ranks of a
``torch.distributed`` process group: each rank embeds and projects only its
token chunk, attention is the ring's (K/V rotating, online softmax:
``ring_attention.py``), and the per-token work (norms, FFN, logits) stays
local. Each rank's outputs are what a long-context engine hands the store:
per-layer K/V of its token chunk, which its own connector saves under the
full token list (``KVConnector.save(..., first_block=...)``).

The sharding changes the schedule, not the math: logits and every layer's
K/V equal the dense forward to float tolerance. Dense (non-MoE) configs
only, as in the JAX package.
"""

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from .llama import LlamaConfig, Params, _ffn, _kv_proj, _on, _q_proj, lm_logits
from .ring_attention import _group_of, _ring_attention_local


def prefill_ring(
    params: Params,
    tokens,  # [B, S_loc] int: this rank's chunk of the prompt
    config: LlamaConfig,
    *,
    group: Optional["dist.ProcessGroup"] = None,
) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Sequence-parallel prefill. Rank ``r`` of ``group`` (default: the
    default group) passes tokens ``r * S_loc`` to ``r * S_loc + S_loc - 1``
    and gets ``(logits [B, S_loc, vocab], [(k, v)] per layer)``, k/v ``[B,
    S_loc, n_kv_heads, head_dim]``, all on the parameters' device. Raises
    without an initialised process group."""
    if config.n_experts > 0:
        raise ValueError("prefill_ring covers the dense FFN config")
    _world, rank, _peers = _group_of("prefill_ring", group)
    tokens = _on(params, tokens, torch.long)
    if tokens.dim() != 2:
        raise ValueError(f"tokens must be [B, S_loc], got {tuple(tokens.shape)}")
    b, s_loc = tokens.shape
    positions = (rank * s_loc + torch.arange(s_loc, dtype=torch.int32, device=tokens.device)
                 )[None].expand(b, s_loc)
    x = params["embed"][tokens]
    groups = config.n_heads // config.n_kv_heads
    kvs = []
    for layer in range(config.n_layers):
        q = _q_proj(params, layer, x, positions, config)
        k, v = _kv_proj(params, layer, x, positions, config)
        kvs.append((k, v))
        attn = _ring_attention_local(
            q, k.repeat_interleave(groups, dim=2), v.repeat_interleave(groups, dim=2),
            group, causal=True)
        x = x + attn.flatten(-2) @ params[f"l{layer}.wo"].reshape(-1, config.dim)
        x = _ffn(params, layer, x, config)
    return lm_logits(params, x), kvs
