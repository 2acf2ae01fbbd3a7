"""Ulysses-style all-to-all sequence parallelism, forward and gradients
(port of ``infinistore_tpu/models/ulysses.py``; the DeepSpeed-Ulysses
pattern).

The other long-context sharding beside ring attention: instead of rotating
K/V around a ring, an all-to-all re-shards q/k/v from sequence-sharded
``[B, S/P, H, D]`` to head-sharded ``[B, S, H/P, D]``, attention runs locally
over the full sequence for this rank's head group (exact softmax, no online
accumulation), and one all-to-all brings the output back to sequence
sharding. Each rank of a ``torch.distributed`` process group passes its
chunk and gets its chunk back; the exchanges are ``all_to_all_single``. The
local step is plain f32 ``torch.matmul`` with TF32 off, as the reference's
einsums at ``Precision.HIGHEST``.

Gradients: the reference differentiates through ``all_to_all``, whose
transpose is the inverse exchange. Here each exchange is one
``torch.autograd.Function`` (``_Exchange``) whose backward is the inverse
``all_to_all_single``, and autograd differentiates the local math.

Needs ``n_heads % world_size == 0`` (``ValueError`` otherwise).
"""

import math
from typing import Optional

import torch
import torch.distributed as dist

from .llama import _set_numerics
from .ring_attention import _group_of


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` over dim 0 (one slice a rank)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _Exchange(torch.autograd.Function):
    """One all-to-all over dim 0 as one autograd node: slice j goes to rank
    j, and rank j's slice comes back as slice j. The exchange is its own
    inverse, so the backward runs the same exchange on the gradient.

    q, k and v cross in ONE exchange (stacked): NCCL matches collectives by
    their order, and three independent nodes could run their backward
    passes in different orders on different ranks. (Gloo matches by tag,
    so the CPU would not show such a mismatch.)"""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def ulysses_attention(
    q: torch.Tensor,  # [B, S_loc, H, D]: this rank's chunk of the sequence
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: Optional["dist.ProcessGroup"] = None,
    causal: bool = True,
) -> torch.Tensor:
    """All-to-all sequence-parallel attention; in and out ``[B, S_loc, H,
    D]``, rank ``r`` holding positions ``r * S_loc`` onward. K/V head counts
    must equal Q's (repeat GQA heads first)."""
    if not (q.shape == k.shape == v.shape):
        raise ValueError(
            f"q, k and v must share one shape [B, S_loc, H, D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    world, _rank, _peers = _group_of("ulysses_attention", group)
    b, s_loc, h, d = q.shape
    if h % world:
        raise ValueError(f"n_heads={h} must be a multiple of the group's size ({world})")
    _set_numerics()
    hl, s = h // world, world * s_loc

    # [3, B, S_loc, H, D] -> [3, B, S, H_loc, D]: slice j of the heads goes to
    # rank j, and rank j's sequence chunk comes back as slice j.
    qkv = torch.stack((q, k, v)).reshape(3, b, s_loc, world, hl, d).permute(3, 0, 1, 2, 4, 5)
    qkv = _Exchange.apply(qkv, group).permute(1, 2, 0, 3, 4, 5).reshape(3, b, s, hl, d)
    qf, kf, vf = (x.float().transpose(1, 2) for x in qkv)  # [B, H_loc, S, D]
    scores = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if causal:
        pos = torch.arange(s, device=q.device)
        scores = scores.masked_fill(~(pos[:, None] >= pos[None, :]), -math.inf)
    out = (torch.softmax(scores, dim=-1) @ vf).transpose(1, 2).to(q.dtype)  # [B, S, H_loc, D]
    # [B, S, H_loc, D] -> [B, S_loc, H, D]: the inverse exchange.
    out = _Exchange.apply(out.reshape(b, world, s_loc, hl, d).permute(1, 0, 2, 3, 4), group)
    return out.permute(1, 2, 0, 3, 4).reshape(b, s_loc, h, d)
