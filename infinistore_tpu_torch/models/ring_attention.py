"""Ring attention: context parallelism for long sequences over the ranks of
a ``torch.distributed`` process group, forward only (port of
``infinistore_tpu/models/ring_attention.py``).

Each rank holds a contiguous sequence chunk of Q, K and V. Attention needs
every (q, k) pair, so the K/V chunks rotate around the ring, one neighbour
hop a step (``batch_isend_irecv``; the next hop is posted before the local
step's compute, so the two overlap), while each rank folds its Q chunk's
attention online: flash attention's running max and denominator in f32.

The JAX package runs one SPMD program over a mesh axis; here each rank is a
process of its own that passes its chunk ``[B, S_loc, H, D]`` (rank ``r``
holding positions ``r * S_loc`` to ``r * S_loc + S_loc - 1``) and gets its
chunk of the output back. Without an initialised process group the call
raises. The local step is plain f32 ``torch.matmul`` with TF32 off, as the
reference's einsums at ``Precision.HIGHEST``; the reference reaches no
Pallas kernel here either.

Gradients (the reference differentiates through the rotation) are not
ported: inputs that require grad raise ``NotImplementedError``.
"""

import math
from typing import Optional

import torch
import torch.distributed as dist

from .llama import _set_numerics

_GRAD_TODO = ("{} runs forward only; its gradients are not ported yet "
              "(ROADMAP.md Queue A, A12b)")


def _group_of(name: str, group, *tensors: torch.Tensor):
    """``(world, rank, global rank of each group rank)``; raises without an
    initialised process group, or when an input requires grad."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"{name} needs an initialised torch.distributed process group "
            "(init_process_group), one rank per sequence chunk")
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(_GRAD_TODO.format(name))
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    peers = [r if group is None else dist.get_global_rank(group, r) for r in range(world)]
    return world, rank, peers


def _ring_attention_local(
    q: torch.Tensor,  # [B, S_loc, H, D] this rank's query chunk
    k: torch.Tensor,  # [B, S_loc, H, D] this rank's key chunk (rotates)
    v: torch.Tensor,  # [B, S_loc, H, D]
    group,
    causal: bool,
) -> torch.Tensor:
    """The ring on this rank. K/V rotate in their own dtype; every product
    and statistic is f32. A fully masked row keeps ``m = -inf`` and adds
    nothing: its correction is defined as 1 and its probabilities as 0."""
    world, rank, peers = _group_of("ring_attention", group, q, k, v)
    _set_numerics()
    b, s_loc, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q32 = q.float().transpose(1, 2)  # [B, H, S_loc, D]
    q_pos = rank * s_loc + torch.arange(s_loc, device=q.device)
    m = torch.full((b, h, s_loc), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k.contiguous(), v.contiguous()
    nxt, prv = peers[(rank + 1) % world], peers[(rank - 1) % world]
    for i in range(world):
        # After step i this rank holds the chunk that started on rank - i.
        # The last step needs no next hop (and a ring of one has no hop).
        reqs = []
        if i < world - 1:
            k_nxt, v_nxt = torch.empty_like(k_cur), torch.empty_like(v_cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, k_cur, nxt, group, tag=0),
                dist.P2POp(dist.isend, v_cur, nxt, group, tag=1),
                dist.P2POp(dist.irecv, k_nxt, prv, group, tag=0),
                dist.P2POp(dist.irecv, v_nxt, prv, group, tag=1),
            ])
        src = (rank - i) % world
        scores = (q32 @ k_cur.float().permute(0, 2, 3, 1)) * scale  # [B, H, S_loc, S_loc]
        if causal:
            k_pos = src * s_loc + torch.arange(s_loc, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            scores = scores.masked_fill(~mask, -math.inf)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.where(torch.isneginf(m_new), 1.0, torch.exp(m - m_new))
        p = torch.exp(scores - m_new[..., None])
        p = torch.where(torch.isneginf(scores), 0.0, p)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + p @ v_cur.float().transpose(1, 2)
        m = m_new
        for req in reqs:
            req.wait()
        if reqs:
            k_cur, v_cur = k_nxt, v_nxt
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # [B, S_loc, H, D]


def ring_attention(
    q: torch.Tensor,  # [B, S_loc, H, D]: this rank's chunk of the sequence
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: Optional["dist.ProcessGroup"] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Sequence-parallel attention: every rank of ``group`` (default: the
    default group) passes its chunk and gets its chunk of the output,
    ``[B, S_loc, H, D]``. K/V head counts must equal Q's (repeat GQA heads
    before the call). Every rank's chunk has the same shape."""
    if not (q.shape == k.shape == v.shape):
        raise ValueError(
            f"q, k and v must share one shape [B, S_loc, H, D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return _ring_attention_local(q, k, v, group, causal)


def dense_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The oracle: plain f32 softmax attention over the full sequence."""
    _set_numerics()
    d = q.shape[-1]
    scores = (q.float().transpose(1, 2) @ k.float().permute(0, 2, 3, 1)) / math.sqrt(d)
    if causal:
        pos = torch.arange(q.shape[1], device=q.device)
        scores = scores.masked_fill(~(pos[:, None] >= pos[None, :]), -math.inf)
    if mask is not None:
        scores = scores.masked_fill(~mask, -math.inf)
    p = torch.softmax(scores, dim=-1)
    out = p @ v.float().transpose(1, 2)
    return out.transpose(1, 2).to(q.dtype)
