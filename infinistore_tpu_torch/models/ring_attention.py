"""Ring attention: context parallelism for long sequences over the ranks of
a ``torch.distributed`` process group (port of
``infinistore_tpu/models/ring_attention.py``), forward and gradients.

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

Gradients: the reference differentiates through ``scan`` + ``ppermute``,
whose transpose is the reverse permutation. Here each step's hop is one
``torch.autograd.Function`` (``_Hop``) whose backward sends the gradient of
what arrived back to the rank it came from; autograd differentiates the
local f32 math as it stands, ``-inf`` guards included. Each rank
backpropagates its own share of the loss, and the hops carry every other
rank's share of its K/V gradient to it.
"""

import math
from typing import Optional

import torch
import torch.distributed as dist

from .llama import _set_numerics


def _group_of(name: str, group):
    """``(world, rank, global rank of each group rank)``; raises without an
    initialised process group."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"{name} needs an initialised torch.distributed process group "
            "(init_process_group), one rank per sequence chunk")
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    peers = [r if group is None else dist.get_global_rank(group, r) for r in range(world)]
    return world, rank, peers


def _p2p_ops(group, sends, to, recvs, frm):
    """The point-to-point ops of one hop: each of ``sends`` to ``to`` and
    each of ``recvs`` from ``frm`` (either None: no such side), tagged by
    position."""
    ops = []
    if to is not None:
        ops += [dist.P2POp(dist.isend, t, to, group, tag=i) for i, t in enumerate(sends)]
    if frm is not None:
        ops += [dist.P2POp(dist.irecv, t, frm, group, tag=i) for i, t in enumerate(recvs)]
    return ops


class _Hop(torch.autograd.Function):
    """One hop of ``tensors`` to the next rank ``nxt`` while the previous
    rank ``prv``'s arrive (``nxt`` None: nothing is sent; ``prv`` None:
    zeros arrive). The forward POSTS the transfers and appends their
    requests to ``pending``, so a caller can overlap them with compute; it
    waits on them before it reads the outputs. The backward is the reverse
    hop: the gradients of what arrived go back to ``prv``, those of what was
    sent come from ``nxt``.

    The ring moves K and V in ONE node a step, and the pipeline one tensor
    a tick, on purpose: NCCL matches point-to-point operations by their
    order, not by tag, and independent nodes (one for K, one for V) could
    run their backward passes in different orders on different ranks. One
    node a step, each consuming the previous step's output, gives every
    rank the same chain of backward transfers. (Gloo matches by tag, so the
    CPU would not show such a mismatch.)"""

    @staticmethod
    def forward(ctx, group, nxt, prv, pending, *tensors):
        ctx.peers = group, nxt, prv
        tensors = [t.contiguous() for t in tensors]
        recvs = [torch.empty_like(t) if prv is not None else torch.zeros_like(t)
                 for t in tensors]
        ops = _p2p_ops(group, tensors, nxt, recvs, prv)
        if ops:
            pending.extend(dist.batch_isend_irecv(ops))
        return tuple(recvs)

    @staticmethod
    def backward(ctx, *grads):
        group, nxt, prv = ctx.peers
        grads = [g.contiguous() for g in grads]
        sent = [torch.empty_like(g) if nxt is not None else torch.zeros_like(g) for g in grads]
        ops = _p2p_ops(group, grads, prv, sent, nxt)
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        return (None, None, None, None, *sent)


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
    world, rank, peers = _group_of("ring_attention", group)
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
            k_nxt, v_nxt = _Hop.apply(group, nxt, prv, reqs, k_cur, v_cur)
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
