"""Expert-parallel training of the soft mixture of experts over a (dp, tp,
ep) grid of ``torch.distributed`` ranks.

The reference is ``tests/test_model_disagg.py:247``
(``test_moe_expert_parallel_train_step``): the JAX package's ``train_step``
on an MoE config, its weights placed on a ``("dp", "tp", "ep")`` mesh and
sharded by GSPMD from the placements. Here each rank is a process of its
own, and the placements are that test's:

- ``w_gate_up_moe`` [E, dim, 2, F] as ``P("ep", None, None, "tp")``: a rank
  holds [E / ep, dim, 2, F / tp];
- ``w_down_moe`` [E, F, dim] as ``P("ep", "tp", None)``: [E / ep, F / tp, dim];
- ``router`` [dim, E] as ``P(None, "ep")``: [dim, E / ep];
- every other weight replicated, and the tokens split over dp.

Each rank holds only its slice, before and after a step. Rank ``r`` sits at
``(d, i, j)`` with ``r = (d * tp + i) * ep + j``, the order of the JAX
test's ``reshape(2, 2, 2)`` of its devices.

Each MoE FFN, on the ``tp * ep`` ranks that share a dp index (they hold the
same activations): the normed input enters through ``_CopyIn`` (identity
forward, all-reduce backward over those ranks: Megatron's f); the router's
logits for the local experts are gathered over ep (``_GatherExperts``)
before the f32 softmax; each rank computes its (experts, ffn columns) share
of ``bse,bsef,efd->bsd`` with ``llama._expert_sum``, the port's fixed
contraction order; and the shares sum over the ``tp * ep`` ranks
(``_ReduceOut``: all-reduce forward, identity backward: Megatron's g).

Gradients: each rank backpropagates its copy of its dp shard's share of the
loss (the NLL sum over the whole batch's token count, so the shares sum to
the reference's mean). The replicated weights' gradients then sum over dp;
the router's also over tp (each tp rank reaches its slice through its own
ffn columns); the experts' over dp alone. Nothing here reaches a kernel.
"""

from dataclasses import dataclass
from typing import Dict

import torch
import torch.distributed as dist

from ..cuda import _ext
from . import llama
from .llama import LlamaConfig, Params

# Per-layer weights split over the grid: {name: ((dim, axis), ...)}.
_SPLITS = {
    "w_gate_up_moe": ((0, "ep"), (3, "tp")),
    "w_down_moe": ((0, "ep"), (1, "tp")),
    "router": ((1, "ep"),),
}


@dataclass(frozen=True)
class EpGrid:
    """This rank's place ``(d, i, j)`` in a ``(dp, tp, ep)`` grid and the
    process groups it reduces over (``ep_grid`` builds it)."""

    dp: int
    tp: int
    ep: int
    d: int
    i: int
    j: int
    dp_group: object  # the dp ranks at this (i, j)
    tp_group: object  # the tp ranks at this (d, j)
    ep_group: object  # the ep ranks at this (d, i)
    shard_group: object  # the tp * ep ranks at this d


def ep_grid(dp: int, tp: int, ep: int) -> EpGrid:
    """The grid over the default process group, whose size must be ``dp *
    tp * ep``. Collective: every rank calls it, in the same order as its
    other group creations."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("ep_grid needs an initialised torch.distributed process group "
                           "(init_process_group), one rank per grid point")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != dp * tp * ep:
        raise ValueError(f"the process group has {world} ranks, the grid {dp} x {tp} x {ep}")

    def at(d, i, j):
        return (d * tp + i) * ep + j

    d, rest = divmod(rank, tp * ep)
    i, j = divmod(rest, ep)
    groups = {}
    for name, members in (
        ("dp_group", [[at(d_, i_, j_) for d_ in range(dp)]
                      for i_ in range(tp) for j_ in range(ep)]),
        ("tp_group", [[at(d_, i_, j_) for i_ in range(tp)]
                      for d_ in range(dp) for j_ in range(ep)]),
        ("ep_group", [[at(d_, i_, j_) for j_ in range(ep)]
                      for d_ in range(dp) for i_ in range(tp)]),
        ("shard_group", [[at(d_, i_, j_) for i_ in range(tp) for j_ in range(ep)]
                         for d_ in range(dp)]),
    ):
        groups[name], _ = dist.new_subgroups_by_enumeration(members)
    return EpGrid(dp, tp, ep, d, i, j, **groups)


class _CopyIn(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over
    ``group`` (each rank's share of the FFN reaches the input by its own
    weights). A group of one rank (``world`` 1) posts nothing."""

    @staticmethod
    def forward(ctx, x, group, world):
        ctx.group, ctx.world = group, world
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if ctx.world == 1:
            return grad, None, None
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None, None


class _ReduceOut(torch.autograd.Function):
    """The ranks' shares summed over ``group`` in the forward; identity
    backward (every rank carries the same loss onward, so each share's
    gradient is the sum's). A group of one rank (``world`` 1) posts
    nothing."""

    @staticmethod
    def forward(ctx, x, group, world):
        if world == 1:
            return x.view_as(x)
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherExperts(torch.autograd.Function):
    """[N, E / ep] local logits -> [N, E], gathered over ``group`` in rank
    order along the last dim. Backward: each rank's slice of the summed
    gradients (every rank's softmax reaches every slice)."""

    @staticmethod
    def forward(ctx, x, group, world, rank):
        ctx.meta = group, world, rank, x.shape[-1]
        if world == 1:
            return x.view_as(x)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        group, world, rank, width = ctx.meta
        if world == 1:
            return grad, None, None, None
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=group)
        return grad[..., rank * width:(rank + 1) * width], None, None, None


def _ep_moe(local: Params, pre: str, h, config: LlamaConfig, grid: EpGrid, sum_tp=True):
    """This rank's share of the soft mixture (``llama._moe`` on the grid),
    summed over the shard group, whose ranks all hold ``h``; with
    ``sum_tp`` False over the ep group only (the tensor-parallel step's tp
    ranks gather ``h`` and sum their shares themselves)."""
    group, world = ((grid.shard_group, grid.tp * grid.ep) if sum_tp
                    else (grid.ep_group, grid.ep))
    e_loc = config.n_experts // grid.ep
    lead = h.shape[:-1]
    h2 = _CopyIn.apply(h.reshape(-1, config.dim), group, world)  # [N, dim]
    logits = _GatherExperts.apply(h2 @ local[pre + "router"], grid.ep_group, grid.ep, grid.j)
    gates = torch.softmax(logits.float(), dim=-1).to(h.dtype)[:, grid.j * e_loc:(grid.j + 1) * e_loc]
    share = llama._expert_sum(h2, gates, local[pre + "w_gate_up_moe"], local[pre + "w_down_moe"])
    return _ReduceOut.apply(share, group, world).reshape(*lead, config.dim)


def ep_loss_fn(local: Params, tokens: torch.Tensor, config: LlamaConfig,
               grid: EpGrid) -> torch.Tensor:
    """This rank's copy of its dp shard's share of the next-token loss:
    ``llama.loss_fn``'s forward with the expert-parallel FFN, the NLL summed
    over the shard's [B / dp, S] tokens and divided by the whole batch's B *
    (S - 1)."""
    llama._set_numerics()
    b, s = tokens.shape
    positions, mask = llama._causal(b, s, tokens.device)
    x = local["embed"][tokens]
    for layer in range(config.n_layers):
        pre = f"l{layer}."
        k, v = llama._kv_proj(local, layer, x, positions, config)
        x = llama._attend(local, layer, x, k, v, positions, mask, config)
        x = x + _ep_moe(local, pre, llama._rms_norm(x, local[pre + "ffn_norm"]), config, grid)
    return llama._next_token_nll(local, x, tokens).sum() / (b * grid.dp * (s - 1))


def ep_loss_and_grads(local: Params, tokens: torch.Tensor, config: LlamaConfig, grid: EpGrid):
    """The whole batch's loss and this rank's gradients of its slices,
    reduced as the module docstring says (every rank posts the same
    reductions in the same order)."""
    loss, grads = llama._loss_and_grads(local, lambda p: ep_loss_fn(p, tokens, config, grid))
    for name, grad in grads.items():
        if name.endswith("router"):
            dist.all_reduce(grad, group=grid.tp_group)
        dist.all_reduce(grad, group=grid.dp_group)
    dist.all_reduce(loss, group=grid.dp_group)
    return loss, grads


def _local_slice(name: str, t: torch.Tensor, grid: EpGrid, splits=_SPLITS) -> torch.Tensor:
    """This rank's slice of weight ``name`` under the placement table
    ``splits`` (``{suffix: ((dim, axis), ...)}``; a suffix it lacks is
    replicated)."""
    for dim, axis in splits.get(name.rsplit(".", 1)[-1], ()):
        parts, at = (grid.ep, grid.j) if axis == "ep" else (grid.tp, grid.i)
        size = t.shape[dim] // parts
        t = t.narrow(dim, at * size, size)
    return t


def make_ep_train_step(grid: EpGrid, config: LlamaConfig, device="cuda"):
    """Build the expert-parallel training step on ``grid``. Returns ``(step,
    shard_params)``: ``shard_params(params)`` copies this rank's slice of
    the full parameters onto ``device``; ``step(local, tokens, lr=1e-3)``
    takes this rank's dp shard of the batch ([B / dp, S]) and is one SGD
    step, ``(local, loss)``, with the whole batch's loss on every rank and
    the slices updated IN PLACE (as ``llama.train_step``)."""
    dev = _ext.resolve_device(device)
    if config.n_experts == 0:
        raise ValueError("expert parallelism needs an MoE config (n_experts > 0)")
    if config.n_experts % grid.ep or config.ffn_dim % grid.tp:
        raise ValueError(f"n_experts={config.n_experts} must divide over ep={grid.ep} and "
                         f"ffn_dim={config.ffn_dim} over tp={grid.tp}")

    def shard_params(params: Params) -> Dict:
        return {k: _local_slice(k, v, grid).to(device=dev, copy=True).contiguous()
                for k, v in params.items()}

    def step(local: Dict, tokens, lr: float = 1e-3):
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        loss, grads = ep_loss_and_grads(local, tokens, config, grid)
        llama._sgd_(local, grads, lr)
        return local, loss

    return step, shard_params
