"""Tensor-parallel training over a (dp, tp, ep) grid of ``torch.distributed``
ranks, with the activations sharded over the sequence on tp.

The reference is the JAX package's multi-chip dryrun
(``__graft_entry__.py: dryrun_multichip``): ``train_step`` on a ``("dp",
"tp", "ep")`` mesh, its weights placed by the dryrun's ``param_spec`` and its
tokens as ``P("dp", "tp")``, GSPMD inserting every collective. Here the
layout is code, each rank a process of its own on ``expert_parallel``'s
grid (rank ``r`` at ``(d, i, j)``, ``r = (d * tp + i) * ep + j``). The
placements (``_SPLITS``) are the dryrun's, entry for entry:

- attention heads over tp: ``wq`` / ``wk`` / ``wv`` [dim, heads, hd] on dim 1,
  ``wo`` [H, hd, dim] on dim 0, in contiguous blocks, so each query head
  keeps its KV head (head h reads KV head h // groups);
- the dense FFN's hidden columns over tp: ``w_gate_up`` [dim, 2, F] on F
  (dim 2; a split of the flattened [dim, 2F] view would pair the wrong gate
  and up columns), ``w_down`` [F, dim] on dim 0;
- the vocabulary over tp: ``lm_head`` [dim, V] on dim 1, ``embed`` [V, dim]
  on dim 0;
- the experts over (ep, tp) and the router over ep, as in
  ``expert_parallel``; the norms replicated.

The forward pass (Megatron's sequence parallelism). The tokens split over
dp; between sublayers the activations are ``[B / dp, S / tp, dim]``, rank i
holding positions ``i * S / tp`` onward. Each attention and FFN sublayer:
RMSNorm on the sequence shard; an all-gather over tp (``_GatherSeq``, whose
backward is a reduce-scatter); the column-parallel projections (this rank's
heads, or its hidden columns); the rank's dense attention through
``llama._attention`` (the f32 contract); the row-parallel ``wo`` /
``w_down``; a reduce-scatter over tp on the sequence (``_ScatterSeq``, whose
backward is an all-gather); the residual add. An MoE config runs
``expert_parallel._ep_moe`` on the gathered input with its f/g pair over ep
only: the all-gather and the reduce-scatter over tp are the pair's tp half,
so the tp share of the input's gradient is summed once. The embedding is a
vocabulary-parallel lookup (tokens outside the rank's rows give zeros, and
the reduce-scatter sums the one rank that holds each token onto the
sequence shard). The LM head runs ``final_norm`` on the shard, an
all-gather, then the rank's vocabulary columns, and the loss is a
vocabulary-parallel cross entropy: the f32 max, the sum of exponentials and
the target's logit each reduced over tp, so no rank holds logits over the
whole vocabulary. The shift (``[:, :-1]`` against ``[:, 1:]``) is taken
after the gather, never on a shard. The loss is the NLL summed over the
rank's dp shard and divided by the whole batch's ``B * (S - 1)``.

Gradients (``tp_loss_and_grads``, one order on every rank): the norms over
tp (each tp rank saw only its sequence shard) and dp; the router over tp
and dp (each tp rank reaches its slice through its own ffn columns); every
other slice over dp. The collectives are ``torch.autograd.Function``s, each
backward written down; every rank posts the forward's and the backward's in
one order, which NCCL needs (it matches by order, gloo by tag). A group of
one rank posts nothing, so at world size 1 the step issues no collective.
Nothing here reaches a kernel (every kernel entry refuses inputs that
require grad).
"""

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..cuda import _ext
from . import expert_parallel, llama
from .expert_parallel import EpGrid, _ReduceOut
from .llama import LlamaConfig, Params

# The dryrun's placements: {weight suffix: ((dim, axis), ...)}; a suffix not
# listed (the norms) is replicated.
_SPLITS = {
    "wq": ((1, "tp"),),
    "wk": ((1, "tp"),),
    "wv": ((1, "tp"),),
    "wo": ((0, "tp"),),
    "w_gate_up": ((2, "tp"),),
    "w_down": ((0, "tp"),),
    "lm_head": ((1, "tp"),),
    "embed": ((0, "tp"),),
    **expert_parallel._SPLITS,
}
# Replicated over tp, and reached by each tp rank through its own shard: their
# gradients sum over tp (then dp, as every gradient).
_OVER_TP = ("attn_norm", "ffn_norm", "final_norm", "router")
# reduce_scatter_tensor's newer name, where the installed torch has it.
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _all_gather_seq(x: torch.Tensor, group, world: int) -> torch.Tensor:
    """[b, s, ...] shards -> [b, world * s, ...], rank order on dim 1."""
    b = x.shape[0]
    out = torch.empty((world * b, *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.unflatten(0, (world, b)).transpose(0, 1).flatten(1, 2)


def _reduce_scatter_seq(x: torch.Tensor, group, world: int) -> torch.Tensor:
    """[b, S, ...] -> this rank's [b, S / world, ...] of the sum over
    ``group``."""
    parts = x.unflatten(1, (world, -1)).transpose(0, 1)  # [world, b, S / world, ...]
    out = torch.empty(parts.shape[1:], dtype=x.dtype, device=x.device)
    _reduce_scatter(out, parts.flatten(0, 1).contiguous(), group=group)
    return out


class _GatherSeq(torch.autograd.Function):
    """The sequence shards gathered over tp; backward: the gradient summed
    over tp and this rank's shard of it kept (every tp rank reaches every
    position through its own heads or columns)."""

    @staticmethod
    def forward(ctx, x, group, world):
        ctx.group, ctx.world = group, world
        return _all_gather_seq(x, group, world)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_seq(grad, ctx.group, ctx.world), None, None


class _ScatterSeq(torch.autograd.Function):
    """The tp ranks' partial sums reduced and scattered over the sequence;
    backward: the shards' gradients gathered (each partial reaches every
    position)."""

    @staticmethod
    def forward(ctx, x, group, world):
        ctx.group, ctx.world = group, world
        return _reduce_scatter_seq(x, group, world)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_seq(grad, ctx.group, ctx.world), None, None


def _gather(x, grid: EpGrid):
    return x if grid.tp == 1 else _GatherSeq.apply(x, grid.tp_group, grid.tp)


def _scatter(x, grid: EpGrid):
    return x if grid.tp == 1 else _ScatterSeq.apply(x, grid.tp_group, grid.tp)


def _check_layout(config: LlamaConfig, grid: EpGrid) -> None:
    """Refuse a config whose split axes do not divide over the grid."""
    sizes = {"n_kv_heads": config.n_kv_heads, "ffn_dim": config.ffn_dim, "vocab": config.vocab}
    bad = [f"{name}={size}" for name, size in sizes.items() if size % grid.tp]
    if bad:
        raise ValueError(f"{', '.join(bad)} must divide over tp={grid.tp}")
    if config.n_experts == 0 and grid.ep > 1:
        raise ValueError(f"a dense config has no experts to place over ep={grid.ep}")
    if config.n_experts % grid.ep:
        raise ValueError(f"n_experts={config.n_experts} must divide over ep={grid.ep}")


def _embed(local: Params, tokens: torch.Tensor, grid: EpGrid) -> torch.Tensor:
    """The vocabulary-parallel lookup of [b, S] tokens -> this rank's
    [b, S / tp, dim] sequence shard."""
    rows = local["embed"].shape[0]
    idx = tokens - grid.i * rows
    inside = (idx >= 0) & (idx < rows)
    x = local["embed"][idx.clamp(0, rows - 1)].masked_fill(~inside[..., None], 0)
    return _scatter(x, grid)


def _attend(local: Params, layer: int, x, positions, mask, config: LlamaConfig, grid: EpGrid):
    """The attention sublayer with its residual, on this rank's heads."""
    pre, hd = f"l{layer}.", config.head_dim
    h = _gather(llama._rms_norm(x, local[pre + "attn_norm"]), grid)  # [b, S, dim]
    q, k, v = ((h @ local[pre + w].reshape(config.dim, -1)).unflatten(-1, (-1, hd))
               for w in ("wq", "wk", "wv"))
    q = llama._rope(q, positions, config.rope_theta)
    k = llama._rope(k, positions, config.rope_theta)
    out = llama._attention(q, k, v, mask).flatten(-2) @ local[pre + "wo"].reshape(-1, config.dim)
    return x + _scatter(out, grid)


def _ffn(local: Params, layer: int, x, config: LlamaConfig, grid: EpGrid):
    """The FFN sublayer with its residual, on this rank's hidden columns
    (and, for an MoE config, its experts)."""
    pre = f"l{layer}."
    h = _gather(llama._rms_norm(x, local[pre + "ffn_norm"]), grid)  # [b, S, dim]
    if config.n_experts > 0:
        out = expert_parallel._ep_moe(local, pre, h, config, grid, sum_tp=False)
    else:
        w_down = local[pre + "w_down"]
        gate_up = (h @ local[pre + "w_gate_up"].reshape(config.dim, -1)).unflatten(
            -1, (2, w_down.shape[0]))
        out = (F.silu(gate_up[..., 0, :]) * gate_up[..., 1, :]) @ w_down
    return x + _scatter(out, grid)


def _vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                        grid: EpGrid) -> torch.Tensor:
    """The NLL of ``targets`` [b, n] under f32 ``logits`` [b, n, V / tp] of
    this rank's vocabulary rows: ``log(sum exp(x - m)) - (x_t - m)``, with
    the max, the sum and the target's logit each reduced over tp (the max
    carries no gradient: it cancels)."""
    width = logits.shape[-1]
    m = logits.detach().amax(dim=-1, keepdim=True)
    if grid.tp > 1:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=grid.tp_group)
    shifted = logits - m
    idx = targets - grid.i * width
    inside = (idx >= 0) & (idx < width)
    picked = shifted.gather(-1, idx.clamp(0, width - 1)[..., None])[..., 0]
    # One all-reduce for both sums (identity backward: each rank's terms
    # reach the loss through the sum).
    sums = torch.stack([shifted.exp().sum(dim=-1), picked.masked_fill(~inside, 0)])
    sums = _ReduceOut.apply(sums, grid.tp_group, grid.tp)
    return torch.log(sums[0]) - sums[1]


def _hidden(local: Params, tokens: torch.Tensor, config: LlamaConfig, grid: EpGrid):
    """The layers over this rank's dp shard ([b, S] tokens): the final
    normed hidden state, gathered over the sequence ([b, S, dim])."""
    b, s = tokens.shape
    if s % grid.tp:
        raise ValueError(f"the sequence ({s} tokens) must divide over tp={grid.tp}")
    positions, mask = llama._causal(b, s, tokens.device)
    x = _embed(local, tokens, grid)
    for layer in range(config.n_layers):
        x = _attend(local, layer, x, positions, mask, config, grid)
        x = _ffn(local, layer, x, config, grid)
    return _gather(llama._rms_norm(x, local["final_norm"]), grid)


def tp_loss_fn(local: Params, tokens: torch.Tensor, config: LlamaConfig,
               grid: EpGrid) -> torch.Tensor:
    """This rank's copy of its dp shard's share of the next-token loss (the
    same on the shard's tp and ep ranks): the NLL summed over the shard's
    [B / dp, S] tokens and divided by the whole batch's B * (S - 1)."""
    llama._set_numerics()
    b, s = tokens.shape
    logits = (_hidden(local, tokens, config, grid) @ local["lm_head"]).float()  # [b, S, V / tp]
    nll = _vocab_parallel_nll(logits[:, :-1], tokens[:, 1:], grid)
    return nll.sum() / (b * grid.dp * (s - 1))


def _reduce_grads(grads: Params, grid: EpGrid, over_tp=_OVER_TP) -> None:
    """Each gradient summed in place: over tp where its suffix is in
    ``over_tp``, then over dp; in one order on every rank."""
    for name, grad in grads.items():
        if grid.tp > 1 and name.rsplit(".", 1)[-1] in over_tp:
            dist.all_reduce(grad, group=grid.tp_group)
        if grid.dp > 1:
            dist.all_reduce(grad, group=grid.dp_group)


def tp_loss_and_grads(local: Params, tokens: torch.Tensor, config: LlamaConfig, grid: EpGrid):
    """The whole batch's loss and this rank's gradients of its slices,
    reduced as the module docstring says (the loss after the gradients)."""
    loss, grads = llama._loss_and_grads(local, lambda p: tp_loss_fn(p, tokens, config, grid))
    _reduce_grads(grads, grid)
    if grid.dp > 1:
        dist.all_reduce(loss, group=grid.dp_group)
    return loss, grads


def make_tp_train_step(grid: EpGrid, config: LlamaConfig, device="cuda"):
    """Build the tensor-parallel training step on ``grid``. Returns ``(step,
    shard_params)``: ``shard_params(params)`` copies this rank's slice of
    the full parameters (``llama.params_from_numpy`` or ``init_params``
    output) onto ``device``; ``step(local, tokens, lr=1e-3)`` takes this
    rank's dp shard of the batch ([B / dp, S], the whole sequence) and is
    one SGD step, ``(local, loss)``, with the whole batch's loss on every
    rank and the slices updated IN PLACE (as ``llama.train_step``). Raises
    ``ValueError`` when the KV heads, the FFN's hidden columns, the
    vocabulary or (at a step) the sequence do not divide over tp, or the
    experts over ep."""
    dev = _ext.resolve_device(device)
    _check_layout(config, grid)

    def shard_params(params: Params) -> Dict:
        return {k: expert_parallel._local_slice(k, v, grid, _SPLITS)
                .to(device=dev, copy=True).contiguous() for k, v in params.items()}

    def step(local: Dict, tokens, lr: float = 1e-3):
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        loss, grads = tp_loss_and_grads(local, tokens, config, grid)
        llama._sgd_(local, grads, lr)
        return local, loss

    return step, shard_params
