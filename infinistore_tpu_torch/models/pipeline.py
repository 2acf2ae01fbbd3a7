"""GPipe-style pipeline parallelism over the ranks of a ``torch.distributed``
process group (port of ``infinistore_tpu/models/pipeline.py``).

Layers split into S stages, one stage a rank; a batch splits into M
microbatches that flow through the stages over M + S - 1 ticks (the classic
GPipe fill, steady state and drain). At each tick every rank runs its
stage's layers and hands its activations to the next stage (one
``ring_attention._Hop`` a tick, the reference's ``ppermute`` over the
permutation ``(i, i + 1)``: stage 0 receives zeros, the last stage sends
nothing). The math is the dense
forward's, through the shared ``_kv_proj`` / ``_block`` with an explicit
causal mask, so the pipelined loss equals ``llama.loss_fn`` and a training
step is the gradient of this loss: autograd differentiates each rank's
ticks, and each hop's backward sends the gradient of what arrived back to
the stage it came from (the reference's ppermute transposes to the reverse
permutation).

The JAX package runs one SPMD program under ``shard_map``; here each rank
is a process of its own holding its stage's stacked weights (a leading
local dim of 1, as ``shard_map`` gives each shard) and the replicated
``embed`` / ``final_norm`` / ``lm_head``. The reference reaches no Pallas
kernel, and neither does this module.
"""

from typing import Dict

import torch
import torch.distributed as dist

from ..cuda import _ext
from . import llama
from .llama import LlamaConfig, Params
from .ring_attention import _group_of, _Hop

# Per-layer weight names (dense FFN config; MoE adds its own, the pipeline
# keeps to the dense variant, as the reference does).
_LAYER_WEIGHTS = ("attn_norm", "wq", "wk", "wv", "wo", "ffn_norm", "w_gate_up", "w_down")
_SHARED = ("embed", "final_norm", "lm_head")


def stack_stage_params(params: Params, config: LlamaConfig, stages: int) -> Dict:
    """Restack flat per-layer params into stage-major tensors.

    Per-layer weights become ``[stages, layers_per_stage, ...]`` (stage s is
    rank s's); embed/final_norm/lm_head stay as they are (replicated).
    Requires ``n_layers % stages == 0`` and a dense (non-MoE) config."""
    if config.n_experts > 0:
        raise ValueError("pipeline demo covers the dense FFN config")
    if config.n_layers % stages != 0:
        raise ValueError(f"n_layers={config.n_layers} not divisible by {stages} stages")
    lps = config.n_layers // stages
    out: Dict = {name: params[name] for name in _SHARED}
    for w in _LAYER_WEIGHTS:
        out[w] = torch.stack([
            torch.stack([params[f"l{s * lps + i}.{w}"] for i in range(lps)])
            for s in range(stages)
        ])
    return out


def _stage_forward(stage_params, x, positions, mask, config: LlamaConfig):
    """Apply this stage's layers_per_stage layers to x (the dense loss_fn's
    loop, through the shared ``_kv_proj`` / ``_block``)."""
    for i in range(stage_params["wq"].shape[0]):
        layer_view = {f"l0.{w}": stage_params[w][i] for w in _LAYER_WEIGHTS}
        k, v = llama._kv_proj(layer_view, 0, x, positions, config)
        x = llama._block(layer_view, 0, x, k, v, positions, mask, config)
    return x


def pp_loss_fn(
    local: Dict,
    tokens: torch.Tensor,  # [B, S] int, the same on every rank
    config: LlamaConfig,
    stages: int,
    microbatches: int,
    group=None,
):
    """This rank's tick loop of the pipelined next-token loss.

    ``local``: this stage's stacked per-layer weights (leading local dim of
    1) and the replicated weights. Returns ``(share, carry)``: this rank's
    share of the loss (the last stage's NLL sum over B * (S - 1); the loss
    is the shares' sum over the group, zero elsewhere) and the last tick's
    received activations. The carry feeds nothing, but its backward, with a
    zero cotangent, runs the last hop's reverse, so that every rank posts
    the same backward transfers (the reference's scan discards its final
    carry the same way)."""
    world, stage, peers = _group_of("pp_loss_fn", group)
    if world != stages:
        raise ValueError(f"the group has {world} ranks but stages={stages}")
    b, s = tokens.shape
    if b % microbatches:
        raise ValueError(f"batch {b} must split evenly into {microbatches} microbatches")
    mb = b // microbatches
    tok_mb = tokens.reshape(microbatches, mb, s)
    positions, mask = llama._causal(mb, s, tokens.device)
    layers = {w: local[w][0] for w in _LAYER_WEIGHTS}  # [lps, ...]
    nxt = peers[stage + 1] if stage < stages - 1 else None
    prv = peers[stage - 1] if stage > 0 else None
    first = torch.tensor(stage == 0, device=tokens.device)
    recv = torch.zeros((mb, s, config.dim), dtype=local["embed"].dtype, device=tokens.device)
    share = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for t in range(microbatches + stages - 1):
        # Stage 0 ingests microbatch t (clamped during the drain); later
        # stages consume what the previous stage sent last tick. The where
        # keeps the received tensor in every rank's graph, so stage 0 also
        # runs the reverse of each hop it took part in.
        x0 = local["embed"][tok_mb[min(t, microbatches - 1)]]
        y = _stage_forward(layers, torch.where(first, x0, recv), positions, mask, config)
        if stages > 1:
            # The reference's ppermute over (i, i + 1): one node a tick
            # (ring_attention._Hop), so every rank's backward transfers
            # run in one order.
            pending = []
            recv, = _Hop.apply(group, nxt, prv, pending, y)
            for req in pending:
                req.wait()
        # The last stage finishes microbatch t - (S - 1) at tick t.
        if stage == stages - 1 and t >= stages - 1:
            tok_out = tok_mb[min(t - (stages - 1), microbatches - 1)]
            share = share + llama._next_token_nll(local, y, tok_out).sum()
    return share / (b * (s - 1)), recv


def pp_loss_and_grads(local: Dict, tokens: torch.Tensor, config: LlamaConfig, stages: int,
                      microbatches: int, group=None):
    """The pipelined loss (the same on every rank) and this rank's
    gradients of ``local``.

    The replicated embed/final_norm/lm_head take the SUM of their per-stage
    gradients (the transpose ``shard_map`` gives a replicated input), so
    every rank's copies stay equal. The loss is reduced across the stages
    after the gradients are taken, so that reduction scales no gradient."""
    leaves = {k: p.detach().requires_grad_() for k, p in local.items()}
    share, carry = pp_loss_fn(leaves, tokens, config, stages, microbatches, group)
    roots = [(t, torch.full_like(t, fill)) for t, fill in ((share, 1.0), (carry, 0.0))
             if t.requires_grad]
    grads = torch.autograd.grad([t for t, _ in roots], list(leaves.values()),
                                [g for _, g in roots], allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), grads)}
    for name in _SHARED:
        dist.all_reduce(grads[name], group=group)
    loss = share.detach().clone()
    dist.all_reduce(loss, group=group)
    return loss, grads


def make_pp_train_step(group, config: LlamaConfig, stages: int, microbatches: int,
                       device="cuda"):
    """Build a pipeline training step over ``group`` (its size must be
    ``stages``; this rank is the stage of its group rank). Returns ``(step,
    shard_params)``: ``shard_params(stacked)`` copies this rank's share of
    ``stack_stage_params``' output onto ``device``; ``step(local, tokens,
    lr=1e-3)`` is one SGD step through ``pp_loss_and_grads``, ``(local,
    loss)``, with the loss the same on every rank and the weights updated IN
    PLACE (as ``llama.train_step``)."""
    dev = _ext.resolve_device(device)
    world, stage, _peers = _group_of("make_pp_train_step", group)
    if world != stages:
        raise ValueError(
            f"the group has {world} ranks but stages={stages}; each stage is one rank")

    def shard_params(stacked: Dict) -> Dict:
        return {k: (v[stage:stage + 1] if k in _LAYER_WEIGHTS else v).to(device=dev, copy=True)
                for k, v in stacked.items()}

    def step(local: Dict, tokens, lr: float = 1e-3):
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        loss, grads = pp_loss_and_grads(local, tokens, config, stages, microbatches, group)
        llama._sgd_(local, grads, lr)
        return local, loss

    return step, shard_params
