"""Model family of the port, mirroring ``infinistore_tpu/models``: the small
Llama-style transformer with a paged KV cache and its training step
(``llama.py``), and the paths over ``torch.distributed``: ring attention
(``ring_attention.py``), Ulysses attention (``ulysses.py``), the
long-context prefill (``long_context.py``), the GPipe pipeline
(``pipeline.py``), the expert-parallel MoE train step
(``expert_parallel.py``) and the tensor-parallel train step with
sequence-sharded activations (``tensor_parallel.py``). The sequence- and
tensor-parallel names resolve lazily, so importing ``models`` pulls in no
process group and compiles nothing; ``ring_attention`` itself is reached
through its module, whose name it shares, and the pipeline and
expert-parallel entry points through theirs."""

from .llama import (
    LlamaConfig,
    decode_step,
    decode_step_batched,
    decode_wave_layer,
    embed_prompt,
    embed_wave,
    init_params,
    lm_logits,
    loss_fn,
    params_from_numpy,
    prefill,
    prefill_continue,
    prefill_layer,
    speculative_verify,
    train_step,
    verify_step_batched,
)

_LAZY = {
    "ring_attention": ("dense_attention_reference",),
    "ulysses": ("ulysses_attention",),
    "long_context": ("prefill_ring",),
    "tensor_parallel": ("make_tp_train_step", "tp_loss_and_grads"),
}
_WHERE = {name: mod for mod, names in _LAZY.items() for name in names}


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


__all__ = [
    "LlamaConfig",
    "init_params",
    "params_from_numpy",
    "prefill",
    "prefill_continue",
    "speculative_verify",
    "decode_step",
    "decode_step_batched",
    "verify_step_batched",
    "embed_prompt",
    "prefill_layer",
    "lm_logits",
    "embed_wave",
    "decode_wave_layer",
    "loss_fn",
    "train_step",
    *sorted(_WHERE),
]
