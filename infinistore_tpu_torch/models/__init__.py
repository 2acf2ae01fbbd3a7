"""Model family of the port: the small Llama-style transformer with a paged
KV cache (``llama.py``), mirroring ``infinistore_tpu/models``."""

from .llama import (
    LlamaConfig,
    decode_step,
    decode_step_batched,
    decode_wave_layer,
    embed_prompt,
    embed_wave,
    init_params,
    lm_logits,
    params_from_numpy,
    prefill,
    prefill_layer,
    verify_step_batched,
)

__all__ = [
    "LlamaConfig",
    "init_params",
    "params_from_numpy",
    "prefill",
    "decode_step",
    "decode_step_batched",
    "verify_step_batched",
    "embed_prompt",
    "prefill_layer",
    "lm_logits",
    "embed_wave",
    "decode_wave_layer",
]
