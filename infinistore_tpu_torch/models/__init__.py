"""Model family of the port: the small Llama-style transformer with a paged
KV cache (``llama.py``), mirroring ``infinistore_tpu/models``."""

from .llama import (
    LlamaConfig,
    decode_step,
    decode_step_batched,
    init_params,
    params_from_numpy,
    prefill,
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
]
