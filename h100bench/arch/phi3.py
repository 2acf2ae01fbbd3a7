"""Phi-3 (``model_type`` ``phi3``): the Llama block, its fused qkv and gate_up
projections held split (the same arithmetic)."""

from .llama import params, program, reference, shapes  # noqa: F401
