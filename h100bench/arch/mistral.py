"""Mistral (``model_type`` ``mistral``): the Llama block."""

from .llama import params, program, reference, shapes  # noqa: F401
