"""One module per model architecture, ``arch/<model_type>.py``, found by the
``model_type`` key of the configuration file. A module gives:

- ``shapes(cfg)``: a frozen work object with ``block_tokens`` and the counts
  the readers and the pool sizing call: ``kv_bytes_per_token()``,
  ``block_bytes()``, ``matmul_params()``, ``token_flops(context, logits)``,
  ``prefill_flops(start, n, logits_rows)``, ``decode_attention_work(position)``
  and ``resume_attention_work(start, n)`` (the last two give (bytes, flops));
- ``program(cfg, device)``: the port's model configuration;
- ``params(cfg, seed, device, dtype)``: the program's weights, drawn from
  the seed through ``weights.py``;
- ``reference(cfg, seed, device, weight_dtype, quant=None)``: the plain
  reference, an object with ``logits(sequences, rows)``; ``quant="fp8"`` is
  the control.

A new architecture is a new module here, with its reference under
``reference/``; nothing else in the benchmark names one.
"""

import importlib
import pkgutil
from typing import List


def known() -> List[str]:
    """The model types that have a module."""
    return sorted(m.name for m in pkgutil.iter_modules(__path__) if not m.name.startswith("_"))


def find(model_type: str):
    """The module of ``model_type``; a KeyError that names the known ones if
    it has none."""
    have = known()
    if model_type not in have:
        raise KeyError(f"no architecture module for model_type {model_type!r} "
                       f"(h100bench/arch/ has {have})")
    return importlib.import_module(f"{__name__}.{model_type}")
