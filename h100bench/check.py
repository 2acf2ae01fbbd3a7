"""The comparison that decides a run's ``correct``.

Once the window has closed and the program's state is freed, a sample of
the turns the program finished, drawn from the seed and holding the longest
of them, goes through the plain reference of the configuration's
architecture (``arch/<model_type>.py``): each prompt with the tokens the
program served after it, in one forward pass. At each served token the
reference's best logit and the logit of the served token are read; their
difference is the token's gap (0 where the program chose the reference's
best). The widest gap over the sample is compared with the cell's limit
(``cells/<cell>.json``). A stale, torn or foreign prefix
from the store, a wrong prefill or resumed suffix, a decode that misreads the
cache or a token altered on its way out all put a served token far below the
reference's best; bf16 rounding only swaps near ties.

The control (``control_gap``) reads, at the same positions, the gap of the
token that the reference computed in float8 puts first.
"""

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

# Served tokens the sample reaches for: some hundreds.
SAMPLE_TOKENS = 320


@dataclass
class Served:
    prompt: List[int]
    tokens: List[int]


def sample(turns: Sequence[Served], seed: int, min_tokens: int = SAMPLE_TOKENS) -> List[Served]:
    """The longest turn, then others drawn from the seed until the sample
    holds ``min_tokens`` served tokens (or every turn)."""
    if not turns:
        return []
    order = sorted(range(len(turns)), key=lambda i: -(len(turns[i].prompt) + len(turns[i].tokens)))
    first, rest = order[0], order[1:]
    rng = np.random.default_rng([seed, 3])
    rest = [rest[i] for i in rng.permutation(len(rest))]
    picked = [first]
    n = len(turns[first].tokens)
    for i in rest:
        if n >= min_tokens:
            break
        picked.append(i)
        n += len(turns[i].tokens)
    return [turns[i] for i in picked]


def _rows(t: Served) -> List[int]:
    # The logits at position p choose token p + 1: the first served token is
    # chosen at the prompt's last position.
    return list(range(len(t.prompt) - 1, len(t.prompt) - 1 + len(t.tokens)))


def _sequences(sample_: Sequence[Served]):
    # The last served token is never an input to a row compared.
    return [list(t.prompt) + list(t.tokens[:-1]) for t in sample_], [_rows(t) for t in sample_]


def gaps(ref, sample_: Sequence[Served], chosen: Optional[List[torch.Tensor]] = None
         ) -> np.ndarray:
    """Every served token's gap below the best logit of ``ref`` (a
    reference: ``logits(sequences, rows)``); with ``chosen``
    (per turn, the token ids another model puts first at the same rows) the
    gaps of those tokens instead."""
    seqs, rows = _sequences(sample_)
    logits = ref.logits(seqs, rows)
    out = []
    for i, (t, lg) in enumerate(zip(sample_, logits)):
        tok = (chosen[i] if chosen is not None
               else torch.as_tensor(t.tokens, dtype=torch.long, device=lg.device))
        best = lg.max(-1).values
        out.append((best - lg.gather(1, tok[:, None])[:, 0]).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def control_gap(ref, control, sample_: Sequence[Served]) -> float:
    """The widest gap of the tokens the control puts first, at the rows the
    program served."""
    seqs, rows = _sequences(sample_)
    chosen = [lg.argmax(-1) for lg in control.logits(seqs, rows)]
    return float(gaps(ref, sample_, chosen).max())
