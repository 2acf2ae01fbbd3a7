"""What one run recorded, and the window arithmetic the metric readers share.

Every time is the host's performance counter, in seconds. A turn counts
toward a metric by where its event falls in the window [start, end):

- TTFT: the turns whose first token came in the window;
- a turn's latency and time per output token: the turns that returned in
  the window;
- tokens: each token stamped in the window (``Turn.steps``);
- attempted and failed: the turns sent in the window.

Turns sent during warm-up that reach into the window count by the same
rules; turns still in flight at the close finish (the drain) and count only
for what fell inside.
"""

from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Step:
    """One return of the engine's decode call for a turn: the row's position
    and the host time its result was on the host."""

    position: int
    t: float


@dataclass
class Turn:
    prompt: List[int]
    gen: int
    t_send: float
    t_return: Optional[float] = None
    steps: List[Step] = field(default_factory=list)
    stats: Any = None  # the engine's RequestStats
    generated: Optional[List[int]] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None and self.t_return is not None

    @property
    def token_times(self) -> List[float]:
        """Stamps of the generated tokens: the first ``gen`` decode returns
        (a last return past them writes the final token's K and V and
        emits nothing)."""
        return [s.t for s in self.steps[: self.gen]]

    @property
    def first_token(self) -> Optional[float]:
        return self.steps[0].t if self.steps else None


@dataclass
class Run:
    shapes: Any  # the architecture's work object (``arch/<model_type>.py``'s ``shapes``)
    start: float  # window
    end: float
    turns: List[Turn]
    saves: List[Tuple[float, float, int]]  # (start, end, bytes) of save_kv calls
    loads: List[Tuple[float, float, int]]  # (start, end, bytes) of install_kv / load_kv
    setup_s: float = 0.0  # process start to the window's start
    trace: Any = None  # trace.Summary of a --trace 1 run
    trace_span: Optional[Tuple[float, float]] = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def inside(self, t: Optional[float]) -> bool:
        return t is not None and self.start <= t < self.end

    def sent(self) -> List[Turn]:
        return [t for t in self.turns if self.inside(t.t_send)]

    def first_token_in_window(self) -> List[Turn]:
        return [t for t in self.turns if t.ok and self.inside(t.first_token)]

    def returned_in_window(self) -> List[Turn]:
        return [t for t in self.turns if t.ok and self.inside(t.t_return)]

    def tokens_in_window(self) -> int:
        return sum(1 for t in self.turns for s in t.token_times if self.inside(s))

    @staticmethod
    def percentile(values: Sequence[float], q: float) -> Optional[float]:
        """numpy's linear interpolation between order statistics; None for
        no values."""
        return float(np.percentile(np.asarray(values, dtype=np.float64), q)) if len(values) else None

    def prefix_ready(self, turn: Turn) -> float:
        """When the turn's whole prompt was resident on the device."""
        return turn.t_send + turn.stats.prefix_ready_us / 1e6

    def loaded_tokens(self, turn: Turn) -> int:
        """Prompt tokens the turn's hit brought back from the store."""
        return turn.stats.loaded_blocks * self.shapes.block_tokens
