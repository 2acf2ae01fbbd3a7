"""Closed-loop multi-turn chat sessions.

A fixed number of sessions is in flight. Each is one user who sends the next
turn the moment the answer returns. Every session opens with one system
prompt shared by all sessions; each turn's prompt is the conversation so
far (the previous prompt, the tokens actually generated, the new user
turn). A session ends after ``max_turns`` turns, or when its next prompt
plus the answer drawn for it would pass the configuration's context cap;
a new session takes its slot.

The sizes are the same for every seed. ``templates`` session shapes (the
lengths of every turn) are drawn once from ``sizes_seed`` with the seeded
log-normal arithmetic of the port's trace generator (``loadgen.py``: a
median and a sigma, rounded, clipped), each rounded to whole cache blocks.
Sessions start in rounds of ``templates``: each round runs every shape
once, in an order drawn from ``--seed``. The seed also draws the token ids,
from the configuration's vocabulary: the system prompt once, and each
session's user turns from a generator of its own, so a session's inputs do
not depend on which slot ran it or when.

The sessions in flight at the start are taken at depths spread evenly over
their turns, as in a loop that has run for a while: session ``k`` of the
first ``sessions_in_flight`` opens at turn ``k * turns // sessions_in_flight``
with the conversation before it drawn from the seed (a conversation resumed
on this engine, so its first turn loads only the system prompt). Otherwise
every slot would start a first turn at once and end its session near the
others, and the window would see that wave instead of the loop's own mix.
"""

import asyncio
import itertools
import math
from typing import Awaitable, Callable, List, Optional, Sequence, Tuple

import numpy as np


def _length(rng: np.random.Generator, spec: dict, block: int) -> int:
    """A seeded log-normal draw (median, sigma), clipped, in whole blocks."""
    n = int(round(rng.lognormal(math.log(spec["median"]), spec["sigma"])))
    n = min(max(n, spec["min"]), spec["max"])
    return max(block, int(round(n / block)) * block)


def session_shapes(params: dict, max_context: int, block: int) -> List[List[Tuple[int, int]]]:
    """``templates`` sessions, each a list of (user tokens, answer tokens) a
    turn, drawn from ``sizes_seed``. A session keeps every turn's prompt plus
    answer within ``max_context``."""
    rng = np.random.default_rng(params["sizes_seed"])
    system = params["system_prompt_tokens"]
    shapes = []
    for _ in range(params["templates"]):
        turns = []
        prompt = system
        for t in range(params["max_turns"]):
            user = _length(rng, params["user_turn_tokens"], block)
            answer = _length(rng, params["answer_tokens"], block)
            if turns:
                prompt += turns[-1][1] + user
            else:
                prompt += user
            if prompt + answer > max_context:
                break
            turns.append((user, answer))
        if not turns:
            raise ValueError("a session's first turn passes the context cap")
        shapes.append(turns)
    return shapes


class Sessions:
    """The traffic of one run: ``drive`` sends it through ``send``."""

    def __init__(self, params: dict, seed: int, vocab: int, max_context: int, block: int):
        self.in_flight = params["sessions_in_flight"]
        self.warmup_turns = params["warmup_turns"]
        self.shapes = session_shapes(params, max_context, block)
        self.seed = seed
        self.vocab = vocab
        self.system = np.random.default_rng([seed, 0]).integers(
            0, vocab, params["system_prompt_tokens"]).tolist()
        self._orders = {}

    def shape_of(self, k: int) -> List[Tuple[int, int]]:
        """Session ``k``'s turns: round ``k // templates`` runs every shape
        once, in an order drawn from the seed."""
        n = len(self.shapes)
        r = k // n
        if r not in self._orders:
            self._orders[r] = np.random.default_rng([self.seed, 1, r]).permutation(n)
        return self.shapes[int(self._orders[r][k % n])]

    def user_turns(self, k: int) -> List[List[int]]:
        """Session ``k``'s user turns as token ids."""
        rng = np.random.default_rng([self.seed, 2, k])
        return [rng.integers(0, self.vocab, user).tolist() for user, _ in self.shape_of(k)]

    def opening(self, k: int) -> Tuple[int, List[int]]:
        """(the turn session ``k`` opens at, the conversation before it)."""
        turns = self.shape_of(k)
        first = k * len(turns) // self.in_flight if k < self.in_flight else 0
        rng = np.random.default_rng([self.seed, 3, k])
        history = list(self.system)
        for user, (_, answer) in zip(self.user_turns(k)[:first], turns):
            history += user + rng.integers(0, self.vocab, answer).tolist()
        return first, history

    async def drive(
        self,
        send: Callable[[Sequence[int], int], Awaitable[Optional[List[int]]]],
        keep_going: Callable[[], bool],
    ) -> None:
        """Run the sessions until ``keep_going()`` turns false; each slot's
        turn in flight then finishes. ``send(prompt, answer_tokens)`` returns
        the generated tokens, or None for a turn that failed, which ends its
        session."""
        next_session = itertools.count()

        async def slot():
            while keep_going():
                k = next(next_session)
                first, prompt = self.opening(k)
                users = self.user_turns(k)
                turns = self.shape_of(k)
                for t in range(first, len(users)):
                    if not keep_going():
                        return
                    prompt = prompt + users[t]
                    got = await send(prompt, turns[t][1])
                    if got is None:
                        break
                    prompt = prompt + list(got)

        await asyncio.gather(*(slot() for _ in range(self.in_flight)))


def build(params: dict, seed: int, vocab: int, max_context: int, block: int) -> Sessions:
    return Sessions(params, seed, vocab, max_context, block)
