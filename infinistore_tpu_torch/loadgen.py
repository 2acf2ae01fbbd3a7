"""Trace-driven serving load generator (docs/serving_load.md, ROADMAP-6).

Copy of ``infinistore_tpu/loadgen.py`` for the PyTorch port, which imports
nothing of ``infinistore_tpu``; keep the two in step (the same seed and
preset give the same trace JSON and prompts in both packages).

Every perf receipt before this module graded a uniform synthetic
workload, but wave economics are decided by SKEW: Ragged Paged Attention
is an argument about not paying for the skewed tail, and Zipf working
sets are the access shape millions of real users actually produce. This
module emits a deterministic, seeded, REPLAYABLE trace of an open-loop
serving workload so the engine harness, ``bench.py``'s serving leg, the
``benchmark.py --trace`` CLI mode, and the ``DisaggHarness`` all grade
against one traffic shape:

- **Zipf prefix popularity** over a synthetic million-user population:
  each request draws a shared-prefix family with P(rank k) proportional
  to 1/k^s — the head families dominate exactly as production prefix
  caches observe (system prompts, few-shot templates).
- **Log-normal lengths with a heavy tail**: prompt and output lengths
  are log-normal; a configurable outlier fraction multiplies the draw
  into the tail, and requests past ``bg_outlier_blocks`` total blocks
  are tagged ``PRIORITY_BACKGROUND`` (the QoS class the skew-aware wave
  flush policy's starvation bound keys on).
- **Diurnal rate curve + burst storms**: the open-loop arrival rate is
  ``base_rate_rps * diurnal(t) * burst(t)`` — a sinusoidal day cycle
  with storm windows that multiply the rate — sampled by thinning a
  homogeneous Poisson process, so arrivals stay deterministic per seed.
- **Mixed prefill/decode + shared-prefix reuse**: a configurable
  fraction of requests is prefill-only (``gen_tokens == 0``), and
  ``Trace.prompts`` materializes token lists as family prefix + unique
  suffix, so replay exercises real prefix hits.

The trace is a plain JSON document (``Trace.to_json``/``from_json``;
schema in docs/serving_load.md) — the replay side never re-runs the
generator, so a saved trace reproduces a result bit-for-bit later.

Concurrency (ITS-R audit): none. Generation and replay are pure
single-threaded functions over a seeded ``numpy`` Generator; the module
spawns no threads, holds no locks, and shares no mutable state — the
consumers (engine harness, bench legs) each own their Trace instance.
"""

import json
import math
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .wire import PRIORITY_BACKGROUND, PRIORITY_FOREGROUND

TRACE_VERSION = 1

# Named workload shapes (docs/serving_load.md). "skewed" is the default
# serving mix the bench leg grades the flush policy under; "uniform" is
# the null shape (no skew — a policy regression detector); "outlier_flood"
# keeps a permanent stream of heavy background outliers in flight — the
# starvation-bound leg (aging escapes must fire, never stranding).
PRESETS: Dict[str, dict] = {
    "skewed": dict(
        n_prefixes=64, zipf_s=1.2, base_rate_rps=200.0,
        prompt_blocks_mu=0.3, prompt_blocks_sigma=0.6,
        gen_tokens_mu=2.0, gen_tokens_sigma=0.8,
        outlier_frac=0.08, outlier_mult=4.0, bg_outlier_blocks=6,
        diurnal_amplitude=0.5, burst_prob_per_s=0.05, burst_mult=4.0,
        prefill_only_frac=0.3,
    ),
    "uniform": dict(
        n_prefixes=64, zipf_s=0.0, base_rate_rps=200.0,
        prompt_blocks_mu=0.7, prompt_blocks_sigma=0.0,
        gen_tokens_mu=2.0, gen_tokens_sigma=0.0,
        outlier_frac=0.0, outlier_mult=1.0, bg_outlier_blocks=10 ** 9,
        diurnal_amplitude=0.0, burst_prob_per_s=0.0, burst_mult=1.0,
        prefill_only_frac=0.3,
    ),
    "outlier_flood": dict(
        n_prefixes=16, zipf_s=1.2, base_rate_rps=200.0,
        prompt_blocks_mu=0.7, prompt_blocks_sigma=0.4,
        gen_tokens_mu=2.0, gen_tokens_sigma=0.6,
        outlier_frac=0.5, outlier_mult=4.0, bg_outlier_blocks=3,
        diurnal_amplitude=0.0, burst_prob_per_s=0.0, burst_mult=1.0,
        prefill_only_frac=0.0,
    ),
}


@dataclass(frozen=True)
class TraceRequest:
    """One open-loop arrival. Lengths are in engine units — prompt BLOCKS
    (complete blocks, the harness admission contract) and generated
    TOKENS — so the same trace replays against any ``block_tokens``."""

    t_s: float          # arrival offset from trace start (open loop)
    user: int           # synthetic user id (million-user population)
    prefix_id: int      # shared-prefix family (Zipf-popular rank)
    prefix_blocks: int  # blocks of the family's shared prefix
    prompt_blocks: int  # total prompt blocks (>= prefix_blocks)
    gen_tokens: int     # 0 = prefill-only request
    priority: int       # wire.PRIORITY_* (heavy-tail outliers ride BACKGROUND)
    burst: bool         # arrived inside a burst storm window


@dataclass
class Trace:
    """A replayable workload: metadata + the arrival list, JSON round-
    trippable (``save``/``load``) so a graded run can be reproduced from
    the artifact alone."""

    seed: int
    duration_s: float
    knobs: dict
    requests: List[TraceRequest] = field(default_factory=list)
    version: int = TRACE_VERSION

    def to_json(self) -> str:
        return json.dumps({
            "version": self.version,
            "seed": self.seed,
            "duration_s": self.duration_s,
            "knobs": self.knobs,
            "requests": [asdict(r) for r in self.requests],
        })

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        doc = json.loads(text)
        if doc.get("version") != TRACE_VERSION:
            raise ValueError(
                f"unsupported trace version {doc.get('version')!r} "
                f"(want {TRACE_VERSION})"
            )
        return cls(
            seed=doc["seed"],
            duration_s=doc["duration_s"],
            knobs=doc["knobs"],
            requests=[TraceRequest(**r) for r in doc["requests"]],
            version=doc["version"],
        )

    def save(self, path: str):
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_json(f.read())

    # -- materialization ----------------------------------------------------

    def prompts(
        self,
        block_tokens: int,
        vocab: int = 128,
        max_blocks: Optional[int] = None,
    ) -> List[List[int]]:
        """Deterministic token lists for every request: the family's
        shared prefix (same bytes for every request in the family — the
        prefix-cache hit surface) followed by a request-unique suffix.
        ``max_blocks`` clamps each prompt to the replay harness's
        per-request table size (prefix first, suffix truncated)."""
        out: List[List[int]] = []
        for i, r in enumerate(self.requests):
            n_blocks = r.prompt_blocks
            pre_blocks = min(r.prefix_blocks, n_blocks)
            if max_blocks is not None:
                n_blocks = min(n_blocks, max_blocks)
                pre_blocks = min(pre_blocks, n_blocks)
            pre = np.random.default_rng(
                (self.seed * 1_000_003 + r.prefix_id) & 0x7FFFFFFF
            ).integers(0, vocab, size=pre_blocks * block_tokens)
            suf = np.random.default_rng(
                (self.seed * 1_000_003 + 7_777_777 + i) & 0x7FFFFFFF
            ).integers(0, vocab, size=(n_blocks - pre_blocks) * block_tokens)
            out.append(np.concatenate([pre, suf]).astype(int).tolist())
        return out


def _zipf_cdf(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), s)
    return np.cumsum(w / w.sum())


def generate(
    seed: int = 0,
    duration_s: float = 2.0,
    users: int = 1_000_000,
    n_prefixes: int = 64,
    zipf_s: float = 1.2,
    base_rate_rps: float = 200.0,
    prompt_blocks_mu: float = 0.7,
    prompt_blocks_sigma: float = 0.6,
    max_prompt_blocks: int = 8,
    max_prefix_blocks: int = 3,
    gen_tokens_mu: float = 2.0,
    gen_tokens_sigma: float = 0.8,
    max_gen_tokens: int = 32,
    outlier_frac: float = 0.08,
    outlier_mult: float = 4.0,
    bg_outlier_blocks: int = 4,
    diurnal_amplitude: float = 0.5,
    diurnal_period_s: float = 1.0,
    burst_prob_per_s: float = 0.05,
    burst_len_s: float = 0.1,
    burst_mult: float = 4.0,
    prefill_only_frac: float = 0.3,
    max_requests: int = 100_000,
) -> Trace:
    """Generate a trace (see module docstring for the model). Everything
    is driven by ONE ``numpy`` Generator seeded from ``seed`` — the same
    seed and knobs produce the identical trace, byte for byte (tested).

    ``diurnal_period_s`` is the day length in TRACE seconds — traces are
    replayed time-scaled, so a 1 s "day" grades the same shape a 86400 s
    one would without a day-long bench. ``max_requests`` is a hard cap
    (rate knobs cannot runaway-allocate)."""
    rng = np.random.default_rng(seed)
    knobs = dict(
        users=users, n_prefixes=n_prefixes, zipf_s=zipf_s,
        base_rate_rps=base_rate_rps,
        prompt_blocks_mu=prompt_blocks_mu,
        prompt_blocks_sigma=prompt_blocks_sigma,
        max_prompt_blocks=max_prompt_blocks,
        max_prefix_blocks=max_prefix_blocks,
        gen_tokens_mu=gen_tokens_mu, gen_tokens_sigma=gen_tokens_sigma,
        max_gen_tokens=max_gen_tokens,
        outlier_frac=outlier_frac, outlier_mult=outlier_mult,
        bg_outlier_blocks=bg_outlier_blocks,
        diurnal_amplitude=diurnal_amplitude,
        diurnal_period_s=diurnal_period_s,
        burst_prob_per_s=burst_prob_per_s, burst_len_s=burst_len_s,
        burst_mult=burst_mult, prefill_only_frac=prefill_only_frac,
    )
    # Burst storm windows: a Bernoulli draw per second-of-trace opens a
    # window of burst_len_s at burst_mult x rate.
    storms = []
    t = 0.0
    while t < duration_s:
        if burst_prob_per_s > 0 and rng.random() < burst_prob_per_s:
            storms.append((t, t + burst_len_s))
        t += 1.0

    def in_storm(ts: float) -> bool:
        return any(a <= ts < b for a, b in storms)

    def rate(ts: float) -> float:
        r = base_rate_rps * (
            1.0 + diurnal_amplitude
            * math.sin(2.0 * math.pi * ts / diurnal_period_s)
        )
        if in_storm(ts):
            r *= burst_mult
        return max(r, 0.0)

    # Thinned Poisson arrivals: candidates at the max rate, accepted with
    # probability rate(t)/rate_max — the standard way to keep a time-
    # varying arrival process exactly reproducible from one rng stream.
    rate_max = base_rate_rps * (1.0 + abs(diurnal_amplitude)) * max(
        burst_mult if storms else 1.0, 1.0
    )
    zipf = _zipf_cdf(n_prefixes, zipf_s)
    # Per-family shared-prefix depth (deterministic in the family rank).
    prefix_depth = rng.integers(1, max_prefix_blocks + 1, size=n_prefixes)
    requests: List[TraceRequest] = []
    t = 0.0
    while len(requests) < max_requests:
        t += rng.exponential(1.0 / rate_max)
        if t >= duration_s:
            break
        if rng.random() >= rate(t) / rate_max:
            continue
        fam = int(np.searchsorted(zipf, rng.random()))
        pre = int(prefix_depth[fam])
        blocks = pre + int(round(rng.lognormal(
            prompt_blocks_mu, prompt_blocks_sigma
        )))
        gen = max(1, int(round(rng.lognormal(gen_tokens_mu, gen_tokens_sigma))))
        if rng.random() < outlier_frac:
            # The heavy tail: a multiplied draw, not a wider sigma — the
            # tail mass is a knob independent of the body's shape.
            blocks = int(blocks * outlier_mult)
            gen = int(gen * outlier_mult)
        blocks = min(max(blocks, 1), max_prompt_blocks)
        gen = min(gen, max_gen_tokens)
        if rng.random() < prefill_only_frac:
            gen = 0
        prio = (
            PRIORITY_BACKGROUND if blocks >= bg_outlier_blocks
            else PRIORITY_FOREGROUND
        )
        requests.append(TraceRequest(
            t_s=round(float(t), 6),
            user=int(rng.integers(0, users)),
            prefix_id=fam,
            prefix_blocks=min(pre, blocks),
            prompt_blocks=blocks,
            gen_tokens=gen,
            priority=prio,
            burst=in_storm(t),
        ))
    return Trace(seed=seed, duration_s=duration_s, knobs=knobs,
                 requests=requests)


def preset(name: str, seed: int = 0, **overrides) -> Trace:
    """Generate one of the named PRESETS shapes (docs/serving_load.md);
    ``overrides`` patch individual knobs (e.g. a shorter duration_s)."""
    if name not in PRESETS:
        raise ValueError(
            f"unknown preset {name!r} (have {sorted(PRESETS)})"
        )
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return generate(seed=seed, **kw)


async def replay(
    trace: Trace,
    harness,
    time_scale: float = 0.0,
    vocab: Optional[int] = None,
    concurrency: int = 16,
):
    """Replay a trace through a ``ContinuousBatchingHarness``: each
    request's ``run_request(prompt, gen_tokens, priority)`` fires at its
    arrival offset scaled by ``time_scale`` (0.0 = as fast as admission
    allows, preserving arrival ORDER — the closed-loop mode bench rounds
    use so wall time measures the engine, not the trace clock).
    Per-request failures surface as the exception objects in the
    returned list — a replay never hides a wrong-bytes verdict.

    Returns the per-request ``RequestStats`` in trace order."""
    import asyncio

    prompts = trace.prompts(
        harness.config.block_tokens,
        vocab=vocab if vocab is not None else harness.config.vocab,
        max_blocks=harness.max_req_blocks,
    )
    sem = asyncio.Semaphore(concurrency)

    async def one(req: TraceRequest, prompt: List[int]):
        if time_scale > 0:
            await asyncio.sleep(req.t_s * time_scale)
        gen = req.gen_tokens
        bt = harness.config.block_tokens
        # Clamp generation to the per-request table like prompts are.
        room = harness.max_req_blocks * bt - len(prompt)
        gen = min(gen, max(room, 0))
        async with sem:
            return await harness.run_request(
                prompt, gen_tokens=gen, priority=req.priority
            )

    return await asyncio.gather(
        *(one(r, p) for r, p in zip(trace.requests, prompts)),
        return_exceptions=True,
    )
