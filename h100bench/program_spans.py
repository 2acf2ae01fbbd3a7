"""The program's own phase spans in a run of a cell, on the benchmark's clock,
and what the per-layer metrics read of them.

The program (``infinistore_tpu_torch.tracing``) stamps CLOCK_MONOTONIC
microseconds; ``tracing.perf_counter_offset_s`` maps a stamp onto the
host's performance counter, the clock of every ``records.Run`` time and of
the device trace (``trace.DeviceTrace`` maps the profiler's events onto
it). That mapping drifts: on the H100 the profiler's device events run
late of the host's clock by up to several ms, growing by 1-3 ms a second
until the profiler's device clock jumps back. ``clock_pairs`` measures the
lag all through the span from the program's own token copies and
``aligned`` takes it out. ``ProgramSpans`` holds the spans so mapped,
whether the recorder lost any span that finished in the window, and the
device's busy intervals over the traced span, aligned.

Idle time by program state: each idle moment of the device in the traced
span goes to the first of ``IDLE_STATES`` whose spans are open then:

- ``wave_launch``: a ``model.wave`` between its ``acquire`` and ``launched``;
- ``model_launch``: a ``model.prefill`` or ``model.resume`` open;
- ``gate_held``: an exclusive ``engine.gate`` of kind install, load, prefill
  or resume held (its ``acquire`` to its end);
- ``loop_blocked``: a ``loop.block`` open;
- ``store_io``: a ``store.*`` wire op open;
- ``none``: none of these.

The states never overlap, and together they are the device's idle time.

A program without these spans (one that records none) gives no
``ProgramSpans``; every reader then returns None.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IDLE_STATES = ("wave_launch", "model_launch", "gate_held", "loop_blocked", "store_io", "none")
GATE_KINDS_HELD = ("install", "load", "prefill", "resume")
# K6, the ragged decode kernel of the engine's waves (cuda/csrc).
WAVE_KERNEL = "paged_decode_ragged"


@dataclass
class Span:
    name: str
    trace_id: int
    span_id: int
    parent_id: int
    start: float  # host performance-counter seconds
    end: float
    stages: List[Tuple[str, float]] = field(default_factory=list)
    attrs: dict = field(default_factory=dict)

    def at(self, stage: str) -> Optional[float]:
        """The first stamp of ``stage``, or None."""
        for name, t in self.stages:
            if name == stage:
                return t
        return None

    def all(self, stage: str) -> List[float]:
        return [t for name, t in self.stages if name == stage]


@dataclass
class ProgramSpans:
    spans: List[Span]
    lost_in_window: bool  # the recorder overwrote a span that finished in the window
    busy: Optional[List[Tuple[float, float]]] = None  # device activity, traced span
    traced: Optional[Tuple[float, float]] = None  # the traced span

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


def mapped(records: Sequence[dict], offset_s: float) -> List[Span]:
    """The recorder's span dicts (``FlightRecorder.snapshot``) on the
    performance counter: ``t_us / 1e6 + offset_s``."""
    out = []
    for r in records:
        to = lambda us: us / 1e6 + offset_s  # noqa: E731
        out.append(Span(
            name=r["name"], trace_id=r["trace_id"], span_id=r["span_id"],
            parent_id=r["parent_id"], start=to(r["start_us"]), end=to(r["end_us"]),
            stages=[(s, to(t)) for s, t in r["stages"]], attrs=dict(r["attrs"])))
    return out


def lost_in_window(spans: Sequence[Span], dropped: int, window_start: float) -> bool:
    """Whether a span that finished at or after ``window_start`` may have been
    overwritten: the ring keeps the latest spans to finish, so none was lost
    there if the oldest kept span finished before the window."""
    if dropped <= 0:
        return False
    return not spans or min(s.end for s in spans) >= window_start


def of_run(run) -> Optional[ProgramSpans]:
    """The run's program spans, or None where the program recorded none or
    the recorder lost spans of the window."""
    ps = getattr(run, "spans", None)
    if ps is None or not ps.spans or ps.lost_in_window:
        return None
    return ps


# -- turns, saves, tokens ------------------------------------------------------


def turns_in_window(ps: ProgramSpans, start: float, end: float) -> List[Span]:
    """``engine_request`` spans whose first ``token`` stamp fell in [start, end)."""
    out = []
    for s in ps.named("engine_request"):
        first = s.at("token")
        if first is not None and start <= first < end and s.at("enqueue") is not None:
            out.append(s)
    return out


def ttft_saves(ps: ProgramSpans, turns: Sequence[Span]) -> Dict[int, List[Span]]:
    """Each turn's ``engine.save`` spans of path ``ttft``, by request span id."""
    ids = {t.span_id for t in turns}
    out: Dict[int, List[Span]] = {i: [] for i in ids}
    for s in ps.named("engine.save"):
        if s.attrs.get("path") == "ttft" and s.parent_id in ids:
            out[s.parent_id].append(s)
    return out


def union_s(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of intervals."""
    total, edge = 0.0, None
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if edge is None or a > edge:
            total += b - a
            edge = b
        elif b > edge:
            total += b - edge
            edge = b
    return total


def save_wire_s(ps: ProgramSpans, save: Span) -> Optional[float]:
    """The union of the save's ``store.*`` children's submit -> completion."""
    wire = []
    for s in ps.spans:
        if s.parent_id == save.span_id and s.name.startswith("store."):
            a, b = s.at("submit"), s.at("completion_ring")
            if a is not None and b is not None:
                wire.append((a, b))
    return union_s(wire) if wire else None


def token_gaps(ps: ProgramSpans, start: float, end: float) -> List[float]:
    """Seconds between consecutive ``token`` stamps of each request, for the
    gaps whose later stamp fell in [start, end)."""
    out = []
    for s in ps.named("engine_request"):
        toks = s.all("token")
        out += [b - a for a, b in zip(toks, toks[1:]) if start <= b < end]
    return out


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """numpy's linear interpolation (as ``records.Run.percentile``)."""
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


# -- device idle time by program state ------------------------------------------


def state_intervals(ps: ProgramSpans) -> Dict[str, List[Tuple[float, float]]]:
    """The intervals of each state but ``none`` (module docstring)."""
    out: Dict[str, List[Tuple[float, float]]] = {k: [] for k in IDLE_STATES[:-1]}
    for s in ps.spans:
        n = s.name
        if n == "model.wave":
            a, b = s.at("acquire"), s.at("launched")
            if a is not None:
                out["wave_launch"].append((a, b if b is not None else s.end))
        elif n in ("model.prefill", "model.resume"):
            out["model_launch"].append((s.start, s.end))
        elif n == "engine.gate":
            a = s.at("acquire")
            if (a is not None and s.attrs.get("exclusive")
                    and s.attrs.get("kind") in GATE_KINDS_HELD):
                out["gate_held"].append((a, s.end))
        elif n == "loop.block":
            out["loop_blocked"].append((s.start, s.end))
        elif n.startswith("store."):
            out["store_io"].append((s.start, s.end))
    return out


def idle_by_state(busy: Sequence[Tuple[float, float]], t0: float, t1: float,
                  states: Dict[str, List[Tuple[float, float]]]) -> Dict[str, float]:
    """Idle seconds of [t0, t1] (outside ``busy``) in each of ``IDLE_STATES``,
    the first state open taking each moment; one sweep over every edge."""
    order = IDLE_STATES[:-1]
    edges = []
    for i, name in enumerate(order):
        for a, b in states.get(name, ()):
            a, b = max(a, t0), min(b, t1)
            if b > a:
                edges += [(a, i, 1), (b, i, -1)]
    busy_slot = len(order)
    for a, b in busy:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            edges += [(a, busy_slot, 1), (b, busy_slot, -1)]
    edges.sort(key=lambda e: e[0])
    live = [0] * (len(order) + 1)
    out = {k: 0.0 for k in IDLE_STATES}
    prev = t0
    for t, slot, d in edges + [(t1, None, 0)]:
        if t > prev and live[busy_slot] == 0:
            state = next((order[i] for i in range(len(order)) if live[i] > 0), "none")
            out[state] += t - prev
        prev = max(prev, t)
        if slot is not None:
            live[slot] += d
    return out


def idle_program(ps: Optional[ProgramSpans]) -> Optional[Dict[str, float]]:
    """Idle seconds of the traced span by program state, or None without
    spans or a device trace."""
    if ps is None or ps.busy is None or ps.traced is None:
        return None
    t0, t1 = ps.traced
    return idle_by_state(ps.busy, t0, t1, state_intervals(ps))


def idle_share(run, state: str) -> Optional[float]:
    """Percent of the traced span the device idled in ``state``."""
    ps = of_run(run)
    idle = idle_program(ps)
    if idle is None:
        return None
    t0, t1 = ps.traced
    return 100.0 * idle[state] / (t1 - t0) if t1 > t0 else None


# -- the device's events on the host's clock ------------------------------------

# The device-to-host copy of each round's argmaxes (``engine._generate``), a
# copy to pageable memory: the program's only one on the serving path.
TOKEN_COPY = "Memcpy DtoH (Device -> Pageable)"
# A change of shift between two neighbouring pairs above this is a jump of the
# profiler's device clock, not drift: no interpolation across it.
CLOCK_JUMP_S = 0.5e-3


def clock_pairs(ps: ProgramSpans, events: Sequence,
                max_skip: int = 4) -> List[Tuple[float, float]]:
    """(device time, host end - device end) for each round's token copy in
    the traced span: the program's ``loop.block`` spans of ``what`` ``token``
    (the copy's wait on the host) paired in order with the device's
    ``TOKEN_COPY`` events. Each copy ends just before its wait does (tens of
    µs), so the second number is how far the profiler's mapping of the
    device's events lags the host's clock there. The two lists may differ by
    a few at the span's edges: the pairing skips the leading items of either
    list (up to ``max_skip``) that leave the smoothest run of shifts, and of
    those the smallest."""
    if ps is None or ps.traced is None:
        return []
    t0, t1 = ps.traced
    margin = 0.05
    blocks = sorted(s.end for s in ps.spans
                    if s.name == "loop.block" and s.attrs.get("what") == "token"
                    and t0 <= s.end <= t1)
    copies = sorted(e.start + e.dur for e in events
                    if TOKEN_COPY in e.name and t0 - margin <= e.start + e.dur <= t1 + margin)
    best = None
    for k in range(-max_skip, max_skip + 1):
        b, c = (blocks[k:], copies) if k >= 0 else (blocks, copies[-k:])
        n = min(len(b), len(c))
        if n < 2:
            continue
        shifts = [hb - dc for hb, dc in zip(b[:n], c[:n])]
        # Smoothest first; among runs equally smooth, the smallest lag.
        key = float(np.median(np.abs(np.diff(shifts)))) + 0.01 * float(
            np.median(np.abs(shifts)))
        if best is None or key < best[0]:
            best = (key, list(zip(c[:n], shifts)))
    return best[1] if best else []


def aligned(events: Sequence, pairs: Sequence[Tuple[float, float]]) -> list:
    """``events`` moved onto the host's clock by ``clock_pairs``' shifts:
    interpolated between neighbouring pairs, the nearest pair's across a
    jump (``CLOCK_JUMP_S``) and beyond the first or last pair. Unchanged
    without pairs."""
    if not pairs:
        return list(events)
    times = [t for t, _ in pairs]
    out = []
    for e in events:
        i = int(np.searchsorted(times, e.start))
        if i == 0 or i == len(pairs):
            shift = pairs[min(i, len(pairs) - 1)][1]
        else:
            (ta, sa), (tb, sb) = pairs[i - 1], pairs[i]
            if abs(sb - sa) <= CLOCK_JUMP_S and tb > ta:
                shift = sa + (sb - sa) * (e.start - ta) / (tb - ta)
            else:
                shift = sa if e.start - ta <= tb - e.start else sb
        out.append(type(e)(e.name, e.start + shift, e.dur))
    return out


# -- one wave against the device trace -------------------------------------------


def wave_kernels(ps: ProgramSpans, events: Sequence, n_layers: int) -> List[dict]:
    """For each wave in the traced span whose rows' next ``token`` stamps are
    known: its ``acquire``, the earliest of those stamps, and the last
    ``n_layers`` K6 kernels that started before that stamp (one a layer: the
    wave's own). Checks on the mapped clock that the wave's first kernel
    starts after ``acquire`` and its last ends before the stamp."""
    if ps is None or ps.traced is None:
        return []
    t0, t1 = ps.traced
    k6 = sorted((e for e in events if WAVE_KERNEL + "<" in e.name or e.name == WAVE_KERNEL),
                key=lambda e: e.start)
    starts = [e.start for e in k6]
    by_trace: Dict[int, Span] = {s.trace_id: s for s in ps.named("engine_request")}
    out = []
    for w in ps.named("model.wave"):
        acq, launched = w.at("acquire"), w.at("launched")
        if acq is None or launched is None or not (t0 <= acq and launched <= t1):
            continue
        tokens = []
        for tid in w.attrs.get("requests", ()):
            req = by_trace.get(tid)
            later = [t for t in req.all("token") if t >= launched] if req else []
            if later:
                tokens.append(later[0])
        if not tokens:
            continue
        first_token = min(tokens)
        n = int(np.searchsorted(starts, first_token))
        if n < n_layers:
            continue
        mine = k6[n - n_layers : n]
        last_end = max(e.start + e.dur for e in mine)
        out.append({
            "acquire": acq, "launched": launched, "first_kernel": mine[0].start,
            "last_kernel_end": last_end, "first_token": first_token,
            "rows": w.attrs.get("rows"),
            "acquire_before_kernel": mine[0].start > acq,
            "kernels_before_token": last_end < first_token,
        })
    return out


def chrome_events(spans: Sequence[Span], events: Sequence, t_lo: float,
                  t_hi: float) -> List[dict]:
    """Chrome trace events (µs on the performance counter) of the spans and
    device events that overlap [t_lo, t_hi]: program spans on process 0, one
    thread a trace, stamps as instants; device activity on process 1."""
    out = []
    for s in spans:
        if s.end < t_lo or s.start > t_hi:
            continue
        tid = s.trace_id % 100000
        out.append({"name": s.name, "ph": "X", "ts": s.start * 1e6,
                    "dur": max(0.0, s.end - s.start) * 1e6, "pid": 0, "tid": tid,
                    "args": {k: v for k, v in s.attrs.items() if not isinstance(v, list)}})
        out += [{"name": n, "ph": "i", "s": "t", "ts": t * 1e6, "pid": 0, "tid": tid}
                for n, t in s.stages if t_lo <= t <= t_hi]
    out += [{"name": e.name[:120], "ph": "X", "ts": e.start * 1e6, "dur": e.dur * 1e6,
             "pid": 1, "tid": 0} for e in events if e.start <= t_hi and e.start + e.dur >= t_lo]
    return out


# -- where a turn's time goes ---------------------------------------------------


def _mean(xs: Sequence[float]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def turn_phases(ps: ProgramSpans, start: float, end: float) -> dict:
    """Means, in seconds, over the turns whose first token came in [start,
    end): the turn's TTFT and its phases (fetch; each gate's wait and hold by
    kind; the install's wait on the store; the model call; the ttft save,
    its snapshot gate, its store ops' client queue (start -> submit), wire
    (submit -> completion) and BACKGROUND deferral, its device-to-host
    waits); over the window, the gates' hold and the loop's blocked time by
    kind, each summed."""
    turns = turns_in_window(ps, start, end)
    ids = {t.span_id for t in turns}
    kids: Dict[int, List[Span]] = {}
    for s in ps.spans:
        kids.setdefault(s.parent_id, []).append(s)
    out: Dict[str, list] = {}

    def add(key, v):
        out.setdefault(key, []).append(v)

    for t in turns:
        add("ttft", t.at("token") - t.at("enqueue"))
        add("prefix_ready", (t.at("prefix_ready") or t.at("enqueue")) - t.at("enqueue"))
        for k in kids.get(t.span_id, ()):
            if k.name == "engine.fetch":
                add("fetch", k.end - k.start)
            elif k.name == "engine.gate" and k.at("acquire") is not None:
                kind = k.attrs.get("kind")
                add(f"gate_wait.{kind}", k.at("acquire") - k.start)
                add(f"gate_hold.{kind}", k.end - k.at("acquire"))
            elif k.name == "engine.install" and k.at("staged") is not None:
                add("install_staged_wait", k.at("staged") - k.start)
                add("install", k.end - k.start)
            elif k.name.startswith("model."):
                add(k.name, k.end - k.start)
            elif k.name == "engine.save" and k.attrs.get("path") == "ttft":
                add("ttft_save", k.end - k.start)
                ops = [o for o in kids.get(k.span_id, ()) if o.name.startswith("store.")]
                add("ttft_save.ops", len(ops))
                for o in ops:
                    sub, done = o.at("submit"), o.at("completion_ring")
                    if sub is not None and done is not None:
                        add("ttft_save.op_client_queue", sub - o.start)
                        add("ttft_save.op_wire", done - sub)
                    add("ttft_save.op_bg_gate", o.attrs.get("bg_gate_us", 0) / 1e6)
                wire = save_wire_s(ps, k)
                if wire is not None:
                    add("ttft_save.wire_union", wire)
                for g in kids.get(k.span_id, ()):
                    if g.name == "engine.gate" and g.at("acquire") is not None:
                        add("ttft_save.snapshot_wait", g.at("acquire") - g.start)
                    elif g.name == "loop.block":
                        add("ttft_save.d2h_blocks", g.end - g.start)
    phases = {k: _mean(v) for k, v in out.items()}
    phases["turns"] = len(turns)
    hold: Dict[str, float] = {}
    blocked: Dict[str, float] = {}
    for s in ps.spans:
        if s.end < start or s.start >= end:
            continue
        if s.name == "engine.gate" and s.at("acquire") is not None:
            key = s.attrs.get("kind")
            hold[key] = hold.get(key, 0.0) + s.end - s.at("acquire")
        elif s.name == "loop.block":
            key = s.attrs.get("what")
            blocked[key] = blocked.get(key, 0.0) + s.end - s.start
    phases["window_gate_hold_s"] = hold
    phases["window_loop_block_s"] = blocked
    return phases
