"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUPTI) over a
span of the measured window, reduced to what the per-layer metrics read.

Only device activity is recorded (kernels, copies, sets): host operators at
the program's launch rate would swamp the trace. What the host was doing in
an idle gap comes instead from the benchmark's own spans around its calls
into the program (``serve.py``). Kineto stamps events on the wall clock;
``DeviceTrace`` notes the wall clock and the host's performance counter
together at the start and maps every event onto the counter.
"""

import re
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

# Kernels by the port's names (cuda/csrc): K3 paged_decode and K6
# paged_decode_ragged; K1 / K2 the block copies, on the bulk ring or the
# vector kernel.
DECODE_ATTENTION = re.compile(r"\bpaged_decode(_ragged)?<")
BLOCK_COPY = re.compile(r"\b(bulk_copy|vector_copy)\b")


@dataclass
class Event:
    name: str
    start: float  # host performance-counter seconds
    dur: float


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]  # by kernel class ("decode_attention", "block_copy")
    device_ops: List[list]
    idle_gaps: List[list]
    events: int


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = name.removeprefix("void ")
    for stop in ("<", "("):
        i = name.find(stop)
        if i > 0:
            name = name[:i]
    return name[:80]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def _labels(times: Sequence[float], spans: Sequence[Tuple[str, float, float]]) -> List[str]:
    """For each of the sorted ``times``, the kinds of the spans in flight
    then ("+"-joined), in one sweep over the spans' edges."""
    edges = sorted([(a, 1, kind) for kind, a, b in spans if b > a]
                   + [(b, -1, kind) for kind, a, b in spans if b > a])
    live: Dict[str, int] = defaultdict(int)
    out, i = [], 0
    for t in times:
        while i < len(edges) and edges[i][0] <= t:
            live[edges[i][2]] += edges[i][1]
            i += 1
        kinds = sorted(k for k, n in live.items() if n > 0)
        out.append("+".join(kinds) if kinds else "no call in flight")
    return out


def reduce(events: Sequence[Event], t0: float, t1: float,
           spans: Sequence[Tuple[str, float, float]] = ()) -> Summary:
    """Busy time (the union of device activity, clipped to [t0, t1]), device
    time by kernel class, the ten device operations that took most time,
    and the idle gaps summed by what the host was doing (``spans``: the
    benchmark's own (kind, start, end) calls in flight)."""
    clipped = []
    by_class: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    for e in events:
        a, b = max(e.start, t0), min(e.start + e.dur, t1)
        if b <= a:
            continue
        clipped.append((a, b))
        by_name[short_name(e.name)] += b - a
        if DECODE_ATTENTION.search(e.name):
            by_class["decode_attention"] += b - a
        elif BLOCK_COPY.search(e.name):
            by_class["block_copy"] += b - a
    busy = _union(clipped)
    idle, edge = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > edge:
            idle.append((edge, a))
        edge = max(edge, b)
    gaps: Dict[str, float] = defaultdict(float)
    for (a, b), label in zip(idle, _labels([(a + b) / 2 for a, b in idle], spans)):
        gaps[label] += b - a
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return Summary(
        window_s=t1 - t0,
        busy_s=sum(b - a for a, b in busy),
        kernel_s=dict(by_class),
        device_ops=top(by_name),
        idle_gaps=top(gaps),
        events=len(clipped),
    )


class DeviceTrace:
    """One profiled span. ``warm`` (in set-up) pays CUPTI's start-up once, so
    that ``start`` inside the window is quick."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t0 = self.t1 = None
        self._anchor = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        activity = (ProfilerActivity.CUDA if self.torch.cuda.is_available()
                    else ProfilerActivity.CPU)
        return profile(activities=[activity])

    def warm(self):
        p = self._profile()
        p.start()
        self.torch.zeros(1, device="cuda" if self.torch.cuda.is_available() else "cpu").add_(1)
        self._sync()
        p.stop()

    def _sync(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def start(self):
        self.prof = self._profile()
        self.prof.start()
        self._anchor = (time.perf_counter(), time.time_ns(), time.monotonic_ns())
        self.t0 = self._anchor[0]

    def stop(self):
        """Every kernel launched so far finishes inside the span."""
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def events(self) -> List[Event]:
        """Device activity mapped onto the performance counter."""
        raw = _raw_events(self.prof, self.torch)
        perf0, wall0, mono0 = self._anchor
        mid = (self.t0 + self.t1) / 2
        best = None
        for zero in (wall0, mono0):
            mapped = [Event(n, perf0 + (s - zero) / 1e9, d / 1e9) for n, s, d in raw]
            if mapped:
                med = sorted(e.start for e in mapped)[len(mapped) // 2]
                err = abs(med - mid)
                if best is None or err < best[0]:
                    best = (err, mapped)
        return best[1] if best else []


def _raw_events(prof, torch) -> List[Tuple[str, int, int]]:
    """(name, start ns, duration ns) of the device's activity."""
    want = "CUDA" if torch.cuda.is_available() else "CPU"
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == want:
            out.append((e.name(), e.start_ns(), e.duration_ns()))
    return out
