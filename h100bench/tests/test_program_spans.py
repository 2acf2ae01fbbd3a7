"""CPU tests of the readers of the program's own phase spans
(``program_spans.py``, the six ``metrics/`` files it serves, and
``spans_run.py``): each reader on hand-built spans against hand values; the
six idle states summing to the device's idle time; a program that records
no spans (or lost some of the window's) reading None; and a whole run of
the tiny cell on the CPU with the program traced.

Run: ``python -m pytest h100bench/tests -q`` from the repository's root.
"""

import os
import random

import pytest

from h100bench import program_spans as ps_mod
from h100bench import records, spans_run, spec
from h100bench.program_spans import Span
from h100bench.tests import tiny
from h100bench.trace import _union


def _metric(name):
    return spec.Metric(name, "", os.path.join(spec.HERE, "metrics", name + ".py"))


def _span(name, trace_id, span_id, parent_id, start, end, stages=(), **attrs):
    return Span(name, trace_id, span_id, parent_id, start, end, list(stages), attrs)


def _spans():
    """Window [10, 12); the traced span is the same two seconds.

    Three requests: the first's first token in the window (TTFT 1.0 s, its
    ttft save 0.6 s, wire ops 9.3-9.5 and 9.4-9.6), the second's too (0.5 s;
    0.2 s; 10.65-10.75), the third's after it. Device idle states, in order,
    over the idle time [10.2, 11.0) and [11.1, 12.0): a wave launching
    10.25-10.35, a resume to 10.5, an install's gate held to 10.7, a loop
    block to 10.85, a store op to 11.0 and from 11.1 to 11.5, then nothing."""
    t = lambda *xs: [("token", x) for x in xs]  # noqa: E731
    return [
        _span("engine_request", 1, 11, 0, 9.0, 10.5,
              [("enqueue", 9.0)] + t(10.0, 10.1, 10.3)),
        _span("engine.save", 1, 12, 11, 9.2, 9.8, path="ttft"),
        _span("store.write_cache", 1, 13, 12, 9.25, 9.55,
              [("submit", 9.3), ("completion_ring", 9.5)]),
        _span("store.write_cache", 1, 14, 12, 9.25, 9.65,
              [("submit", 9.4), ("completion_ring", 9.6)]),
        _span("engine.save", 1, 15, 11, 10.35, 10.4, path="response"),
        _span("engine_request", 2, 21, 0, 10.5, 11.6,
              [("enqueue", 10.5)] + t(11.0, 11.5)),
        _span("engine.save", 2, 22, 21, 10.6, 10.8, path="ttft"),
        _span("store.write_cache", 2, 23, 22, 10.6, 10.8,
              [("submit", 10.65), ("completion_ring", 10.75)]),
        _span("engine_request", 3, 31, 0, 11.5, 12.8, [("enqueue", 11.5)] + t(12.5, 12.7)),
        _span("model.wave", 9, 91, 0, 10.22, 10.36,
              [("take", 10.22), ("acquire", 10.25), ("launched", 10.35)], requests=[1]),
        _span("model.resume", 2, 24, 21, 10.3, 10.5),
        _span("engine.gate", 2, 25, 21, 10.3, 10.7, [("acquire", 10.4)],
              kind="install", exclusive=True),
        _span("engine.gate", 9, 92, 91, 10.75, 10.9, [("acquire", 10.8)],
              kind="wave", exclusive=True),
        _span("engine.gate", 2, 26, 22, 10.0, 11.9, [("acquire", 10.0)],
              kind="snapshot", exclusive=False),
        _span("loop.block", 2, 27, 21, 10.65, 10.85, what="token"),
        _span("store.read_cache", 3, 32, 31, 10.8, 11.5,
              [("submit", 10.9), ("completion_ring", 11.4)]),
    ]


def _run(spans=None, dropped_lost=False):
    run = records.Run(shapes=None, start=10.0, end=12.0, turns=[], saves=[], loads=[])
    run.spans = ps_mod.ProgramSpans(
        spans=_spans() if spans is None else spans, lost_in_window=dropped_lost,
        busy=[(10.0, 10.2), (11.0, 11.1)], traced=(10.0, 12.0))
    return run


def test_span_readers_against_hand_values():
    run = _run()
    assert _metric("engine.ttft_save_share").read(run) == pytest.approx(100 * 0.8 / 1.5)
    # per ttft save: union 9.3-9.6 = 0.3 s, 10.65-10.75 = 0.1 s; the median
    assert _metric("store.save_wire_ms_p50").read(run) == pytest.approx(200.0)
    # gaps ending in the window: 0.1, 0.2 (first request), 0.5 (second)
    assert _metric("engine.token_gap_p90_ms").read(run) == pytest.approx(
        1e3 * (0.2 + 0.8 * 0.3))


def test_idle_readers_against_hand_values():
    run = _run()
    idle = ps_mod.idle_program(run.spans)
    want = {"wave_launch": 0.1, "model_launch": 0.15, "gate_held": 0.2,
            "loop_blocked": 0.15, "store_io": 0.15 + 0.4, "none": 0.05 + 0.5}
    assert idle == pytest.approx(want)
    assert _metric("device.idle_wave_launch_share").read(run) == pytest.approx(5.0)
    assert _metric("device.idle_gate_held_share").read(run) == pytest.approx(10.0)
    assert _metric("device.idle_loop_blocked_share").read(run) == pytest.approx(7.5)


def test_idle_states_sum_to_the_idle_share_on_a_synthetic_trace():
    rng = random.Random(3)
    t0, t1 = 100.0, 106.0
    busy = sorted((a, a + rng.uniform(1e-5, 2e-3))
                  for a in (rng.uniform(t0 - 0.01, t1) for _ in range(3000)))
    names = ["model.wave", "model.prefill", "model.resume", "engine.gate", "loop.block",
             "store.write_cache", "store.read_cache", "engine.save"]
    spans = []
    for i in range(800):
        a = rng.uniform(t0 - 0.5, t1 + 0.5)
        b = a + rng.expovariate(100.0)
        name = rng.choice(names)
        stages = [("acquire", rng.uniform(a, b)), ("launched", b)]
        spans.append(_span(name, i, i, 0, a, b, stages, exclusive=rng.random() < 0.7,
                           kind=rng.choice(["install", "load", "prefill", "resume", "wave",
                                            "snapshot"])))
    ps = ps_mod.ProgramSpans(spans=spans, lost_in_window=False,
                             busy=_union(busy), traced=(t0, t1))
    idle = ps_mod.idle_program(ps)
    assert set(idle) == set(ps_mod.IDLE_STATES) and all(v >= 0 for v in idle.values())
    busy_s = ps_mod.union_s([(max(a, t0), min(b, t1)) for a, b in busy])
    idle_share = 100.0 * (1 - busy_s / (t1 - t0))
    assert 100.0 * sum(idle.values()) / (t1 - t0) == pytest.approx(idle_share, abs=1e-9)
    assert all(v > 0 for v in idle.values())


def test_readers_read_none_without_spans_or_after_a_loss():
    bare = records.Run(shapes=None, start=10.0, end=12.0, turns=[], saves=[], loads=[])
    lost = _run(dropped_lost=True)
    for name in spans_run.PROGRAM_METRICS:
        assert _metric(name).read(bare) is None
        assert _metric(name).read(lost) is None
    kept = ps_mod.mapped([{"name": "x", "trace_id": 1, "span_id": 2, "parent_id": 0,
                           "start_us": 9_000_000, "end_us": 9_500_000, "stages": [],
                           "attrs": {}}], 1.0)
    assert kept[0].start == pytest.approx(10.0) and kept[0].end == pytest.approx(10.5)
    # The oldest kept span finished before the window: nothing of it lost.
    assert not ps_mod.lost_in_window(kept, 5, 10.6)
    assert ps_mod.lost_in_window(kept, 5, 10.4)
    assert not ps_mod.lost_in_window(kept, 0, 10.4)


def test_wave_kernels_on_the_mapped_clock():
    from h100bench.trace import Event

    req = _span("engine_request", 1, 11, 0, 0.0, 1.0, [("token", 0.5)])
    wave = _span("model.wave", 9, 91, 0, 0.1, 0.2,
                 [("take", 0.1), ("acquire", 0.12), ("launched", 0.2)], requests=[1])
    k6 = "void (anonymous namespace)::paged_decode_ragged<__nv_bfloat16, 128>(Args)"
    events = [Event(k6, 0.11, 0.001)]  # the wave before's last layer
    events += [Event(k6, 0.13 + 0.01 * i, 0.005) for i in range(2)]
    ps = ps_mod.ProgramSpans(spans=[req, wave], lost_in_window=False, busy=[],
                             traced=(0.0, 1.0))
    (w,) = ps_mod.wave_kernels(ps, events, n_layers=2)
    assert w["first_kernel"] == pytest.approx(0.13) and w["first_token"] == 0.5
    assert w["acquire_before_kernel"] and w["kernels_before_token"]
    (w,) = ps_mod.wave_kernels(ps, events, n_layers=3)  # would take the wave before's
    assert not w["acquire_before_kernel"]


@pytest.mark.parametrize("program_trace", [True, False])
def test_a_traced_run_of_the_tiny_cell(program_trace):
    cell = tiny.cell()
    out, info, _ = spans_run.record(cell, 2**31 + 11, 2.0, True, "cpu", program_trace)
    line = spans_run.line_of(cell, out, True, {"platform": "cpu"}, info)
    assert line["correct"], line["check"]
    m = line["metrics"]
    assert "turn_p50_ms" in m and "device.idle_share" in m
    if not program_trace:
        assert not set(spans_run.PROGRAM_METRICS) & set(m)
        assert "idle_program" not in line["breakdown"]
        return
    assert info["dropped"] == 0 and not info["lost_in_window"]
    assert set(spans_run.PROGRAM_METRICS) <= set(m), set(spans_run.PROGRAM_METRICS) - set(m)
    idle = dict(line["breakdown"]["idle_program"])
    span = out["run"].trace.window_s
    assert 100 * sum(idle.values()) / span == pytest.approx(
        m["device.idle_share"]["value"], abs=1e-6)
    assert list(line)[-1] == "check"


def test_clock_pairs_and_alignment_follow_drift_and_jumps():
    from h100bench.trace import Event

    # The profiler's device times run late of the host by 2 ms a second from
    # 0, and jump back to 0 at 1.5 s; each token copy ends 20 µs before its
    # wait does. The device's list holds one copy from before the span.
    lag = lambda t: 2e-3 * t if t < 1.5 else 2e-3 * (t - 1.5)  # noqa: E731
    hosts = [0.1 + 0.1 * i for i in range(20)]
    spans = [_span("loop.block", 1, i, 0, h - 1e-4, h, what="token") for i, h in enumerate(hosts)]
    copies = [Event(ps_mod.TOKEN_COPY, h - 20e-6 - 5e-6 + lag(h), 5e-6) for h in hosts]
    copies.insert(0, Event(ps_mod.TOKEN_COPY, -0.03, 5e-6))
    kernels = [Event("k", 0.55 + lag(0.55), 1e-3), Event("k", 1.62 + lag(1.62), 1e-3)]
    ps = ps_mod.ProgramSpans(spans=spans, lost_in_window=False, traced=(0.0, 2.2))
    pairs = ps_mod.clock_pairs(ps, copies + kernels)
    assert len(pairs) == 20
    for (dev, shift), h in zip(pairs, hosts):
        assert shift == pytest.approx(20e-6 - lag(h), abs=1e-9)
    moved = ps_mod.aligned(kernels, pairs)
    assert moved[0].start == pytest.approx(0.55 + 20e-6, abs=1e-7)
    assert moved[1].start == pytest.approx(1.62 + 20e-6, abs=1e-7)
    assert ps_mod.aligned(kernels, []) == kernels
