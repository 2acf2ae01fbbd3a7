"""One run of one cell, as ``h100bench.run`` makes it, with the program's own
phase spans recorded and read:

    python3 -m h100bench.spans_run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> --program-trace <0|1> [--chrome <path>]

``--program-trace 1`` enables the program's tracing
(``infinistore_tpu_torch.tracing``, a ring of ``RING`` spans) before the
system is built, maps the recorded spans onto the performance counter and
hands them to the readers as ``run.spans`` (``program_spans.ProgramSpans``),
with the device's busy intervals of a ``--trace 1`` run. The last line of
standard output is ``h100bench.run``'s result line, whose ``metrics`` hold
every end-to-end metric of the cell, its per-layer metrics with ``--trace
1``, and the readers of the program's spans (``PROGRAM_METRICS``); whose
``breakdown`` gains ``idle_program`` (the traced span's idle seconds by
program state); and which carries ``program_trace``: the spans recorded and
dropped, whether any of the window's was lost, the clock offset, the lag of
the profiler's device times behind the host's clock that the device events
were aligned by (``program_spans.clock_pairs``, ms: least, median, most),
the check of the waves' kernels against their host stamps on the aligned
clock and on the profiler's anchor alone (``program_spans.wave_kernels``),
and the means of the turns' phases (``program_spans.turn_phases``).
``--chrome`` writes one wave's spans beside the device's aligned activity
as Chrome trace events.

With ``--program-trace 0`` the program runs untraced, as in
``h100bench.run``; the line then lacks the program's metrics.
"""

import argparse
import json
import os
import sys

from h100bench import program_spans, run as run_mod, spec
from h100bench import trace as trace_mod

PROGRAM_METRICS = {
    "engine.ttft_save_share": "%", "store.save_wire_ms_p50": "ms",
    "engine.token_gap_p90_ms": "ms", "device.idle_wave_launch_share": "%",
    "device.idle_gate_held_share": "%", "device.idle_loop_blocked_share": "%",
}
RING = 1 << 18


class _KeptTrace(trace_mod.DeviceTrace):
    """A DeviceTrace that keeps the events it mapped."""

    last = None

    def events(self):
        out = super().events()
        _KeptTrace.last = (out, self.t0, self.t1)
        return out


def record(cell, seed: int, seconds: float, trace: bool, device: str,
           program_trace: bool, process_start=None):
    """``serve.run`` with the program traced; returns (serve.run's result,
    the ``program_trace`` summary, the device events of a traced run) and
    leaves ``ProgramSpans`` on the run record as ``spans``."""
    from h100bench import serve
    from infinistore_tpu_torch import tracing

    tracing.configure(enabled=program_trace, capacity=RING, slow_op_us=0).clear()
    real, trace_mod.DeviceTrace, _KeptTrace.last = trace_mod.DeviceTrace, _KeptTrace, None
    try:
        out = serve.run(cell, seed, seconds, trace, device, process_start)
    finally:
        trace_mod.DeviceTrace = real
        tracing.configure(enabled=False)
    run = out["run"]
    events, t0, t1 = _KeptTrace.last or ([], None, None)
    info = {"enabled": program_trace}
    if not program_trace:
        return out, info, events
    rec = tracing.recorder()
    offset = tracing.perf_counter_offset_s()
    spans = program_spans.mapped(rec.snapshot(), offset)
    run.spans = program_spans.ProgramSpans(
        spans=spans, lost_in_window=program_spans.lost_in_window(spans, rec.dropped, run.start),
        traced=(t0, t1) if t0 is not None else None)
    anchored = events
    if t0 is not None:
        pairs = program_spans.clock_pairs(run.spans, events)
        events = program_spans.aligned(events, pairs)
        run.spans.busy = trace_mod._union(
            [(max(e.start, t0), min(e.start + e.dur, t1))
             for e in events if e.start + e.dur > t0 and e.start < t1])
        shifts = sorted(c for _, c in pairs)
        info.update(clock_pairs=len(pairs), clock_shift_ms=[
            1e3 * shifts[0], 1e3 * shifts[len(shifts) // 2], 1e3 * shifts[-1]] if shifts else None)
    layers = cell.config["num_hidden_layers"]
    waves = program_spans.wave_kernels(run.spans, events, layers)
    on_anchor = program_spans.wave_kernels(run.spans, anchored, layers)
    launched = [w.at("launched") for w in run.spans.named("model.wave")]
    info.update(
        spans=len(spans), recorded=rec.recorded, dropped=rec.dropped,
        lost_in_window=run.spans.lost_in_window, offset_s=offset,
        waves_launched_in_span=sum(1 for t in launched
                                   if t is not None and t0 is not None and t0 <= t <= t1),
        k6_kernels_in_span=sum(1 for e in events if program_spans.WAVE_KERNEL + "<" in e.name),
        waves_checked=len(waves),
        waves_acquire_before_kernel=sum(w["acquire_before_kernel"] for w in waves),
        waves_kernels_before_token=sum(w["kernels_before_token"] for w in waves),
        anchor_only_acquire_before_kernel=sum(w["acquire_before_kernel"] for w in on_anchor),
        anchor_only_kernels_before_token=sum(w["kernels_before_token"] for w in on_anchor))
    if waves:
        info["wave"] = waves[len(waves) // 2]
    info["phases"] = program_spans.turn_phases(run.spans, run.start, run.end)
    return out, info, events


def line_of(cell, out: dict, trace: bool, device_info: dict, info: dict) -> dict:
    """``h100bench.run``'s result line, with every end-to-end metric, the
    program's metrics, ``idle_program`` and ``program_trace``."""
    run = out["run"]
    line, _ = run_mod.result(cell, out, trace, device_info)
    check = line.pop("check")
    units = {m.name: m.unit for m in cell.end_to_end + cell.per_layer}
    units.update(PROGRAM_METRICS)
    for m in cell.end_to_end + [spec.Metric(n, u, os.path.join(spec.HERE, "metrics", n + ".py"))
                                for n, u in PROGRAM_METRICS.items()]:
        if m.name not in line["metrics"]:
            v = m.read(run)
            if v is not None:
                line["metrics"][m.name] = {"value": v, "unit": units[m.name]}
    if "breakdown" in line:
        idle = program_spans.idle_program(getattr(run, "spans", None))
        if idle is not None:
            line["breakdown"]["idle_program"] = [[k, v] for k, v in idle.items()]
    line["program_trace"] = info
    line["check"] = check
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--program-trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--chrome", default=None)
    args = ap.parse_args(argv)

    from h100bench import serve

    cell = spec.cell(spec.load(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"h100bench: {args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "power_limit_w": serve.power_limit_w()}
    out, info, events = record(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                               bool(args.program_trace), run_mod.PROCESS_START)
    bad = run_mod.banned_modules()
    if bad:
        print(f"h100bench: the run loaded {', '.join(bad)}; it must not", file=sys.stderr)
        return 3
    line = line_of(cell, out, bool(args.trace), device_info, info)
    if args.chrome and "wave" in info:
        w = info["wave"]
        os.makedirs(os.path.dirname(os.path.abspath(args.chrome)), exist_ok=True)
        with open(args.chrome, "w") as f:
            json.dump({"traceEvents": program_spans.chrome_events(
                out["run"].spans.spans, events, w["acquire"] - 2e-3, w["first_token"] + 2e-3),
                "displayTimeUnit": "ms"}, f)
    print(f"h100bench: {out['timeline']}; turns in the window {len(out['run'].sent())}",
          file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
