"""One run of one cell:

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. Prints as the
last line of standard output one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also ``breakdown``,
and last ``check``: each number compared with its limit), and the same
numbers beside their limits as the last lines of standard error. With
``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics. Exits non-zero, printing no result,
without a card, or if the JAX package, ``jax``, ``jaxlib`` or ``flax`` is
loaded once the window has closed.
"""

import argparse
import json
import os
import sys
import time


def _process_start() -> float:
    """This process's start on the performance counter (Linux: from
    /proc/self/stat against the boot clock); now, where that is unreadable."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        return now


PROCESS_START = _process_start()

BANNED = ("jax", "jaxlib", "flax", "infinistore_tpu")


def banned_modules() -> list:
    """Loaded modules whose top-level name is one of ``BANNED``, compared
    whole (``infinistore_tpu_torch`` is not ``infinistore_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def result(cell, out: dict, trace: bool, device_info: dict) -> tuple:
    """(the result line's object, the check lines for standard error)."""
    run = out["run"]
    sent = run.sent()
    failed = sum(1 for t in sent if not t.ok)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    limit = cell.limits["max_logit_gap"]
    gap = out["max_logit_gap"]
    checks = {
        "max_logit_gap": {"value": gap, "limit": limit},
        "tokens_compared": {"value": out["tokens_compared"], "limit": 1},
        "failed_turns": {"value": failed, "limit": 0},
    }
    correct = (gap is not None and gap <= limit and out["tokens_compared"] >= 1
               and failed == 0 and len(sent) > 0)
    device = dict(device_info, memory_peak_bytes=out["memory_peak_bytes"])
    line = {"correct": correct, "attempted": len(sent), "failed": failed,
            "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.device_ops,
                             "idle_gaps": run.trace.idle_gaps}
    line["check"] = checks
    lines = [
        f"check max_logit_gap {gap} limit {limit} (at most)",
        f"check tokens_compared {out['tokens_compared']} limit 1 (at least)",
        f"check failed_turns {failed} limit 0 (at most)",
    ]
    return line, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from h100bench import serve, spec

    cell = spec.cell(spec.load(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"h100bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "power_limit_w": serve.power_limit_w()}
    out = serve.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", PROCESS_START)
    bad = banned_modules()
    if bad:
        print(f"h100bench: the run loaded {', '.join(bad)}; it must not", file=sys.stderr)
        return 3
    line, lines = result(cell, out, bool(args.trace), device_info)
    run = out["run"]
    print(f"h100bench: {out['timeline']}; turns sent {len(run.turns)}, in the window "
          f"{len(run.sent())}, returned in it {len(run.returned_in_window())}; "
          f"trace events {out['trace_events']}", file=sys.stderr)
    for text in lines:
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
