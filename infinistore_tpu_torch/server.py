"""Server CLI + HTTP management plane.

Copy of ``infinistore_tpu/server.py`` for the PyTorch port, which imports
nothing of ``infinistore_tpu``; keep the two in step. Two places differ
from the original beyond the package name: ``_disagg_status`` and
``_engine_wave_status`` observe ``infinistore_tpu_torch.disagg`` and
``infinistore_tpu_torch.engine`` in ``sys.modules`` (the port's counters,
not the JAX package's). With a port ``ClusterKVConnector`` attached
(``ManageServer(config, cluster=...)``) it serves ``/membership`` GET/POST,
``/gossip``, ``/bootstrap`` and ``/tiers`` through the port's own
``membership`` copy, imported lazily as in the original.

TPU-native rebuild of the reference's infinistore/server.py (argparse
:42-148, periodic evict task :157-186, OOM-score protection :151-154, FastAPI
manage port :25-39, uvloop startup :173-198). Differences:

- The data plane is the native epoll reactor (its own thread), so there is no
  uvloop grafting; plain asyncio runs the control plane.
- The manage HTTP server is a dependency-free asyncio implementation (this
  environment has no fastapi/uvicorn) serving the same endpoints — POST /purge
  and GET /kvmap_len — plus GET /selftest, which the reference README
  advertises but never implemented (doc/code discrepancy noted in SURVEY.md
  §5.5), and GET /stats and GET /usage for the per-op counters.
- Flags are generated from the ServerConfig dataclass: one source of truth
  instead of the reference's four-place duplication rule (config.h:7-12).

Run: python -m infinistore_tpu_torch.server --service-port 22345 --manage-port 28080
"""

import argparse
import asyncio
import dataclasses
import json
import math
import os
import signal
import sys
import threading
import urllib.parse

from . import lib as _lib
from . import profiling, telemetry, tracing
from .config import ServerConfig
from .lib import Logger, register_server, unregister_server

_SKIP_CLI = {"extra"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="infinistore-tpu",
        description="TPU-native distributed KV-cache store server",
    )
    for f in dataclasses.fields(ServerConfig):
        if f.name in _SKIP_CLI:
            continue
        flag = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            parser.add_argument(
                flag,
                action=argparse.BooleanOptionalAction,
                default=f.default,
                help=f"(default: {f.default})",
            )
        else:
            parser.add_argument(
                flag,
                type=type(f.default),
                default=f.default,
                help=f"(default: {f.default})",
            )
    return parser


def parse_args(argv=None) -> ServerConfig:
    args = vars(build_parser().parse_args(argv))
    return ServerConfig(**args)


def prevent_oom() -> None:
    """Protect the cache process from the kernel OOM killer (reference
    server.py:151-154 writes oom_score_adj=-1000)."""
    try:
        with open("/proc/self/oom_score_adj", "w") as f:
            f.write("-1000")
    except (OSError, PermissionError) as e:
        Logger.warn(f"cannot set oom_score_adj (need privileges): {e}")


# ---------------------------------------------------------------------------
# Minimal HTTP management server (stdlib asyncio; no fastapi/uvicorn here).
# ---------------------------------------------------------------------------


def _http_response(status: int, payload: dict) -> bytes:
    body = json.dumps(payload).encode()
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              405: "Method Not Allowed", 500: "Error"}.get(status, "OK")
    return (
        f"HTTP/1.1 {status} {reason}\r\n"
        f"Content-Type: application/json\r\n"
        f"Content-Length: {len(body)}\r\n"
        f"Connection: close\r\n\r\n"
    ).encode() + body


def _text_response(status: int, text: str,
                   ctype: str = "text/plain; charset=utf-8") -> bytes:
    """Non-JSON response (the folded-stack /profile body)."""
    body = text.encode()
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found"}.get(status, "OK")
    return (
        f"HTTP/1.1 {status} {reason}\r\n"
        f"Content-Type: {ctype}\r\n"
        f"Content-Length: {len(body)}\r\n"
        f"Connection: close\r\n\r\n"
    ).encode() + body


def _prometheus_text(stats: dict, membership_status: dict = None,
                     slo_status: dict = None, event_counts: dict = None,
                     gossip_status: dict = None, tier_status: dict = None,
                     prof_status: dict = None, timeseries_status: dict = None,
                     disagg_status: dict = None,
                     engine_wave_status: dict = None,
                     exemplars: bool = False) -> bytes:
    """Render the stats snapshot in Prometheus exposition format (the
    reference exposes no metrics at all — SURVEY.md §5.1/§5.5). With a
    cluster attached to the manage plane, ``membership_status`` appends
    the membership/reshard gauge families (docs/membership.md);
    ``slo_status``/``event_counts`` append the fleet-telemetry families
    (docs/observability.md). ``exemplars`` (``GET /metrics?exemplars=1``)
    attaches OpenMetrics exemplars — the trace id of the slowest recorded
    op per histogram — to the matching ``_bucket`` line; the default
    output stays plain Prometheus, byte-identical to pre-exemplar."""
    lines = [
        "# TYPE infinistore_kvmap_entries gauge",
        f"infinistore_kvmap_entries {stats['kvmap_len']}",
        "# TYPE infinistore_pool_usage_ratio gauge",
        f"infinistore_pool_usage_ratio {stats['usage']:.6f}",
        "# TYPE infinistore_pool_bytes gauge",
        f'infinistore_pool_bytes{{kind="total"}} {stats["total_bytes"]}',
        f'infinistore_pool_bytes{{kind="used"}} {stats["used_bytes"]}',
        "# TYPE infinistore_connections gauge",
        f"infinistore_connections {stats['connections']}",
        "# TYPE infinistore_connections_accepted counter",
        f"infinistore_connections_accepted {stats['conns_accepted']}",
        "# TYPE infinistore_pools gauge",
        f"infinistore_pools {stats['pools']}",
        "# TYPE infinistore_pool_pinned gauge",
        f"infinistore_pool_pinned {1 if stats['pinned'] else 0}",
    ]
    spill = stats.get("spill", {})
    if spill.get("capacity", 0) > 0:
        lines += [
            "# TYPE infinistore_spill_bytes gauge",
            f'infinistore_spill_bytes{{kind="used"}} {spill["bytes"]}',
            f'infinistore_spill_bytes{{kind="capacity"}} {spill["capacity"]}',
            "# TYPE infinistore_spill_entries gauge",
            f"infinistore_spill_entries {spill['entries']}",
            "# TYPE infinistore_spill_promotions counter",
            f"infinistore_spill_promotions {spill['promotions']}",
            "# TYPE infinistore_spill_dropped counter",
            f"infinistore_spill_dropped {spill['dropped']}",
        ]
    # Data-plane queue depth + two-class QoS scheduler counters
    # (docs/qos.md): suspended sliced ops by class, per-class dispatch and
    # slice counts, and the scheduler's preempt/age decisions.
    qos = stats.get("qos")
    if qos is not None:
        lines += [
            "# TYPE infinistore_dataplane_suspended_ops gauge",
            f"infinistore_dataplane_suspended_ops {stats.get('suspended_ops', 0)}",
            "# TYPE infinistore_qos_queued gauge",
            f'infinistore_qos_queued{{class="fg"}} {qos["fg_queued"]}',
            f'infinistore_qos_queued{{class="bg"}} {qos["bg_queued"]}',
            "# TYPE infinistore_qos_ops counter",
            f'infinistore_qos_ops{{class="fg"}} {qos["fg_ops"]}',
            f'infinistore_qos_ops{{class="bg"}} {qos["bg_ops"]}',
            "# TYPE infinistore_qos_slices counter",
            f'infinistore_qos_slices{{class="fg"}} {qos["fg_slices"]}',
            f'infinistore_qos_slices{{class="bg"}} {qos["bg_slices"]}',
            "# TYPE infinistore_qos_bg_preempted_slices counter",
            f"infinistore_qos_bg_preempted_slices {qos['bg_preempted_slices']}",
            "# TYPE infinistore_qos_bg_aged_slices counter",
            f"infinistore_qos_bg_aged_slices {qos['bg_aged_slices']}",
            # Scheduler tunables as gauges: config drift across a fleet is
            # an operational incident dashboards should be able to show.
            "# TYPE infinistore_qos_bg_cooldown_us gauge",
            f"infinistore_qos_bg_cooldown_us {qos['bg_cooldown_us']}",
            "# TYPE infinistore_qos_bg_aging_us gauge",
            f"infinistore_qos_bg_aging_us {qos['bg_aging_us']}",
        ]
    # Descriptor-ring data plane (docs/descriptor_ring.md): attach/consume/
    # complete lifetime counters, the doorbell-vs-descriptor coalescing
    # ratio (one doorbell per doze, not per op), live ring depths, and the
    # two rejection classes (bad = per-descriptor 400 CQE, torn =
    # generation-tag mismatch, fatal for the connection).
    ring = stats.get("ring")
    if ring is not None:
        lines += [
            "# TYPE infinistore_ring_conns gauge",
            f"infinistore_ring_conns {ring['conns']}",
            "# TYPE infinistore_ring_attached counter",
            f"infinistore_ring_attached {ring['attached']}",
            "# TYPE infinistore_ring_descriptors counter",
            f"infinistore_ring_descriptors {ring['descriptors']}",
            "# TYPE infinistore_ring_doorbells counter",
            f'infinistore_ring_doorbells{{dir="rx"}} {ring["doorbells_rx"]}',
            f'infinistore_ring_doorbells{{dir="tx"}} {ring["cq_doorbells_tx"]}',
            "# TYPE infinistore_ring_completions counter",
            f"infinistore_ring_completions {ring['completions']}",
            "# TYPE infinistore_ring_bad_descriptors counter",
            f"infinistore_ring_bad_descriptors {ring['bad_descriptors']}",
            "# TYPE infinistore_ring_torn_descriptors counter",
            f"infinistore_ring_torn_descriptors {ring['torn_descriptors']}",
            "# TYPE infinistore_ring_sq_depth gauge",
            f"infinistore_ring_sq_depth {ring['sq_depth']}",
            "# TYPE infinistore_ring_pending gauge",
            f"infinistore_ring_pending {ring['pending']}",
            # Mechanism counters: multi-op batch slots (one slot per
            # coalesced flush) and the adaptive poll-then-park windows —
            # hits completed without parking, arms fell back to the epoll
            # doze, elided doorbells found the client already awake.
            "# TYPE infinistore_ring_batch_slots counter",
            f"infinistore_ring_batch_slots {ring['batch_slots']}",
            "# TYPE infinistore_ring_batch_ops counter",
            f"infinistore_ring_batch_ops {ring['batch_ops']}",
            "# TYPE infinistore_ring_poll_hits counter",
            f"infinistore_ring_poll_hits {ring['poll_hits']}",
            "# TYPE infinistore_ring_poll_arms counter",
            f"infinistore_ring_poll_arms {ring['poll_arms']}",
            "# TYPE infinistore_ring_doorbell_elided counter",
            f"infinistore_ring_doorbell_elided {ring['doorbell_elided']}",
        ]
    # Reactor loop-pass phase accounting (docs/observability.md,
    # profiling section): per-phase cumulative microseconds plus the pass
    # count — rate() over infinistore_prof_loop_us gives per-phase
    # utilization, the native denominator under the /profile sampler's
    # Python-side frames.
    nprof = stats.get("prof")
    if nprof is not None:
        lines += [
            "# TYPE infinistore_prof_loop_passes counter",
            f"infinistore_prof_loop_passes {nprof['passes']}",
            "# TYPE infinistore_prof_loop_us counter",
            f'infinistore_prof_loop_us{{phase="wait"}} {nprof["wait_us"]}',
            f'infinistore_prof_loop_us{{phase="events"}} {nprof["events_us"]}',
            f'infinistore_prof_loop_us{{phase="rings"}} {nprof["rings_us"]}',
            f'infinistore_prof_loop_us{{phase="slices"}} {nprof["slices_us"]}',
            f'infinistore_prof_loop_us{{phase="poll"}} {nprof["poll_us"]}',
            f'infinistore_prof_loop_us{{phase="other"}} {nprof["other_us"]}',
        ]
    # Tracing surfaces (docs/observability.md): the client flight
    # recorder's counters (span volume + the slow-op watchdog) and the
    # server-side trace tick ring's coverage counters. The spans/ticks
    # themselves are served by GET /trace, not scraped.
    rec = tracing.recorder()
    tr = stats.get("trace", {})
    lines += [
        "# TYPE infinistore_trace_slow_ops_total counter",
        f"infinistore_trace_slow_ops_total {rec.slow_ops_total if rec else 0}",
        "# TYPE infinistore_trace_spans_recorded counter",
        f"infinistore_trace_spans_recorded {rec.recorded if rec else 0}",
        "# TYPE infinistore_trace_spans_dropped counter",
        f"infinistore_trace_spans_dropped {rec.dropped if rec else 0}",
        "# TYPE infinistore_trace_server_ticks_recorded counter",
        f"infinistore_trace_server_ticks_recorded {tr.get('recorded', 0)}",
        "# TYPE infinistore_trace_server_ticks_dropped counter",
        f"infinistore_trace_server_ticks_dropped {tr.get('dropped', 0)}",
    ]
    # Exposition format requires all samples of a family in one uninterrupted
    # group after its TYPE line — one pass per family, not per op.
    ops = sorted(stats.get("ops", {}).items())
    lines.append("# TYPE infinistore_op_count counter")
    for op, s in ops:
        lines.append(f'infinistore_op_count{{op="{op}",result="ok"}} '
                     f'{s["count"] - s["errors"]}')
        lines.append(f'infinistore_op_count{{op="{op}",result="error"}} {s["errors"]}')
    lines.append("# TYPE infinistore_op_bytes counter")
    for op, s in ops:
        lines.append(f'infinistore_op_bytes{{op="{op}",dir="in"}} {s["bytes_in"]}')
        lines.append(f'infinistore_op_bytes{{op="{op}",dir="out"}} {s["bytes_out"]}')
    lines.append("# TYPE infinistore_op_time_us counter")
    for op, s in ops:
        lines.append(f'infinistore_op_time_us{{op="{op}"}} {s["total_us"]}')
    # Proper log-bucketed latency HISTOGRAM per op (base-2 octaves, 32
    # sub-buckets = ~2% resolution — native OpStats::lat_buckets, exported
    # sparse as [le_us, count]): dashboards can aggregate/re-quantile it,
    # which the old p99 point-gauges could not. The cumulative `le` walk +
    # +Inf/_sum/_count triplet is the Prometheus histogram contract.
    # Exemplar sources (``?exemplars=1``, OpenMetrics syntax): the slowest
    # recorded trace-tick per op, so a p99 bucket links its trace id
    # straight into the flight recorder (`GET /trace`). Off by default —
    # the plain exposition bytes are unchanged.
    slowest: dict = {}
    if exemplars:
        tick_entries = tr.get("entries", [])
        for e in tick_entries:
            dur = e.get("done_us", 0) - e.get("recv_us", 0)
            if e.get("trace_id") and dur > 0:
                cur = slowest.get(e.get("op"))
                if cur is None or dur > cur[0]:
                    slowest[e.get("op")] = (dur, e.get("trace_id"))
    lines.append("# TYPE infinistore_op_duration_us histogram")
    for op, s in ops:
        cum = 0
        ex = slowest.get(op)
        for le, cnt in s.get("hist_us", []):
            cum += cnt
            line = f'infinistore_op_duration_us_bucket{{op="{op}",le="{le}"}} {cum}'
            if ex is not None and ex[0] <= le:
                line += f' # {{trace_id="{ex[1]:#x}"}} {float(ex[0])}'
                ex = None
            lines.append(line)
        inf_line = (
            f'infinistore_op_duration_us_bucket{{op="{op}",le="+Inf"}} {s["count"]}'
        )
        if ex is not None:
            inf_line += f' # {{trace_id="{ex[1]:#x}"}} {float(ex[0])}'
        lines.append(inf_line)
        lines.append(f'infinistore_op_duration_us_sum{{op="{op}"}} {s["total_us"]}')
        lines.append(f'infinistore_op_duration_us_count{{op="{op}"}} {s["count"]}')
    # p50/p99 stay as DERIVED gauges (computed natively from the same
    # buckets) so existing dashboards and the bench_check gates keep their
    # names; the histogram above is the primary surface.
    lines.append("# TYPE infinistore_op_p50_latency_us gauge")
    for op, s in ops:
        lines.append(f'infinistore_op_p50_latency_us{{op="{op}"}} {s["p50_us"]}')
    # p99 is the number the QoS gates regression-check (tools/bench_check.py)
    # — exporting only p50 hid tail inflation from dashboards (ITS-C001).
    lines.append("# TYPE infinistore_op_p99_latency_us gauge")
    for op, s in ops:
        lines.append(f'infinistore_op_p99_latency_us{{op="{op}"}} {s["p99_us"]}')
    if membership_status is not None:
        lines += _membership_prometheus_lines(membership_status)
    if gossip_status is not None:
        lines += _gossip_prometheus_lines(gossip_status)
    if tier_status is not None:
        lines += _tier_prometheus_lines(tier_status)
    if disagg_status is not None:
        lines += _disagg_prometheus_lines(disagg_status)
    if engine_wave_status is not None:
        lines += _engine_wave_prometheus_lines(engine_wave_status)
    if slo_status is not None:
        lines += _slo_prometheus_lines(slo_status)
    if prof_status is not None:
        lines += _prof_prometheus_lines(prof_status)
    if timeseries_status is not None:
        lines += _timeseries_prometheus_lines(timeseries_status)
    if event_counts is not None:
        lines += _events_prometheus_lines(event_counts)
    # Exemplar syntax is ILLEGAL in the plain 0.0.4 text format (a scraper
    # parsing it there rejects the whole body) — the exemplar variant must
    # declare OpenMetrics, whose parser requires the trailing # EOF. That
    # parser also enforces counter naming: the family is declared by BASE
    # name and samples carry ``_total``. The legacy counter vocabulary
    # predates that rule, so here (and only here) the TYPE lines adapt:
    # ``foo_total``-named families are declared by base (samples already
    # conform), anything else is declared ``unknown``, which OpenMetrics
    # accepts with any name. Exemplars ride only the histogram ``_bucket``
    # lines, where they are legal; sample names/values stay identical to
    # the plain rendering.
    if exemplars:
        def _om_type(ln: str) -> str:
            if not (ln.startswith("# TYPE ") and ln.endswith(" counter")):
                return ln
            family = ln.split(" ")[2]
            if family.endswith("_total"):
                return f"# TYPE {family[: -len('_total')]} counter"
            return ln[: -len("counter")] + "unknown"

        lines = [_om_type(ln) for ln in lines]
        lines.append("# EOF")
        ctype = "application/openmetrics-text; version=1.0.0; charset=utf-8"
    else:
        ctype = "text/plain; version=0.0.4"
    body = ("\n".join(lines) + "\n").encode()
    return (
        f"HTTP/1.1 200 OK\r\n"
        f"Content-Type: {ctype}\r\n"
        f"Content-Length: {len(body)}\r\n"
        f"Connection: close\r\n\r\n"
    ).encode() + body


def _membership_prometheus_lines(ms: dict) -> list:
    """Membership + reshard gauges for /metrics, from the flat
    ``ClusterKVConnector.membership_status()`` snapshot (the same dict the
    ``/membership`` endpoint serves; key vocabulary in
    ``Membership.status`` / ``Resharder.progress``). The counters checker
    (ITS-C005, tools/analysis/counters.py) cross-checks that every status
    key is consumed here — a membership counter that never reaches a
    dashboard is observability drift."""
    return [
        "# TYPE infinistore_membership_epoch gauge",
        f"infinistore_membership_epoch {ms['membership_epoch']}",
        "# TYPE infinistore_membership_epoch_changes counter",
        f"infinistore_membership_epoch_changes {ms['membership_epoch_changes']}",
        "# TYPE infinistore_membership_members gauge",
        f"infinistore_membership_members {ms['membership_members']}",
        "# TYPE infinistore_membership_state gauge",
        f'infinistore_membership_state{{state="joining"}} {ms["membership_joining"]}',
        f'infinistore_membership_state{{state="active"}} {ms["membership_active"]}',
        f'infinistore_membership_state{{state="leaving"}} {ms["membership_leaving"]}',
        f'infinistore_membership_state{{state="dead"}} {ms["membership_dead"]}',
        f'infinistore_membership_state{{state="removed"}} {ms["membership_removed"]}',
        "# TYPE infinistore_membership_settled gauge",
        f"infinistore_membership_settled {ms['membership_settled']}",
        "# TYPE infinistore_reshard_active gauge",
        f"infinistore_reshard_active {ms['reshard_active']}",
        "# TYPE infinistore_reshard_passes counter",
        f"infinistore_reshard_passes {ms['reshard_passes']}",
        "# TYPE infinistore_reshard_replans counter",
        f"infinistore_reshard_replans {ms['reshard_replans']}",
        "# TYPE infinistore_reshard_planned_roots counter",
        f"infinistore_reshard_planned_roots {ms['reshard_planned_roots']}",
        "# TYPE infinistore_reshard_moved_roots counter",
        f"infinistore_reshard_moved_roots {ms['reshard_moved_roots']}",
        "# TYPE infinistore_reshard_moved_keys counter",
        f"infinistore_reshard_moved_keys {ms['reshard_moved_keys']}",
        "# TYPE infinistore_reshard_moved_bytes counter",
        f"infinistore_reshard_moved_bytes {ms['reshard_moved_bytes']}",
        "# TYPE infinistore_reshard_pruned_keys counter",
        f"infinistore_reshard_pruned_keys {ms['reshard_pruned_keys']}",
        "# TYPE infinistore_reshard_skipped_keys counter",
        f"infinistore_reshard_skipped_keys {ms['reshard_skipped_keys']}",
        "# TYPE infinistore_reshard_failed_roots counter",
        f"infinistore_reshard_failed_roots {ms['reshard_failed_roots']}",
        "# TYPE infinistore_reshard_lost_roots counter",
        f"infinistore_reshard_lost_roots {ms['reshard_lost_roots']}",
        "# TYPE infinistore_reshard_debt_roots gauge",
        f"infinistore_reshard_debt_roots {ms['reshard_debt_roots']}",
        "# TYPE infinistore_reshard_prune_debt gauge",
        f"infinistore_reshard_prune_debt {ms['reshard_prune_debt']}",
        "# TYPE infinistore_reshard_last_pass_ms gauge",
        f"infinistore_reshard_last_pass_ms {ms['reshard_last_pass_ms']}",
        "# TYPE infinistore_reshard_catalog_roots gauge",
        f"infinistore_reshard_catalog_roots {ms.get('reshard_catalog_roots', 0)}",
        # Durable catalog + reshard journal (docs/membership.md, durability
        # section): append/fsync/compaction volume plus what the last
        # startup replay saw (torn tails discarded, checksum-bad records
        # skipped). Zeros when the cluster runs without a journal.
        "# TYPE infinistore_journal_records counter",
        f"infinistore_journal_records {ms.get('journal_records', 0)}",
        "# TYPE infinistore_journal_bytes gauge",
        f"infinistore_journal_bytes {ms.get('journal_bytes', 0)}",
        "# TYPE infinistore_journal_fsyncs counter",
        f"infinistore_journal_fsyncs {ms.get('journal_fsyncs', 0)}",
        "# TYPE infinistore_journal_compactions counter",
        f"infinistore_journal_compactions {ms.get('journal_compactions', 0)}",
        "# TYPE infinistore_journal_replay_records gauge",
        f"infinistore_journal_replay_records {ms.get('journal_replay_records', 0)}",
        "# TYPE infinistore_journal_replay_torn gauge",
        f"infinistore_journal_replay_torn {ms.get('journal_replay_torn', 0)}",
        "# TYPE infinistore_journal_replay_bad_checksum gauge",
        f"infinistore_journal_replay_bad_checksum "
        f"{ms.get('journal_replay_bad_checksum', 0)}",
    ]


def _gossip_prometheus_lines(gs: dict) -> list:
    """Gossip anti-entropy gauge families for /metrics, from the flat
    ``telemetry.GossipAgent.status`` snapshot. The counters checker
    (ITS-C006) holds this exporter to the ``gossip_*`` status vocabulary
    both ways (docs/membership.md, gossip section)."""
    return [
        "# TYPE infinistore_gossip_peers gauge",
        f"infinistore_gossip_peers {gs['gossip_peers']}",
        "# TYPE infinistore_gossip_rounds counter",
        f"infinistore_gossip_rounds {gs['gossip_rounds']}",
        "# TYPE infinistore_gossip_exchanges counter",
        f"infinistore_gossip_exchanges {gs['gossip_exchanges']}",
        "# TYPE infinistore_gossip_exchange_failures counter",
        f"infinistore_gossip_exchange_failures {gs['gossip_exchange_failures']}",
        "# TYPE infinistore_gossip_merges counter",
        f'infinistore_gossip_merges{{dir="in"}} {gs["gossip_merges_in"]}',
        f'infinistore_gossip_merges{{dir="out"}} {gs["gossip_merges_out"]}',
        "# TYPE infinistore_gossip_last_epoch_seen gauge",
        f"infinistore_gossip_last_epoch_seen {gs['gossip_last_epoch_seen']}",
        "# TYPE infinistore_gossip_last_round_ms gauge",
        f"infinistore_gossip_last_round_ms {gs['gossip_last_round_ms']}",
    ]


def _tier_prometheus_lines(ts: dict) -> list:
    """Tiered-capacity-plane gauge families for /metrics, from the flat
    ``tiering.TierManager.status`` snapshot (the same dict ``GET /tiers``
    serves). The counters checker (ITS-C007, tools/analysis/counters.py)
    holds this exporter to the ``tier_*`` status vocabulary both ways —
    a tier the dashboards cannot see is observability drift
    (docs/tiering.md)."""
    return [
        "# TYPE infinistore_tier_cold_members gauge",
        f"infinistore_tier_cold_members {ts['tier_cold_members']}",
        "# TYPE infinistore_tier_cold_roots gauge",
        f"infinistore_tier_cold_roots {ts['tier_cold_roots']}",
        "# TYPE infinistore_tier_tracked_roots gauge",
        f"infinistore_tier_tracked_roots {ts['tier_tracked_roots']}",
        "# TYPE infinistore_tier_sketch_evictions counter",
        f"infinistore_tier_sketch_evictions {ts['tier_sketch_evictions']}",
        "# TYPE infinistore_tier_hits counter",
        f'infinistore_tier_hits{{tier="ram"}} {ts["tier_ram_hits"]}',
        f'infinistore_tier_hits{{tier="cold"}} {ts["tier_cold_hits"]}',
        f'infinistore_tier_hits{{tier="demotion"}} {ts["tier_demotion_hits"]}',
        "# TYPE infinistore_tier_misses counter",
        f"infinistore_tier_misses {ts['tier_misses']}",
        "# TYPE infinistore_tier_cold_reads counter",
        f"infinistore_tier_cold_reads {ts['tier_cold_reads']}",
        "# TYPE infinistore_tier_cold_read_p99_us gauge",
        f"infinistore_tier_cold_read_p99_us {ts['tier_cold_read_p99_us']}",
        "# TYPE infinistore_tier_demotions counter",
        f"infinistore_tier_demotions {ts['tier_demotions']}",
        "# TYPE infinistore_tier_demoted_keys counter",
        f"infinistore_tier_demoted_keys {ts['tier_demoted_keys']}",
        "# TYPE infinistore_tier_demoted_bytes counter",
        f"infinistore_tier_demoted_bytes {ts['tier_demoted_bytes']}",
        "# TYPE infinistore_tier_demote_failures counter",
        f"infinistore_tier_demote_failures {ts['tier_demote_failures']}",
        "# TYPE infinistore_tier_promotions counter",
        f"infinistore_tier_promotions {ts['tier_promotions']}",
        "# TYPE infinistore_tier_promoted_keys counter",
        f"infinistore_tier_promoted_keys {ts['tier_promoted_keys']}",
        "# TYPE infinistore_tier_promoted_bytes counter",
        f"infinistore_tier_promoted_bytes {ts['tier_promoted_bytes']}",
        "# TYPE infinistore_tier_promote_failures counter",
        f"infinistore_tier_promote_failures {ts['tier_promote_failures']}",
        "# TYPE infinistore_tier_admit_rejects counter",
        f"infinistore_tier_admit_rejects {ts['tier_admit_rejects']}",
        "# TYPE infinistore_tier_direct_reads counter",
        f"infinistore_tier_direct_reads {ts['tier_direct_reads']}",
        "# TYPE infinistore_tier_promote_backlog gauge",
        f"infinistore_tier_promote_backlog {ts['tier_promote_backlog']}",
        "# TYPE infinistore_tier_demote_backlog gauge",
        f"infinistore_tier_demote_backlog {ts['tier_demote_backlog']}",
        "# TYPE infinistore_tier_wrong_reads counter",
        f"infinistore_tier_wrong_reads {ts['tier_wrong_reads']}",
        "# TYPE infinistore_tier_last_pass_ms gauge",
        f"infinistore_tier_last_pass_ms {ts['tier_last_pass_ms']}",
    ]


def _disagg_prometheus_lines(ds: dict) -> list:
    """Disaggregated-handoff counter families for /metrics, from the flat
    ``disagg.DisaggCounters.status`` snapshot (the same dict ``GET
    /disagg`` serves). The counters checker (ITS-C009,
    tools/analysis/counters.py) holds this exporter to the ``disagg_*``
    ledger vocabulary both ways — a handoff counter the dashboards cannot
    see is observability drift (docs/disaggregation.md)."""
    return [
        "# TYPE infinistore_disagg_handoffs counter",
        f"infinistore_disagg_handoffs {ds['disagg_handoffs']}",
        "# TYPE infinistore_disagg_overlap_layers counter",
        f"infinistore_disagg_overlap_layers {ds['disagg_overlap_layers']}",
        "# TYPE infinistore_disagg_inflight_at_first_token counter",
        "infinistore_disagg_inflight_at_first_token "
        f"{ds['disagg_inflight_at_first_token']}",
        "# TYPE infinistore_disagg_watermark_stalls counter",
        f"infinistore_disagg_watermark_stalls {ds['disagg_watermark_stalls']}",
        "# TYPE infinistore_disagg_fallback_recomputes counter",
        "infinistore_disagg_fallback_recomputes "
        f"{ds['disagg_fallback_recomputes']}",
        "# TYPE infinistore_disagg_wrong_bytes counter",
        f"infinistore_disagg_wrong_bytes {ds['disagg_wrong_bytes']}",
    ]


def _disagg_status():
    """The process-wide disagg counter snapshot, or None when no handoff
    has run here. Lazy on purpose: ``infinistore_tpu_torch.disagg`` pulls
    in the torch engine stack, and the core client/server API must stay
    importable without it — so this only *observes* an already-imported
    module (``sys.modules``), never imports one."""
    dsd = sys.modules.get("infinistore_tpu_torch.disagg")
    if dsd is None:
        return None
    return dsd.counters().status()


def _engine_wave_prometheus_lines(ws: dict) -> list:
    """Skew-aware wave-policy counter families for /metrics, from the flat
    ``engine.WaveCounters.status`` snapshot (the same dict ``GET /wave``
    serves). The counters checker (ITS-C010, tools/analysis/counters.py)
    holds this exporter to the ``engine_wave_*`` ledger vocabulary both
    ways — a deferral the dashboards cannot see is observability drift
    (docs/serving_load.md)."""
    return [
        "# TYPE infinistore_engine_wave_deferrals counter",
        f"infinistore_engine_wave_deferrals {ws['engine_wave_deferrals']}",
        "# TYPE infinistore_engine_wave_aging_escapes counter",
        "infinistore_engine_wave_aging_escapes "
        f"{ws['engine_wave_aging_escapes']}",
        "# TYPE infinistore_engine_wave_held_flushes counter",
        f"infinistore_engine_wave_held_flushes {ws['engine_wave_held_flushes']}",
        "# TYPE infinistore_engine_wave_policy_waves counter",
        f"infinistore_engine_wave_policy_waves {ws['engine_wave_policy_waves']}",
        "# TYPE infinistore_engine_wave_defer_age_us_p99 gauge",
        "infinistore_engine_wave_defer_age_us_p99 "
        f"{ws['engine_wave_defer_age_us_p99']}",
        "# TYPE infinistore_engine_wave_bucket_occupancy gauge",
        "infinistore_engine_wave_bucket_occupancy "
        f"{ws['engine_wave_bucket_occupancy']}",
    ]


def _engine_wave_status():
    """The process-wide wave-policy counter snapshot, or None when no
    engine has run here. Lazy on purpose (same discipline as
    ``_disagg_status``): ``infinistore_tpu_torch.engine`` pulls in the
    torch stack, and the core client/server API must stay importable without
    it — so this only *observes* an already-imported module
    (``sys.modules``), never imports one."""
    eng = sys.modules.get("infinistore_tpu_torch.engine")
    if eng is None:
        return None
    return eng.wave_counters().status()


def _prof_prometheus_lines(ps: dict) -> list:
    """Sampling-profiler gauge families for /metrics, from the flat
    ``profiling.SamplingProfiler.status`` snapshot. The counters checker
    (ITS-C008, tools/analysis/counters.py) holds this exporter to the
    ``prof_*`` status vocabulary both ways — a profiler whose coverage
    dashboards cannot see is observability drift
    (docs/observability.md, profiling section)."""
    return [
        "# TYPE infinistore_prof_samples counter",
        f"infinistore_prof_samples {ps['prof_samples']}",
        "# TYPE infinistore_prof_tagged_samples counter",
        f"infinistore_prof_tagged_samples {ps['prof_tagged_samples']}",
        "# TYPE infinistore_prof_threads gauge",
        f"infinistore_prof_threads {ps['prof_threads']}",
        "# TYPE infinistore_prof_buckets gauge",
        f"infinistore_prof_buckets {ps['prof_buckets']}",
        "# TYPE infinistore_prof_bucket_drops counter",
        f"infinistore_prof_bucket_drops {ps['prof_bucket_drops']}",
        "# TYPE infinistore_prof_pending gauge",
        f"infinistore_prof_pending {ps['prof_pending']}",
        "# TYPE infinistore_prof_pending_drops counter",
        f"infinistore_prof_pending_drops {ps['prof_pending_drops']}",
        "# TYPE infinistore_prof_snapshots gauge",
        f"infinistore_prof_snapshots {ps['prof_snapshots']}",
        "# TYPE infinistore_prof_hz gauge",
        f"infinistore_prof_hz {ps['prof_hz']}",
        "# TYPE infinistore_prof_ticks counter",
        f"infinistore_prof_ticks {ps['prof_ticks']}",
        "# TYPE infinistore_prof_tick_us counter",
        f"infinistore_prof_tick_us {ps['prof_tick_us']}",
    ]


def _timeseries_prometheus_lines(ts: dict) -> list:
    """Metrics-history gauge families for /metrics, from the flat
    ``telemetry.MetricsHistory.status`` snapshot (the same dict
    ``GET /timeseries`` serves alongside the series index). Held to the
    ``timeseries_*`` vocabulary both ways by ITS-C008
    (docs/observability.md, time-series section)."""
    return [
        "# TYPE infinistore_timeseries_series gauge",
        f"infinistore_timeseries_series {ts['timeseries_series']}",
        "# TYPE infinistore_timeseries_points gauge",
        f"infinistore_timeseries_points {ts['timeseries_points']}",
        "# TYPE infinistore_timeseries_samples counter",
        f"infinistore_timeseries_samples {ts['timeseries_samples']}",
        "# TYPE infinistore_timeseries_sources gauge",
        f"infinistore_timeseries_sources {ts['timeseries_sources']}",
        "# TYPE infinistore_timeseries_source_failures counter",
        f"infinistore_timeseries_source_failures {ts['timeseries_source_failures']}",
        "# TYPE infinistore_timeseries_dropped_series counter",
        f"infinistore_timeseries_dropped_series {ts['timeseries_dropped_series']}",
        "# TYPE infinistore_timeseries_anomalies counter",
        f"infinistore_timeseries_anomalies {ts['timeseries_anomalies']}",
        "# TYPE infinistore_timeseries_interval_s gauge",
        f"infinistore_timeseries_interval_s {ts['timeseries_interval_s']}",
        "# TYPE infinistore_timeseries_capacity gauge",
        f"infinistore_timeseries_capacity {ts['timeseries_capacity']}",
        "# TYPE infinistore_timeseries_last_pass_ms gauge",
        f"infinistore_timeseries_last_pass_ms {ts['timeseries_last_pass_ms']}",
    ]


def _slo_prometheus_lines(slo: dict) -> list:
    """SLO gauge families for /metrics, from the flat ``SloEngine.status``
    snapshot (the same dict ``GET /slo`` serves). The counters checker
    (ITS-C006, tools/analysis/counters.py) holds this exporter to the
    ``slo_*`` status vocabulary — an SLI dashboards cannot see is
    observability drift (docs/observability.md)."""
    lines = [
        "# TYPE infinistore_slo_availability gauge",
        f"infinistore_slo_availability {slo['slo_availability']}",
        "# TYPE infinistore_slo_fg_p99_us gauge",
        f"infinistore_slo_fg_p99_us {slo['slo_fg_p99_us']}",
        "# TYPE infinistore_slo_cold_p99_us gauge",
        f"infinistore_slo_cold_p99_us {slo['slo_cold_p99_us']}",
        "# TYPE infinistore_slo_miss_rate gauge",
        f"infinistore_slo_miss_rate {slo['slo_miss_rate']}",
        "# TYPE infinistore_slo_reshard_drain gauge",
        f"infinistore_slo_reshard_drain {slo['slo_reshard_drain']}",
        "# TYPE infinistore_slo_burn_rate_max gauge",
        f"infinistore_slo_burn_rate_max {slo['slo_burn_rate_max']}",
        "# TYPE infinistore_slo_alerts_firing gauge",
        f"infinistore_slo_alerts_firing {slo['slo_alerts_firing']}",
        "# TYPE infinistore_slo_alerts_total counter",
        f"infinistore_slo_alerts_total {slo['slo_alerts_total']}",
        "# TYPE infinistore_slo_burn_rate gauge",
    ]
    for name, detail in sorted(slo.get("objectives", {}).items()):
        for window, burn in sorted(detail.get("burn_rates", {}).items()):
            lines.append(
                f'infinistore_slo_burn_rate{{objective="{name}",'
                f'window="{window}"}} {burn}'
            )
    return lines


def _events_prometheus_lines(counts: dict) -> list:
    """Per-kind event-journal emit totals (``EventJournal.counts``); the
    full vocabulary is enumerated so a kind that never fired still scrapes
    as an explicit 0 (rate() needs the zero points)."""
    lines = ["# TYPE infinistore_events_total counter"]
    for kind in telemetry.EVENT_KINDS:
        lines.append(
            f'infinistore_events_total{{kind="{kind}"}} {counts.get(kind, 0)}'
        )
    return lines


def _trace_payload(stats: dict, fmt: str = "json",
                   member_spans: dict = None) -> bytes:
    """GET /trace body: recent spans from the process flight recorder
    joined with the local server's trace tick ring (``stats["trace"]``).

    ``fmt="json"`` (default) returns the span/tick dump plus the stage
    schema (``tracing.STAGES`` — the vocabulary the ITS-T checker holds
    producers and docs to); ``fmt="chrome"`` returns Chrome trace-event
    format — save the body to a file and load it in Perfetto
    (https://ui.perfetto.dev) or chrome://tracing (docs/observability.md).

    ``member_spans`` (``?scope=cluster`` with a fleet scraper attached):
    per-member scraped span sets to merge with the local recorder by
    trace id onto one timeline — a striped/replicated/reshard op that
    fanned out across processes renders as ONE tree, with one Perfetto
    track lane per member in the chrome format.

    Either way the payload cross-links the event journal: every journal
    event carrying a trace id present in the dump rides along in
    ``events``, so "why was this op slow" (breaker trip? epoch bump? QoS
    storm?) is answerable from one response."""
    trace = stats.get("trace", {})
    server_spans = tracing.server_tick_spans(trace)
    rec = tracing.recorder()
    client_spans = rec.snapshot() if rec is not None else []
    scope = "local" if member_spans is None else "cluster"
    if member_spans is not None:
        merged = telemetry.cluster_spans(
            client_spans + server_spans, member_spans
        )
    else:
        merged = client_spans + server_spans
    events = telemetry.get_journal().for_trace(
        {s.get("trace_id", 0) for s in merged} - {0}
    )
    if fmt == "chrome":
        payload = {
            "traceEvents": (
                telemetry.cluster_chrome_events(merged)
                if member_spans is not None
                else tracing.chrome_trace_events(merged)
            ),
            "displayTimeUnit": "ms",
        }
        return _http_response(200, payload)
    if member_spans is not None:
        return _http_response(200, {
            "enabled": tracing.enabled(),
            "scope": scope,
            "stages": list(tracing.STAGES),
            "spans": merged,
            "members": ["local", *member_spans.keys()],
            "events": events,
        })
    return _http_response(200, {
        "enabled": tracing.enabled(),
        "scope": scope,
        "stages": list(tracing.STAGES),
        "spans": client_spans,
        "server_spans": server_spans,
        "events": events,
        "slow_ops": rec.slow_snapshot() if rec is not None else [],
        "slow_ops_total": rec.slow_ops_total if rec is not None else 0,
        "recorded": rec.recorded if rec is not None else 0,
        "dropped": rec.dropped if rec is not None else 0,
        "server_recorded": trace.get("recorded", 0),
        "server_dropped": trace.get("dropped", 0),
    })


class ManageServer:
    """The management plane: /purge, /kvmap_len (reference server.py:25-39),
    /selftest (advertised in reference README.md:56-57 but missing), /stats,
    /usage, /metrics (Prometheus), /health (SLO-verdict-aware), /trace (the
    op-tracing dump; ?scope=cluster joins the fleet, docs/observability.md),
    /slo (burn-rate verdict) and /events (the causal event journal) — plus,
    with a cluster attached, /membership GET/POST (the elastic-membership
    control surface, docs/membership.md) and /tiers (the tiered capacity
    plane's tier_* counter snapshot, docs/tiering.md).

    ``cluster``: an optional ``ClusterKVConnector``-shaped object (needs
    ``membership`` / ``resharder`` / ``membership_status()`` / ``health()``
    and the add/remove/mark_dead transitions). A plain store server runs
    without one; a pool operator embeds the manage plane next to the
    cluster client to drive membership over HTTP. Connections the manage
    plane itself creates (POST add) are OWNED here: once their member
    reaches a terminal state (REMOVED after a drain, DEAD after a crash)
    they are closed on the next control-plane request — HTTP-driven
    join/leave churn never accumulates native connections."""

    def __init__(self, config: ServerConfig, cluster=None, scraper=None,
                 gossip=None, history=None):
        self.config = config
        self.cluster = cluster
        # Metrics history (docs/observability.md, time-series section): an
        # attached ``telemetry.MetricsHistory`` lights up ``GET
        # /timeseries`` (sparkline/trend queries) and its
        # ``infinistore_timeseries_*`` /metrics families. ``GET /profile``
        # needs no attachment — it serves the process-wide sampling
        # profiler (``profiling.profiler()``), which exists whenever
        # profiling was enabled.
        self.history = history
        # Fleet telemetry (docs/observability.md): an attached
        # ``telemetry.FleetScraper`` lights up ``GET /trace?scope=cluster``
        # (cluster-joined traces) and the per-member rows of ``GET /slo``.
        # ``/slo`` and ``/events`` themselves serve the process-wide SLO
        # engine and event journal and need no scraper.
        self.scraper = scraper
        # Crash-safe coordination (docs/membership.md): an attached
        # ``telemetry.GossipAgent`` adds its ``infinistore_gossip_*``
        # families to /metrics. The ``POST /gossip`` + ``GET /bootstrap``
        # routes need only the cluster — a peer can exchange views with a
        # process that runs no agent of its own.
        self.gossip = gossip
        self._server = None
        # member_id -> InfinityConnection this manage plane connected
        # (POST add); swept once the member goes terminal. Guarded: the
        # add runs on an executor thread (_add_member_blocking) while a
        # concurrent /membership request sweeps on the event loop —
        # unguarded, the insert can race the pop (ITS-R001).
        # its: guard[_owned_conns: _conns_lock]
        self._conns_lock = threading.Lock()
        self._owned_conns = {}

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            request_line = await asyncio.wait_for(reader.readline(), timeout=10)
            parts = request_line.decode("latin-1").split()
            if len(parts) < 2:
                writer.close()
                return
            method, path = parts[0], parts[1]
            # Drain headers, keeping Content-Length (POST bodies).
            content_len = 0
            while True:
                line = await asyncio.wait_for(reader.readline(), timeout=10)
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _, value = line.decode("latin-1").partition(":")
                if name.strip().lower() == "content-length":
                    try:
                        # Clamp both ways: a negative length must not reach
                        # readexactly().
                        content_len = max(0, min(int(value.strip()), 1 << 20))
                    except ValueError:
                        content_len = 0
            body = b""
            if content_len:
                body = await asyncio.wait_for(
                    reader.readexactly(content_len), timeout=10
                )
            resp = await self._route(method, path, body)
            writer.write(resp)
            await writer.drain()
        except (asyncio.TimeoutError, asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _route(self, method: str, path: str, body: bytes = b"") -> bytes:
        path, _, query = path.partition("?")
        try:
            if path == "/purge" and method == "POST":
                count = await asyncio.to_thread(_lib.purge_kv_map)
                return _http_response(200, {"status": "ok", "count": count})
            if path == "/kvmap_len" and method == "GET":
                n = await asyncio.to_thread(_lib.get_kvmap_len)
                return _http_response(200, {"len": n})
            if path == "/stats" and method == "GET":
                stats = await asyncio.to_thread(_lib.get_server_stats)
                return _http_response(200, stats)
            if path == "/usage" and method == "GET":
                stats = await asyncio.to_thread(_lib.get_server_stats)
                return _http_response(200, {"usage": stats["usage"]})
            if path == "/metrics" and method == "GET":
                ms = (
                    self.cluster.membership_status()
                    if self.cluster is not None else None
                )
                gs = self.gossip.status() if self.gossip is not None else None
                ts = (
                    self.cluster.tiering.status()
                    if self.cluster is not None
                    and getattr(self.cluster, "tiering", None) is not None
                    else None
                )
                params = urllib.parse.parse_qs(query)
                slo = telemetry.slo_engine().status()
                counts = telemetry.get_journal().counts()
                prof = profiling.profiler()
                ps = prof.status() if prof is not None else None
                hs = (
                    self.history.status()
                    if self.history is not None else None
                )
                ds = _disagg_status()
                ws = _engine_wave_status()
                try:
                    stats = await asyncio.to_thread(_lib.get_server_stats)
                except Exception:
                    # A cluster-side manage plane may run with no local
                    # store server in-process: membership + telemetry
                    # gauges must still scrape. A plain store server's
                    # failure stays a 500.
                    if ms is None:
                        raise
                    lines = (
                        _membership_prometheus_lines(ms)
                        + (_gossip_prometheus_lines(gs) if gs is not None else [])
                        + (_tier_prometheus_lines(ts) if ts is not None else [])
                        + (_disagg_prometheus_lines(ds) if ds is not None else [])
                        + (_engine_wave_prometheus_lines(ws)
                           if ws is not None else [])
                        + _slo_prometheus_lines(slo)
                        + (_prof_prometheus_lines(ps) if ps is not None else [])
                        + (_timeseries_prometheus_lines(hs)
                           if hs is not None else [])
                        + _events_prometheus_lines(counts)
                    )
                    body = ("\n".join(lines) + "\n").encode()
                    return (
                        f"HTTP/1.1 200 OK\r\n"
                        f"Content-Type: text/plain; version=0.0.4\r\n"
                        f"Content-Length: {len(body)}\r\n"
                        f"Connection: close\r\n\r\n"
                    ).encode() + body
                return _prometheus_text(
                    stats, membership_status=ms, slo_status=slo,
                    event_counts=counts, gossip_status=gs, tier_status=ts,
                    prof_status=ps, timeseries_status=hs, disagg_status=ds,
                    engine_wave_status=ws,
                    exemplars=params.get("exemplars") == ["1"],
                )
            if path == "/health" and method == "GET":
                # The health verdict CONSUMES the SLO engine: a fleet whose
                # error budget is burning is degraded even though this
                # process answers (docs/observability.md).
                slo = telemetry.slo_engine().status()
                return _http_response(200, {
                    "status": "ok" if slo["verdict"] == "ok" else "degraded",
                    "slo_verdict": slo["verdict"],
                    "slo_alerts_firing": slo["slo_alerts_firing"],
                })
            if path == "/slo" and method == "GET":
                # The SLO verdict endpoint: rolling SLIs, per-window burn
                # rates, firing alerts — plus the fleet scraper's
                # per-member health when one is attached.
                payload = telemetry.slo_engine().status()
                if self.scraper is not None:
                    payload["scraper"] = self.scraper.status()
                return _http_response(200, payload)
            if path == "/events" and method == "GET":
                # The causal event journal (?since_seq=N&limit=N): breaker
                # transitions, epoch bumps, quarantines, slow ops, QoS
                # storms, SLO alert edges — each with member/epoch/trace id.
                params = urllib.parse.parse_qs(query)
                try:
                    since = int(params.get("since_seq", ["0"])[0])
                    limit = int(params.get("limit", ["0"])[0]) or None
                except ValueError:
                    return _http_response(400, {"error": "bad since_seq/limit"})
                journal = telemetry.get_journal()
                return _http_response(200, {
                    "events": journal.snapshot(since_seq=since, limit=limit),
                    "counts": journal.counts(),
                    "emitted": journal.emitted,
                    "capacity": journal.capacity,
                })
            if path == "/trace" and method == "GET":
                # Recent op spans (flight recorder + native tick ring):
                # default JSON dump, ?fmt=chrome for Perfetto. A manage
                # plane with no local store still serves the client spans.
                # ?scope=cluster (fleet scraper attached): refresh the
                # scrape OFF-loop and merge every member's spans with the
                # local recorder by trace id — one timeline, one Perfetto
                # lane per member.
                try:
                    stats = await asyncio.to_thread(_lib.get_server_stats)
                except Exception:
                    stats = {}
                params = urllib.parse.parse_qs(query)
                fmt = "chrome" if params.get("fmt") == ["chrome"] else "json"
                member_spans = None
                if (
                    params.get("scope") == ["cluster"]
                    and self.scraper is not None
                ):
                    await asyncio.to_thread(self.scraper.scrape_once)
                    member_spans = self.scraper.member_spans()
                return _trace_payload(stats, fmt, member_spans=member_spans)
            if path == "/profile" and method == "GET":
                # The continuous sampling profiler (docs/observability.md,
                # profiling section): folded-stack text by default (any
                # flamegraph tool; the stage is the root frame), ?fmt=chrome
                # for a Perfetto sampling track on the same CLOCK_MONOTONIC
                # timeline as /trace, ?save=<name> to store a diff base,
                # ?diff=<name> for a differential profile against one.
                # Off-loop: the read side force-resolves pending samples.
                return await self._profile_get(query)
            if path == "/timeseries" and method == "GET":
                # The metrics history (docs/observability.md, time-series
                # section): no params = the series index + timeseries_*
                # status; ?metric=<series>&window=<seconds> = the points.
                return await self._timeseries_get(query)
            if path == "/selftest" and method == "GET":
                return _http_response(200, await asyncio.to_thread(self._selftest))
            if path == "/tiers" and method == "GET":
                # Tiered capacity plane (docs/tiering.md): the flat
                # tier_* counter snapshot — the TierManager.status
                # vocabulary /metrics exports as infinistore_tier_*
                # (ITS-C007) — plus each cold member's breaker row.
                tiering = (
                    getattr(self.cluster, "tiering", None)
                    if self.cluster is not None else None
                )
                if tiering is None:
                    return _http_response(
                        200, {"enabled": False, "error": "no tiering attached"}
                    )
                return _http_response(200, {
                    "enabled": True,
                    **tiering.status(),
                    "cold_members": [
                        {"member_id": mid, **h.as_dict()}
                        for mid, h in zip(
                            self.cluster.cold_ids, self.cluster._cold_health
                        )
                    ],
                })
            if path == "/disagg" and method == "GET":
                # Disaggregated prefill->decode handoff (docs/
                # disaggregation.md): the flat disagg_* counter snapshot —
                # the DisaggCounters.status vocabulary /metrics exports as
                # infinistore_disagg_* (ITS-C009). Served only when a
                # handoff has run in this process; the module stays
                # unimported (and torch unloaded) otherwise.
                ds = _disagg_status()
                if ds is None:
                    return _http_response(
                        200, {"enabled": False, "error": "no handoff has run"}
                    )
                return _http_response(200, {"enabled": True, **ds})
            if path == "/wave" and method == "GET":
                # Skew-aware wave flush policy (docs/serving_load.md): the
                # flat engine_wave_* counter snapshot — the
                # engine.WaveCounters.status vocabulary /metrics exports as
                # infinistore_engine_wave_* (ITS-C010). Served only when an
                # engine has run in this process; the module stays
                # unimported (and torch unloaded) otherwise.
                ws = _engine_wave_status()
                if ws is None:
                    return _http_response(
                        200, {"enabled": False, "error": "no engine has run"}
                    )
                return _http_response(200, {"enabled": True, **ws})
            if path == "/membership" and method == "GET":
                return self._membership_get()
            if path == "/membership" and method == "POST":
                return await self._membership_post(body)
            if path == "/gossip" and method == "POST":
                return await self._gossip_post(body)
            if path == "/bootstrap" and method == "GET":
                return await self._bootstrap_get(query)
            if path in ("/purge", "/kvmap_len", "/stats", "/usage", "/metrics",
                        "/selftest", "/health", "/trace", "/membership",
                        "/slo", "/events", "/gossip", "/bootstrap", "/tiers",
                        "/profile", "/timeseries", "/disagg", "/wave"):
                return _http_response(405, {"error": "method not allowed"})
            return _http_response(404, {"error": "not found"})
        except Exception as e:  # control plane must not die on a bad request
            Logger.error(f"manage request {method} {path} failed: {e}")
            return _http_response(500, {"error": str(e)})

    # -- elastic membership control surface (docs/membership.md) -------------

    def _sweep_owned_conns(self):
        """Close manage-plane-owned connections whose member went terminal
        (REMOVED after a drain completes, DEAD after a crash). Lazy: runs
        on each /membership request, so a leave's connection lives exactly
        until its drain finalizes."""
        if self.cluster is None or not self._owned_conns:  # its: allow[ITS-R001]
            return
        from .membership import MemberState

        view = self.cluster.membership.view()
        doomed = []
        # Audited bare read above: an empty-check racing an insert only
        # defers the sweep to the next request. The pop itself is guarded.
        # Audited lock-on-loop: O(members) dict scan + pop, no I/O — the
        # blocking close() runs after release (same discipline as the
        # cluster's _cat_lock sites).
        with self._conns_lock:  # its: allow[ITS-L003]
            for mid in list(self._owned_conns):
                if view.state_of(mid) in MemberState.TERMINAL:
                    doomed.append(self._owned_conns.pop(mid))
        for conn in doomed:
            try:
                conn.close()
            except Exception:
                pass

    async def _profile_get(self, query: str) -> bytes:
        """GET /profile: the process sampling profiler's aggregate.

        Default: folded-stack text (``stage;frame;...;leaf count``) —
        pipe into flamegraph.pl / speedscope / Perfetto's folded importer
        for per-stage flames. ``?fmt=chrome``: Chrome trace-event JSON —
        a sampling track on the same monotonic timeline as ``GET
        /trace``, so spans and stacks line up when both files load in
        one Perfetto session. ``?save=<name>`` stores the current
        aggregate as a named diff base (bounded); ``?diff=<name>``
        returns the differential profile against it. 200 with
        ``enabled: false`` when profiling was never configured (the
        /tiers discipline); reads run off-loop — the read side
        force-resolves pending samples."""
        prof = profiling.profiler()
        if prof is None:
            return _http_response(200, {
                "enabled": False,
                "error": "profiling off (INFINISTORE_TPU_PROFILE=1 or "
                         "profiling.configure(enabled=True))",
            })
        params = urllib.parse.parse_qs(query)
        save = params.get("save", [None])[0]
        diff = params.get("diff", [None])[0]
        if save:
            saved = await asyncio.to_thread(prof.snapshot_save, save)
            return _http_response(200, {
                "enabled": profiling.enabled(), "saved": saved,
                "snapshots": prof.snapshot_names(),
            })
        if diff:
            delta = await asyncio.to_thread(prof.diff, diff)
            if delta is None:
                return _http_response(404, {
                    "error": f"no saved snapshot {diff!r}",
                    "snapshots": prof.snapshot_names(),
                })
            return _http_response(200, {
                "enabled": profiling.enabled(), **delta,
            })
        if params.get("fmt") == ["chrome"]:
            events = await asyncio.to_thread(prof.chrome_events)
            return _http_response(200, {
                "traceEvents": events, "displayTimeUnit": "ms",
            })
        folded = await asyncio.to_thread(prof.folded)
        return _text_response(200, folded + ("\n" if folded else ""))

    async def _timeseries_get(self, query: str) -> bytes:
        """GET /timeseries: the metrics history's trend surface. Without
        params: the series index plus the flat ``timeseries_*`` status
        (the vocabulary /metrics exports as ``infinistore_timeseries_*``,
        ITS-C008). ``?metric=<series>[&window=<seconds>]``: the retained
        ``[t_s, value]`` points (monotonic-clock seconds); REPEATED
        ``metric`` params return every known series' points in one
        response under ``metrics`` (the ``tools.top`` sparkline fetch —
        one request per frame, not one per series; repeated params
        rather than a comma list because label values may contain
        commas). 404 for an unknown single series, 400 for a bad
        (non-finite) window."""
        if self.history is None:
            return _http_response(200, {
                "enabled": False, "error": "no metrics history attached",
            })
        params = urllib.parse.parse_qs(query)
        metrics = params.get("metric", [])
        if not metrics:
            return _http_response(200, {
                "enabled": True,
                "series": self.history.series_names(),
                **self.history.status(),
            })
        try:
            window = params.get("window", [None])[0]
            window_s = float(window) if window is not None else None
        except ValueError:
            return _http_response(400, {"error": "bad window"})
        if window_s is not None and not math.isfinite(window_s):
            # float('nan')/'inf' parse fine but nan poisons the horizon
            # compare and serializes as bare NaN — invalid JSON.
            return _http_response(400, {"error": "bad window"})
        if len(metrics) > 1:
            known = set(self.history.series_names())
            return _http_response(200, {
                "window_s": window_s,
                "metrics": {
                    m: self.history.points(m, window_s=window_s)
                    for m in metrics if m in known
                },
            })
        metric = metrics[0]
        if metric not in self.history.series_names():
            return _http_response(404, {
                "error": f"unknown series {metric!r}",
            })
        return _http_response(200, {
            "metric": metric,
            "window_s": window_s,
            "points": self.history.points(metric, window_s=window_s),
        })

    def _membership_get(self) -> bytes:
        """GET /membership: the epoch-stamped view (per-member states) plus
        the flat membership_*/reshard_* counter snapshot, verbatim from
        ``membership_status()`` — the counters checker (ITS-C005) holds
        this route to the status vocabulary."""
        if self.cluster is None:
            return _http_response(
                200, {"enabled": False, "error": "no cluster attached"}
            )
        self._sweep_owned_conns()
        view = self.cluster.membership.view()
        return _http_response(200, {
            "enabled": True,
            **view.as_dict(),
            **self.cluster.membership_status(),
        })

    def _structured_error(self, status: int, reason: str,
                          detail: str = "") -> bytes:
        """Structured JSON error body for the membership/gossip/bootstrap
        control surface: machine-readable ``reason`` plus the CURRENT
        epoch, so a stale gossiping peer (or a retrying operator script)
        can self-correct from the response instead of parsing prose
        (docs/membership.md)."""
        epoch = (
            self.cluster.membership.view().epoch
            if self.cluster is not None else 0
        )
        return _http_response(status, {
            "error": detail or reason, "reason": reason, "epoch": epoch,
        })

    async def _membership_post(self, body: bytes) -> bytes:
        """POST /membership: apply one membership transition.

        Body (JSON): ``{"action": "add", "host": ..., "service_port": ...,
        "member_id"?: ...}`` connects a new member and admits it JOINING
        (connect runs in a worker thread — the control plane must not block
        on a TCP connect, ITS-L001); ``{"action": "remove"|"mark_dead",
        "member_id": ...}`` drains / writes off an existing member. Returns
        the new epoch + status; errors are 400s with a structured body
        (``reason`` + current ``epoch``)."""
        if self.cluster is None:
            return self._structured_error(400, "no_cluster",
                                          "no cluster attached")
        try:
            req = json.loads(body.decode() or "{}")
        except ValueError as e:
            return self._structured_error(400, "bad_json", repr(e))
        action = req.get("action")
        try:
            if action == "add":
                view = await asyncio.to_thread(
                    self._add_member_blocking, req
                )
            elif action in ("remove", "mark_dead"):
                if "member_id" not in req:
                    return self._structured_error(
                        400, "missing_field", "member_id required"
                    )
                fn = (
                    self.cluster.remove_member if action == "remove"
                    else self.cluster.mark_dead
                )
                view = fn(req["member_id"])
            else:
                return self._structured_error(
                    400, "unknown_action", f"unknown action {action!r}"
                )
        except KeyError as e:
            # "add" without host/service_port, or a transition against a
            # member id the view does not know.
            reason = "missing_field" if action == "add" else "invalid_transition"
            return self._structured_error(400, reason, repr(e))
        except ValueError as e:
            # Rejected transitions (duplicate live id, bad state, last
            # placement member): the epoch in the body tells the caller
            # what view the rejection was judged against.
            return self._structured_error(400, "invalid_transition", repr(e))
        except TypeError as e:
            return self._structured_error(400, "bad_payload", repr(e))
        self._sweep_owned_conns()
        return _http_response(200, {
            "status": "ok",
            "epoch": view.epoch,
            **self.cluster.membership_status(),
        })

    async def _gossip_post(self, body: bytes) -> bytes:
        """POST /gossip: one half of an anti-entropy exchange
        (docs/membership.md, gossip section). The sender's epoch-stamped
        view merges into ours through the tombstone-aware lattice (off
        the event loop — a merge may dial a newly learned member); the
        response carries OUR post-merge view, which the sender merges
        back — so a single exchange converges both processes in either
        direction, and a stale sender self-corrects from the body.
        Errors are structured (``reason`` + current ``epoch``)."""
        if self.cluster is None:
            return self._structured_error(400, "no_cluster",
                                          "no cluster attached")
        try:
            req = json.loads(body.decode() or "{}")
        except ValueError as e:
            return self._structured_error(400, "bad_json", repr(e))
        try:
            merged = await asyncio.to_thread(
                self.cluster.merge_remote_view, req
            )
        except (KeyError, ValueError, TypeError) as e:
            return self._structured_error(400, "bad_payload", repr(e))
        self._sweep_owned_conns()
        return _http_response(200, {
            "status": "ok",
            "merged": bool(merged),
            **self.cluster.gossip_payload(),
        })

    async def _bootstrap_get(self, query: str) -> bytes:
        """GET /bootstrap: the cold-client snapshot — the epoch-stamped
        view plus a bounded catalog dump (root records with holder
        block-levels), enough for a fresh process with only a seed list
        to reconstruct placement from any live member
        (``ClusterKVConnector.bootstrap``). ``?limit=N`` bounds the
        catalog rows (default 4096; ``catalog_total`` reports the full
        size). Runs off-loop — the catalog walk is O(n_roots)."""
        if self.cluster is None:
            return self._structured_error(400, "no_cluster",
                                          "no cluster attached")
        params = urllib.parse.parse_qs(query)
        try:
            limit = int(params.get("limit", ["4096"])[0])
        except ValueError:
            return self._structured_error(400, "bad_limit", "bad limit")
        payload = await asyncio.to_thread(
            self.cluster.bootstrap_payload, limit
        )
        return _http_response(200, {"enabled": True, **payload})

    def _add_member_blocking(self, req: dict):
        """Connect + admit a new member (worker-thread half of POST add)."""
        from .config import ClientConfig
        from .lib import InfinityConnection

        host, port = req["host"], int(req["service_port"])
        member_id = req.get("member_id") or f"{host}:{port}"
        conn = InfinityConnection(ClientConfig(
            host_addr=host, service_port=port, log_level="error",
        ))
        try:
            conn.connect()
            view = self.cluster.add_member(conn, member_id=member_id)
        except BaseException:
            # Whatever failed — unreachable host, rejected transition — the
            # native connection must not leak across operator retries.
            try:
                conn.close()
            except Exception:
                pass
            raise
        # Admitted: the manage plane owns this connection until the member
        # goes terminal (_sweep_owned_conns).
        with self._conns_lock:
            self._owned_conns[member_id] = conn
        return view

    def _selftest(self) -> dict:
        """Loopback write/read/delete through the real data plane."""
        import numpy as np

        from .lib import ClientConfig, InfinityConnection

        key = "__selftest__"
        conn = InfinityConnection(
            ClientConfig(
                host_addr="127.0.0.1",
                service_port=self.config.service_port,
                log_level="error",
            )
        )
        try:
            conn.connect()
            data = np.arange(4096, dtype=np.uint8)
            conn.tcp_write_cache(key, data.ctypes.data, data.nbytes)
            back = conn.tcp_read_cache(key)
            ok = bool(np.array_equal(back, data))
            conn.delete_keys([key])
            return {"status": "ok" if ok else "corrupt", "roundtrip_bytes": int(data.nbytes)}
        finally:
            conn.close()

    async def start(self):
        self._server = await asyncio.start_server(
            self._handle, host=self.config.host, port=self.config.manage_port
        )
        Logger.info(f"manage plane on {self.config.host}:{self.config.manage_port}")

    async def stop(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()


async def periodic_evict(config: ServerConfig):
    """Background eviction loop (reference server.py:157-186)."""
    while True:
        await asyncio.sleep(config.evict_interval)
        try:
            evicted = await asyncio.to_thread(
                _lib.evict_cache, config.evict_min_threshold, config.evict_max_threshold
            )
            if evicted:
                Logger.info(f"periodic evict: {evicted} entries")
        except Exception as e:
            Logger.error(f"periodic evict failed: {e}")


async def serve(config: ServerConfig) -> None:
    register_server(None, config)
    # /proc write = file IO; keep it off the event loop (ITS-L002).
    await asyncio.to_thread(prevent_oom)
    # Standing metrics history (docs/observability.md, time-series
    # section): the CLI server trends its own /metrics families so
    # GET /timeseries and the tools.top sparklines work out of the box —
    # one bounded source pass per interval (~0.5ms each; the bench's
    # timeseries_pass_cost receipt). INFINISTORE_TPU_HISTORY=0 opts out.
    history = None
    if os.environ.get("INFINISTORE_TPU_HISTORY", "1") not in ("", "0"):
        history = telemetry.MetricsHistory()
        # The manage plane binds config.host: loopback only reaches it on
        # a wildcard bind — a specific-interface bind must be scraped at
        # that address or the self-source fails every pass forever.
        self_host = (
            "127.0.0.1" if config.host in ("", "0.0.0.0", "::")
            else config.host
        )
        history.add_source("", telemetry.metrics_http_source(
            self_host, config.manage_port
        ))
    manage = ManageServer(config, history=history)
    await manage.start()
    if history is not None:
        history.start()
    tasks = []
    if config.evict_enabled:
        tasks.append(asyncio.create_task(periodic_evict(config)))

    stop_event = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop_event.set)
    Logger.info(f"infinistore-tpu serving on {config.host}:{config.service_port}")
    try:
        await stop_event.wait()
    finally:
        for t in tasks:
            t.cancel()
        if history is not None:
            await asyncio.to_thread(history.stop)
        await manage.stop()
        unregister_server()


def main(argv=None) -> int:
    config = parse_args(argv)
    config.verify()
    Logger.set_log_level(config.log_level)
    try:
        asyncio.run(serve(config))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
