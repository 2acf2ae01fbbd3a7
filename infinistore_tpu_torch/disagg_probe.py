#!/usr/bin/env python3
"""Probe of the in-process disagg handoff's timeline on one CUDA card: what
delays the overlapped leg's transfer. Run from the root of a checkout (the
package does not import it):

    python3 infinistore_tpu_torch/disagg_probe.py [--trials N] [--out FILE]

The setting is ``chip_smoke.py``'s disagg path: Llama-3-8B width in bf16
(random weights from a seed), block size 16, one 2,048-token prompt, 4
greedy tokens, a fresh 2 GiB store in 32 KiB units, one ``DisaggHarness``.
A trial is one overlapped leg (watermark 1) and one blocking leg, the
prompt's keys dropped after each. The install stream's ordering runs in two
modes, in the order ``per_call, once, once, per_call`` repeated ``--trials``
times, after one warm-up trial of each that is not reported:

- ``once``: the package as it is (the install stream waits for the compute
  stream once, at a prefetch's first ``install_layer``);
- ``per_call``: every ``install_layer`` also makes the install stream wait
  for an event recorded on the compute stream once its layer is staged (the
  ordering the first version of ``install_layer`` had), put in here by
  wrapping the method.

For each leg it records, in ms after the leg was called: when the producer
shipped each layer (its puts completed, host clock), when each layer's
install was queued (host clock), when that install's scatter completed on
the card (a timing event on the compute stream at the leg's start, against
the layer's readiness event; this process makes every ``torch.cuda.Event``
a timing one), and when each layer's first compute began (host clock).
The install's device lag (completion minus queueing) is the time the card
took to run it, waits on the compute stream included; the producer's layer
31 ship, overlapped against blocking, is what the decode's work on the
shared event loop costs the transfer. Prints the card's name and power
limit, then one JSON line per mode (medians over its trials); ``--out``
also writes every leg's timeline.
"""

import argparse
import asyncio
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
MODES = ("per_call", "once", "once", "per_call")


def _chip_smoke():
    """This checkout's ``chip_smoke.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(CHECKOUT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _timing_events(torch):
    """Make every ``torch.cuda.Event`` created from here on a timing one."""

    class TimedEvent(torch.cuda.Event):
        def __new__(cls, enable_timing=True, **kwargs):
            return super().__new__(cls, enable_timing=enable_timing, **kwargs)

    torch.cuda.Event = TimedEvent


def _instrument(torch, disagg, layerwise, mode, stamps):
    """Wrap ``install_layer`` (remember the prefetch; in ``per_call`` mode
    add the per-call wait) and ``stream_prefill`` (stamp each layer's ship)."""
    orig_install = layerwise.LayerwisePrefetch.install_layer
    orig_prefill = disagg.stream_prefill

    async def install_layer(self, caches, block_ids, layer, on_layer=None):
        stamps["prefetch"] = self
        if mode["value"] == "per_call" and self._install_stream is not None:
            await asyncio.wait([self._staged[layer]])
            after = torch.cuda.Event()
            after.record(torch.cuda.current_stream(caches[0][0].device))
            self._install_stream.wait_event(after)
        return await orig_install(self, caches, block_ids, layer, on_layer)

    async def stream_prefill(*args, on_layer_shipped=None, **kwargs):
        def shipped(layer):
            stamps["shipped"][layer] = (time.perf_counter() - stamps["t0"]) * 1e3
            if on_layer_shipped is not None:
                on_layer_shipped(layer)

        return await orig_prefill(*args, on_layer_shipped=shipped, **kwargs)

    layerwise.LayerwisePrefetch.install_layer = install_layer
    disagg.stream_prefill = stream_prefill


async def _leg(torch, cs, h, prompt, run, stamps, n_layers):
    torch.cuda.synchronize()
    start = torch.cuda.Event()
    events = cs._StampedEvents()
    stamps.update(t0=events.t0, shipped={}, prefetch=None)
    start.record()
    leg = await run(prompt, gen_tokens=cs.DISAGG_GEN_TOKENS, trace_events=events)
    torch.cuda.synchronize()
    h.drop(prompt)
    ready = stamps["prefetch"]._ready
    timeline = events.timeline()
    done = [start.elapsed_time(ready[layer]) for layer in range(n_layers)]
    return {
        "ttft_ms": leg["ttft_s"] * 1e3,
        "shipped_ms": [stamps["shipped"][layer] for layer in range(n_layers)],
        "install_ms": timeline["install"],
        "install_done_ms": done,
        "install_lag_ms": [d - q for d, q in zip(done, timeline["install"])],
        "compute_ms": timeline["compute"],
        "fallback": leg["result"].fallback,
    }


def _summary(legs):
    med = statistics.median
    out = {}
    for name in ("overlapped", "blocking"):
        rows = [t[name] for t in legs]
        out[name] = {
            "trials": len(rows),
            "ttft_ms": med(r["ttft_ms"] for r in rows),
            "layer31_shipped_ms": med(r["shipped_ms"][-1] for r in rows),
            "layer31_install_ms": med(r["install_ms"][-1] for r in rows),
            "layer31_install_done_ms": med(r["install_done_ms"][-1] for r in rows),
            "install_lag_ms_median": med(med(r["install_lag_ms"]) for r in rows),
            "install_lag_ms_max": med(max(r["install_lag_ms"]) for r in rows),
        }
    out["overlapped_minus_blocking_ttft_ms"] = [
        t["overlapped"]["ttft_ms"] - t["blocking"]["ttft_ms"] for t in legs]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=3,
                    help="rounds of per_call, once, once, per_call (default 3)")
    ap.add_argument("--out", help="write every leg's timeline to this JSON file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("disagg_probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, CHECKOUT)
    cs = _chip_smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    _timing_events(torch)
    from infinistore_tpu_torch import config as config_mod
    from infinistore_tpu_torch import disagg
    from infinistore_tpu_torch import lib as lib_mod
    from infinistore_tpu_torch.cuda import _ext, layerwise
    from infinistore_tpu_torch.models import llama

    _ext.kernels()
    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **cs.LLAMA3_8B)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    nb = cs.PROMPT_TOKENS // cfg.block_tokens
    gen_blocks = -(-(cs.PROMPT_TOKENS + cs.DISAGG_GEN_TOKENS) // cfg.block_tokens) - nb
    mode, stamps = {"value": "once"}, {}
    _instrument(torch, disagg, layerwise, mode, stamps)
    server = lib_mod.start_local_server(prealloc_bytes=2 << 30, block_bytes=32 << 10,
                                        pin_memory=False)
    conns = []

    def make_conn():
        conns.append(cs._client(lib_mod, config_mod, server.port))
        return conns[-1]

    h = None
    try:
        h = disagg.DisaggHarness(make_conn, cfg, num_blocks=2 * nb + gen_blocks, req_blocks=nb,
                                 gen_blocks=gen_blocks, model_id="llama-3-8b-disagg-probe",
                                 params=params, device="cuda")
        prompt = h.prompt(seed=1)

        async def trial():
            return {
                "overlapped": await _leg(torch, cs, h, prompt, lambda p, **kw: h.run_overlapped(
                    p, watermark=1, **kw), stamps, cfg.n_layers),
                "blocking": await _leg(torch, cs, h, prompt, h.run_blocking, stamps,
                                       cfg.n_layers),
            }

        async def drive():
            legs = {"per_call": [], "once": []}
            for name in ("per_call", "once"):  # warm-up, not reported
                mode["value"] = name
                await trial()
            for _ in range(args.trials):
                for name in MODES:
                    mode["value"] = name
                    legs[name].append(await trial())
            return legs

        legs = asyncio.run(drive())
    finally:
        if h is not None:
            h.close()
        for conn in conns:
            conn.close()
        server.stop()
    if any(t[name]["fallback"] for rows in legs.values() for t in rows
           for name in ("overlapped", "blocking")):
        raise AssertionError("disagg_probe: a leg fell back")
    for name, rows in legs.items():
        print(json.dumps({"mode": name, **_summary(rows)}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(legs, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
