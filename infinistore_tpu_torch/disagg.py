"""Overlapped layerwise prefill→decode handoff, in PyTorch (port of
``infinistore_tpu/disagg.py``).

The blocking baseline is store-and-forward: the prefill engine computes ALL
layers and saves, and only then may the decode engine fetch ALL layers
before its first step. This module overlaps the three legs:

  prefill engine                    store                   decode engine
  ─────────────────                 ─────                   ─────────────
  layer 0 compute ──ship 0──▶ keys published ──fetch 0──▶ install 0
  layer 1 compute ──ship 1──▶        ...        ──fetch 1──▶ install 1
       ...            (layer l ships WHILE l+1 computes)        ...
                                                first decode step launches
                                                once layer 0 installs; its
                                                layer-l attention waits only
                                                on layer l's install.

* ``stream_prefill`` chains ``prefill_layer`` (K4, and K2 into the producer's
  cache) and hands each layer's freshly scattered KV to
  ``KVConnector.stage_layer_save`` (K1, then a device-to-host copy on the
  staging side stream) as computed, so layer ``l``'s store puts overlap
  layer ``l+1``'s compute. The ships are handoff traffic, tagged
  ``wire.PRIORITY_FOREGROUND`` at the call site, and carry the request's
  trace context. Layers ship in natural order 0..L-1: the consumer is not
  probing (``known_hit``), and any other reader that races the handoff hits
  ``KeyNotFound`` on a deeper layer, which ``load`` maps to a miss.

* ``overlapped_decode`` is the layerwise admission: ``start_fetch_async`` in
  read-racing-write mode (``retry_missing_s``) returns per-layer handles, and
  the watermark rule gates compute: the first decode step launches once
  layers ``[0, watermark)`` are installed, and inside the step layer ``l``'s
  compute waits for ``install_layer(l)``. ``watermark=n_layers`` is the
  blocking fetch-all. A late or failed layer triggers the local recompute of
  the prefix (``_recompute_prefix``): no wrong bytes are served, the
  recompute is counted in ``disagg_fallback_recomputes`` and journaled as a
  ``disagg_fallback`` event. This is the JAX package's cache semantics, not a
  move to another device: everything runs on the caller's ``device``.

* Per-layer readiness on CUDA: the install of layer ``l`` runs its upload
  and K2 scatter on the prefetch's install stream and records an event after
  the scatter; the decode's layer-``l`` compute makes the compute stream (the
  event loop's current stream) wait for that event on the device
  (``LayerwisePrefetch.wait_installed``), never with a host synchronise.
  The install stream waits once, at the first install, for the compute
  stream's work queued so far (the caches' creation); later installs never
  wait for the compute stream, which writes a layer's cache only after its
  install (``LayerwisePrefetch.install_layer``).

* Byte identity by construction: every leg chains the same ``prefill_layer``
  and ``decode_wave_layer`` functions that ``prefill`` and
  ``verify_step_batched`` chain, at the same shapes, so the streamed prefill,
  the fallback recompute and the local leg write the same bytes, and the
  overlapped, blocking and local legs give the same logits bit for bit.

* ``DisaggHarness`` is the two-engine rig: one prefill-side and one
  decode-side ``KVConnector`` (separate store connections, separate block
  layouts) driving the four TTFT legs (overlapped, blocking fetch-all, local
  recompute, cold fetch), plus the ``python -m infinistore_tpu_torch.disagg``
  prefill role for runs with the producer in its own process
  (``--stall-after-layer`` pins a kill -9 window mid-handoff).

Counters are the ``disagg_*`` vocabulary the manage plane exports
(``server._disagg_prometheus_lines``).
"""

import argparse
import asyncio
import collections
import dataclasses
import os
import signal
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import telemetry, tracing, wire
from .connector import KVConnector
from .cuda import _ext
from .models.llama import (
    LlamaConfig,
    decode_wave_layer,
    embed_prompt,
    embed_wave,
    init_params,
    lm_logits,
    prefill_layer,
    wave_index,
)

__all__ = [
    "DisaggCounters",
    "DisaggHarness",
    "counters",
    "demo_config",
    "demo_prompt",
    "local_decode",
    "overlapped_decode",
    "reset_counters",
    "stream_prefill",
]


class DisaggCounters:
    """The disaggregation plane's counters, one ledger per process (module
    singleton via :func:`counters`). Each role counts its own side; the
    manage plane (``server._disagg_prometheus_lines``) exports whatever this
    process accumulated:

    - ``disagg_handoffs``: handoff legs this process took part in (producer
      ships and consumer admissions each count their own side).
    - ``disagg_overlap_layers``: layers whose fetch was still in flight when
      the first decode step launched and that installed mid-step (at least
      1 means the first token really overlapped the transfer).
    - ``disagg_watermark_stalls``: waits the overlap could not hide: compute
      reaching a layer before its bytes (``wait_stalls``) plus
      read-racing-write re-probes (``retry_stalls``).
    - ``disagg_fallback_recomputes``: handoffs that fell back to the local
      recompute (no wrong bytes, just work).
    - ``disagg_inflight_at_first_token``: layers not yet staged when the
      first decode step launched.
    - ``disagg_wrong_bytes``: mismatches between a handoff decode and the
      local-recompute oracle. Must stay 0.
    """

    def __init__(self):
        # Written only on the role's event loop; the manage plane's server
        # thread snapshots via status().
        self._c = {
            "disagg_handoffs": 0,
            "disagg_overlap_layers": 0,
            "disagg_watermark_stalls": 0,
            "disagg_fallback_recomputes": 0,
            "disagg_inflight_at_first_token": 0,
            "disagg_wrong_bytes": 0,
        }

    def bump(self, key: str, n: int = 1) -> None:
        self._c[key] += n

    def status(self) -> dict:
        """Counter snapshot for /metrics and /disagg."""
        c = self._c
        return {
            "disagg_handoffs": c["disagg_handoffs"],
            "disagg_overlap_layers": c["disagg_overlap_layers"],
            "disagg_watermark_stalls": c["disagg_watermark_stalls"],
            "disagg_fallback_recomputes": c["disagg_fallback_recomputes"],
            "disagg_inflight_at_first_token": c["disagg_inflight_at_first_token"],
            "disagg_wrong_bytes": c["disagg_wrong_bytes"],
        }


_COUNTERS = DisaggCounters()


def counters() -> DisaggCounters:
    """This process's disagg counter ledger (what /metrics exports)."""
    return _COUNTERS


def reset_counters() -> DisaggCounters:
    """Fresh ledger (tests and measured legs isolate their counts)."""
    global _COUNTERS
    _COUNTERS = DisaggCounters()
    return _COUNTERS


def demo_config(
    n_layers: int = 6, block_tokens: int = 8, dim: int = 64, ffn_dim: int = 128,
) -> LlamaConfig:
    """The demo model both roles must agree on (f32, as in the JAX package):
    the prefill process and the decode side derive identical params from
    the same seed and identical chain hashes from this one config, which is
    what makes the handoff byte-checkable end to end. ``dim``/``ffn_dim``
    scale the per-layer prefill compute."""
    return LlamaConfig(
        vocab=128, dim=dim, n_layers=n_layers, n_heads=4, n_kv_heads=2,
        ffn_dim=ffn_dim, block_tokens=block_tokens, dtype=torch.float32,
    )


def demo_prompt(config: LlamaConfig, n_blocks: int, seed: int = 0) -> List[int]:
    """Deterministic prompt of ``n_blocks`` complete blocks; ``seed`` varies
    the content, and so the chain hashes (each round can use a fresh prompt
    so its fetch really races its ship)."""
    n = n_blocks * config.block_tokens
    return ((np.arange(n) * 37 + seed * 101) % config.vocab).tolist()


def _demo_params(config: LlamaConfig, seed: int, device) -> dict:
    """The demo weights: drawn from a CPU generator seeded with ``seed``, so
    every role on every device holds the same values."""
    return init_params(config, torch.Generator().manual_seed(seed), device=device)


def _device_of(params) -> torch.device:
    return params["embed"].device


# -- prefill side ------------------------------------------------------------


async def stream_prefill(
    connector,
    params,
    config: LlamaConfig,
    prompt: Sequence[int],
    caches,
    block_table: np.ndarray,
    *,
    on_layer_shipped=None,
    stall_after_layer: Optional[int] = None,
    stall_s: float = 0.0,
    crash_after_layers: Optional[int] = None,
    max_inflight_ships: int = 4,
    pace_s: float = 0.0,
):
    """Prefill the prompt layer by layer, shipping each layer's KV to the
    store as computed: layer ``l``'s store puts overlap layer ``l+1``'s
    compute (the kernels queue on the card while ``ship()`` awaits the
    network). Returns ``(last-token logits, caches, blocks written)``; the
    logits are ``prefill``'s bit for bit (the same chain).

    Ships are handoff traffic: ``wire.PRIORITY_FOREGROUND`` at the call site
    (a decode consumer is waiting on these bytes), and the caller's active
    span rides every ship. Layers go out in natural order 0..L-1.

    ``max_inflight_ships`` bounds concurrently staged layers, so the
    connector's host staging pool never runs out on deep models: the oldest
    ship is awaited before staging past the bound.

    Fault hooks (the prefill process wires them to flags):
    ``stall_after_layer=k`` makes layers ``0..k`` durable, then sleeps
    ``stall_s``; ``crash_after_layers=n`` makes the first ``n`` layers
    durable, then SIGKILLs this process. ``on_layer_shipped(layer)`` fires
    after that layer's puts completed (durable when called).

    ``pace_s`` emulates a dedicated prefill engine's per-layer production
    rate: after each layer's compute, sleep ``pace_s`` before shipping it
    (0, the default, disables it)."""
    ds = counters()
    ds.bump("disagg_handoffs")
    span = tracing.active_span()
    if span is not None:
        span.annotate(
            handoff_layers=config.n_layers, handoff_prefix_blocks=len(block_table)
        )
    device = _device_of(params)
    table_dev = torch.as_tensor(np.asarray(block_table), dtype=torch.int32, device=device)
    ids = np.asarray(block_table)
    x = embed_prompt(params, torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                                             device=device))
    out = list(caches)
    ships: List[asyncio.Future] = []
    pending = collections.deque()

    async def _shipped(layer: int, ship) -> int:
        written = await ship()
        if on_layer_shipped is not None:
            on_layer_shipped(layer)
        return written

    for layer in range(config.n_layers):
        x, k_cache, v_cache = prefill_layer(
            params, x, out[layer][0], out[layer][1], table_dev, config, layer
        )
        out[layer] = (k_cache, v_cache)
        if pace_s > 0.0:
            await asyncio.sleep(pace_s)
        if len(pending) >= max_inflight_ships:
            await pending.popleft()
        ship = connector.stage_layer_save(
            prompt, layer, out[layer], ids,
            # Handoff class, named at the source: the decode engine is
            # already waiting on these exact bytes.
            priority=wire.PRIORITY_FOREGROUND,
        )
        fut = asyncio.ensure_future(_shipped(layer, ship))
        ships.append(fut)
        pending.append(fut)
        if stall_after_layer is not None and layer == stall_after_layer:
            await asyncio.gather(*ships)  # layers 0..k durable before the window
            await asyncio.sleep(stall_s)
        if crash_after_layers is not None and layer + 1 >= crash_after_layers:
            await asyncio.gather(*ships)
            os.kill(os.getpid(), signal.SIGKILL)
        # Yield the loop so the staged ship's puts issue while the next
        # layer's launches proceed: the producer-side overlap.
        await asyncio.sleep(0)
    written = sum(await asyncio.gather(*ships))
    return lm_logits(params, x[:, -1:])[0, -1], out, written


# -- decode side -------------------------------------------------------------


@dataclasses.dataclass
class DecodeResult:
    """One decode leg's outcome: greedy ``tokens``, the ``first_logits``
    (host float32, bitwise the device values) the oracle comparison uses,
    the updated caches, the ``time.perf_counter()`` instant the first
    token's logits were on the host, and the overlap accounting."""

    tokens: List[int]
    first_logits: np.ndarray
    caches: list
    t_first: float
    fallback: bool
    overlap_layers: int
    inflight_at_first_token: int
    watermark_stalls: int


def _recompute_prefix(params, config: LlamaConfig, prompt, caches, table_dev):
    """Layer-chunked local recompute of the whole prefix into ``table_dev``'s
    blocks: the fallback leg and the local baseline. Chains the same
    ``prefill_layer`` the prefill engine streams through, so the bytes are a
    successful handoff's (the scatter touches only the prefix blocks)."""
    x = embed_prompt(params, torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                                             device=_device_of(params)))
    out = list(caches)
    for layer in range(config.n_layers):
        x, k_cache, v_cache = prefill_layer(
            params, x, out[layer][0], out[layer][1], table_dev, config, layer
        )
        out[layer] = (k_cache, v_cache)
    return out


async def _run_decode_steps(
    params,
    config: LlamaConfig,
    state: dict,
    block_table: np.ndarray,
    first_token: int,
    start_pos: int,
    gen_tokens: int,
    max_blocks: int,
    ensure_layer=None,
    trace_events=None,
):
    """Greedy decode over ``state["out"]`` with the layerwise wave chain.
    ``ensure_layer(l)`` (first step only) is the watermark gate; it may
    replace ``state["out"]`` (a fallback recomputes), which is why the cache
    list lives in the shared ``state`` dict. Returns ``(tokens,
    first_logits, t_first)``."""
    device = _device_of(params)
    tables = torch.as_tensor(np.asarray(block_table), dtype=torch.int32, device=device)[None]
    tok = int(first_token)
    pos = start_pos
    tokens_out: List[int] = []
    first_logits = None
    t_first = 0.0
    for step in range(gen_tokens):
        x = embed_wave(params, torch.tensor([[tok]], dtype=torch.long, device=device))
        positions = torch.full((1, 1), pos, dtype=torch.int32, device=device)
        index = wave_index(positions, tables, config, max_blocks)
        for layer in range(config.n_layers):
            if step == 0 and ensure_layer is not None:
                await ensure_layer(layer)
            if step == 0 and trace_events is not None:
                trace_events.append(("compute", layer))
            x, k_cache, v_cache = decode_wave_layer(
                params, x, positions, state["out"][layer][0], state["out"][layer][1],
                tables, config, layer, max_blocks, index=index,
            )
            state["out"][layer] = (k_cache, v_cache)
        logits = lm_logits(params, x)[0, -1]
        if step == 0:
            # bf16 -> f32 is exact, so the host copy keeps the device bits.
            first_logits = logits.float().cpu().numpy()
            t_first = time.perf_counter()
        tok = int(logits.argmax())
        tokens_out.append(tok)
        pos += 1
    return tokens_out, first_logits, t_first


async def overlapped_decode(
    connector,
    params,
    config: LlamaConfig,
    prompt: Sequence[int],
    caches,
    block_ids: np.ndarray,
    block_table: np.ndarray,
    first_token: int,
    *,
    watermark: int = 1,
    known_hit: Optional[int] = None,
    retry_missing_s: float = 2.0,
    retry_interval_s: float = 0.0003,
    fetch_gate=None,
    gen_tokens: int = 1,
    trace_events=None,
) -> DecodeResult:
    """Watermark-gated decode admission over a (possibly still in-flight)
    handoff prefix. ``block_ids`` are the decode engine's physical blocks for
    the prefix; ``block_table`` is the padded per-request table row (prefix
    + generation blocks) every ``decode_wave_layer`` call sees.

    The watermark rule: layers ``[0, watermark)`` install before the first
    decode step launches (``watermark`` is clamped to ``[1, n_layers]``);
    past it, layer ``l``'s compute awaits ``install_layer(l)`` and then waits
    on the device for its scatter, so it never reads bytes still in flight,
    while deeper layers keep streaming. ``watermark=config.n_layers`` is the
    blocking fetch-all, bitwise the same logits.

    ``known_hit`` must be the producer-announced block count (a store probe
    mid-handoff is racy); ``retry_missing_s`` is the read-racing-write
    deadline. ``fetch_gate`` (``async fetch_gate(layer)``) is the
    announce-driven mode: layer ``l``'s store read waits for the producer's
    announcement instead of re-probing. A layer missing past the deadline
    (or a store failure) turns the leg into the local recompute: counted in
    ``disagg_fallback_recomputes``, journaled as ``disagg_fallback``, and the
    bytes are identical by construction.

    ``trace_events`` (tests): appended with ``("install", l)`` and
    ``("compute", l)`` tuples; every layer's install precedes its compute."""
    n_layers = config.n_layers
    n_blocks = len(block_ids)
    wm = max(1, min(watermark, n_layers))
    ds = counters()
    ds.bump("disagg_handoffs")
    span = tracing.active_span()
    handle = await connector.start_fetch_async(
        prompt,
        limit_blocks=n_blocks,
        known_hit=known_hit if known_hit is not None else n_blocks,
        retry_missing_s=retry_missing_s,
        # TTFT-critical: the re-probe cadence bounds how long a
        # just-published layer sits before its retry lands.
        retry_interval_s=retry_interval_s,
        fetch_gate=fetch_gate,
    )
    ids = np.asarray(block_ids)
    prefix_dev = torch.as_tensor(ids, dtype=torch.int32, device=_device_of(params))
    state = {"out": list(caches), "fallback": False}
    installed = [False] * n_layers
    via_handle = [False] * n_layers
    install_tasks: List[Optional[asyncio.Task]] = [None] * n_layers

    async def _install(layer: int) -> None:
        if layer > 0:
            # install_layer takes strictly increasing layers (staging
            # regions wrap): chain on the previous layer's task.
            await _layer_task(layer - 1)
        if installed[layer]:
            return
        if not state["fallback"]:
            out, ok = await handle.install_layer(state["out"], ids, layer)
            state["out"] = out
            if ok:
                installed[layer] = True
                via_handle[layer] = True
                if trace_events is not None:
                    trace_events.append(("install", layer))
                return
            # Late or failed layer: the handle is written off; recompute the
            # whole prefix locally. Layers already installed hold the same
            # bytes, so the step's activations so far stay valid. The
            # recompute runs on the compute stream, after the installs.
            state["fallback"] = True
            ds.bump("disagg_fallback_recomputes")
            telemetry.get_journal().emit(
                "disagg_fallback", failed_layer=layer, prefix_blocks=n_blocks
            )
            if span is not None:
                span.annotate(disagg_fallback_layer=layer)
            handle.wait_installed()
            state["out"] = _recompute_prefix(
                params, config, prompt, state["out"], prefix_dev
            )
        for other in range(n_layers):
            if not installed[other]:
                installed[other] = True
                if trace_events is not None:
                    trace_events.append(("install", other))

    def _layer_task(layer: int) -> asyncio.Task:
        # Memoized per-layer install: the install-ahead pipeline and the
        # compute loop await the same task, so a layer installs once.
        if install_tasks[layer] is None:
            install_tasks[layer] = asyncio.ensure_future(_install(layer))
        return install_tasks[layer]

    async def ensure_layer(layer: int) -> None:
        await _layer_task(layer)
        if via_handle[layer]:
            # The compute stream waits on the device for this layer's scatter.
            handle.wait_installed([layer])

    # Install-ahead: start every layer's install now, in order, so installs
    # ride behind the compute loop instead of in front of each layer's
    # attention; compute waits only when it outruns the transfer.
    for layer in range(n_layers):
        _layer_task(layer)
    for layer in range(wm):
        await ensure_layer(layer)
    # Launch instant: what is still in flight now is the overlap the
    # watermark bought.
    inflight = [
        l for l in range(n_layers) if not installed[l] and not handle.layer_ready(l)
    ]
    ds.bump("disagg_inflight_at_first_token", len(inflight))
    tokens, first_logits, t_first = await _run_decode_steps(
        params, config, state, block_table, first_token, len(prompt),
        gen_tokens, len(block_table), ensure_layer=ensure_layer,
        trace_events=trace_events,
    )
    overlap = sum(1 for l in inflight if via_handle[l])
    ds.bump("disagg_overlap_layers", overlap)
    stalls = handle.retry_stalls + handle.wait_stalls
    ds.bump("disagg_watermark_stalls", stalls)
    if span is not None:
        span.annotate(
            disagg_overlap_layers=overlap, disagg_inflight=len(inflight),
            disagg_stalls=stalls,
        )
    return DecodeResult(
        tokens=tokens,
        first_logits=first_logits,
        caches=state["out"],
        t_first=t_first,
        fallback=state["fallback"],
        overlap_layers=overlap,
        inflight_at_first_token=len(inflight),
        watermark_stalls=stalls,
    )


async def local_decode(
    params,
    config: LlamaConfig,
    prompt: Sequence[int],
    caches,
    block_ids: np.ndarray,
    block_table: np.ndarray,
    first_token: int,
    *,
    gen_tokens: int = 1,
) -> DecodeResult:
    """The no-store baseline and the byte oracle: recompute the prefix
    locally (the chain the prefill and the fallback run), then the same
    decode steps. A handoff decode whose ``first_logits`` differ bitwise
    from this leg's moved wrong bytes."""
    state = {
        "out": _recompute_prefix(
            params, config, prompt, list(caches),
            torch.as_tensor(np.asarray(block_ids), dtype=torch.int32,
                            device=_device_of(params)),
        ),
        "fallback": False,
    }
    tokens, first_logits, t_first = await _run_decode_steps(
        params, config, state, block_table, first_token, len(prompt),
        gen_tokens, len(block_table),
    )
    return DecodeResult(
        tokens=tokens, first_logits=first_logits, caches=state["out"],
        t_first=t_first, fallback=False, overlap_layers=0,
        inflight_at_first_token=0, watermark_stalls=0,
    )


# -- two-engine harness ------------------------------------------------------


class DisaggHarness:
    """Two-engine prefill→decode rig over one store.

    ``make_conn`` returns a fresh connected store connection; the harness
    builds one prefill-side and one decode-side :class:`KVConnector` on
    separate connections with separate block layouts (the decode engine
    never shares the prefill engine's physical blocks, only store keys).
    ``params``: ready-made weights (``params_from_numpy`` or ``init_params``
    output on ``device``); without them the demo weights are drawn from
    ``seed``. ``device`` defaults to ``"cuda"`` and raises without a card.
    Call :meth:`close` before closing the connections.

    Legs (each returns ``{"ttft_s", "result", "written"}``; TTFT is measured
    from the leg's request-arrival instant, before any compute or fetch):

    - :meth:`run_overlapped`: streamed prefill and watermark-gated decode,
      concurrently on one event loop (the handoff under test).
    - :meth:`run_blocking`: the same with ``watermark=n_layers``.
    - :meth:`run_local`: no store; local recompute (the byte oracle).
    - :meth:`run_cold`: the whole prefill durable first, then a fetch-all
      decode (store-and-forward).

    With the producer in its own process (``python -m
    infinistore_tpu_torch.disagg --role prefill``), :meth:`run_overlapped`
    is given ``prefill=False``, and :meth:`run_proc` drives a
    :class:`PrefillProcess`."""

    def __init__(
        self,
        make_conn,
        config: Optional[LlamaConfig] = None,
        *,
        num_blocks: int = 32,
        req_blocks: int = 4,
        gen_blocks: int = 1,
        seed: int = 0,
        model_id: str = "disagg-demo",
        first_token: int = 42,
        params=None,
        device="cuda",
    ):
        self.device = _ext.resolve_device(device)
        self.config = config or demo_config()
        self.num_blocks = num_blocks
        self.req_blocks = req_blocks
        self.gen_blocks = gen_blocks
        self.first_token = first_token
        self.params = (params if params is not None
                       else _demo_params(self.config, seed, self.device))
        spec = self.config.kv_spec(num_blocks)
        self.prefill_kv = KVConnector(
            make_conn(), spec, model_id, max_blocks=req_blocks, device=self.device
        )
        self.decode_kv = KVConnector(
            make_conn(), spec, model_id, max_blocks=req_blocks, device=self.device
        )

    def close(self) -> None:
        """Release both connectors' staging pools (before the connections
        close)."""
        self.prefill_kv.close()
        self.decode_kv.close()

    def tables(self):
        """(prefill table, decode prefix ids, decode padded table row):
        disjoint layouts, so a byte match proves store transport."""
        n = self.req_blocks
        prefill_table = np.arange(n, dtype=np.int32)
        decode_ids = np.arange(n, dtype=np.int32) + n
        gen = np.arange(self.gen_blocks, dtype=np.int32) + 2 * n
        return prefill_table, decode_ids, np.concatenate([decode_ids, gen])

    def prompt(self, seed: int = 0, n_blocks: Optional[int] = None) -> List[int]:
        return demo_prompt(self.config, n_blocks or self.req_blocks, seed=seed)

    def trace_prompts(self, trace, count: Optional[int] = None) -> List[List[int]]:
        """Materialise a load-generator trace (a ``loadgen.Trace``, the
        port's or the JAX package's: ``prompts(block_tokens, vocab=,
        max_blocks=)``) into prompts sized for this harness: clamped to
        ``req_blocks`` so every prompt fits the per-request table."""
        prompts = trace.prompts(
            self.config.block_tokens, vocab=self.config.vocab,
            max_blocks=self.req_blocks,
        )
        return prompts[:count] if count is not None else prompts

    def fresh_caches(self):
        return self.config.kv_spec(self.num_blocks).make_caches(self.device)

    def drop(self, prompt) -> int:
        """Drop the prompt's keys so the next round's fetch really races its
        ship."""
        return self.decode_kv.drop(prompt)

    async def _handoff(
        self, prompt, *, watermark: int, gen_tokens: int,
        retry_missing_s: float, prefill: bool = True, trace_events=None,
        sequential: bool = False,
    ):
        cfg = self.config
        prefill_table, decode_ids, row = self.tables()
        t0 = time.perf_counter()
        prefill_task = None
        fetch_gate = None
        written = 0
        if prefill and sequential:
            _, _, written = await stream_prefill(
                self.prefill_kv, self.params, cfg, prompt,
                self.fresh_caches(), prefill_table,
            )  # durable before the fetch starts
        elif prefill:
            # Announce-driven handoff: the prefill side signals each layer's
            # publication and the decode side's layer-l read waits for it.
            shipped = [asyncio.Event() for _ in range(cfg.n_layers)]
            prefill_task = asyncio.ensure_future(
                stream_prefill(
                    self.prefill_kv, self.params, cfg, prompt,
                    self.fresh_caches(), prefill_table,
                    on_layer_shipped=lambda layer: shipped[layer].set(),
                )
            )

            async def fetch_gate(layer, _ev=shipped):
                await _ev[layer].wait()
        res = await overlapped_decode(
            self.decode_kv, self.params, cfg, prompt, self.fresh_caches(),
            decode_ids, row, self.first_token, watermark=watermark,
            known_hit=len(decode_ids), retry_missing_s=retry_missing_s,
            fetch_gate=fetch_gate, gen_tokens=gen_tokens,
            trace_events=trace_events,
        )
        if prefill_task is not None:
            _, _, written = await prefill_task
        return {"ttft_s": res.t_first - t0, "result": res, "written": written}

    async def run_overlapped(
        self, prompt, *, watermark: int = 1, gen_tokens: int = 1,
        retry_missing_s: float = 10.0, prefill: bool = True, trace_events=None,
    ):
        return await self._handoff(
            prompt, watermark=watermark, gen_tokens=gen_tokens,
            retry_missing_s=retry_missing_s, prefill=prefill,
            trace_events=trace_events,
        )

    async def run_blocking(
        self, prompt, *, gen_tokens: int = 1, retry_missing_s: float = 10.0,
        prefill: bool = True, trace_events=None,
    ):
        return await self._handoff(
            prompt, watermark=self.config.n_layers, gen_tokens=gen_tokens,
            retry_missing_s=retry_missing_s, prefill=prefill,
            trace_events=trace_events,
        )

    async def run_cold(self, prompt, *, gen_tokens: int = 1):
        return await self._handoff(
            prompt, watermark=self.config.n_layers, gen_tokens=gen_tokens,
            retry_missing_s=0.0, sequential=True,
        )

    async def run_proc(
        self, proc: "PrefillProcess", prompt_seed: int, *,
        watermark: int = 1, gen_tokens: int = 1, cold: bool = False,
        retry_missing_s: float = 10.0,
    ):
        """One handoff round against a prefill process (prefill compute
        genuinely parallel with the decode side's fetch and install). TTFT
        is measured from the ``go`` send. ``cold=True`` is the
        store-and-forward leg: wait for the producer's ``done`` before
        fetching at all."""
        prompt = demo_prompt(self.config, self.req_blocks, seed=prompt_seed)
        _, decode_ids, row = self.tables()
        rnd = proc.start_round(prompt_seed)
        t0 = time.perf_counter()
        await proc.go(prompt_seed)
        if cold:
            await rnd.done
            res = await overlapped_decode(
                self.decode_kv, self.params, self.config, prompt,
                self.fresh_caches(), decode_ids, row, self.first_token,
                watermark=self.config.n_layers, known_hit=len(decode_ids),
                retry_missing_s=0.0, gen_tokens=gen_tokens,
            )
        else:
            async def gate(layer, _r=rnd):
                await _r.shipped[layer].wait()

            res = await overlapped_decode(
                self.decode_kv, self.params, self.config, prompt,
                self.fresh_caches(), decode_ids, row, self.first_token,
                watermark=watermark, known_hit=len(decode_ids),
                retry_missing_s=retry_missing_s, fetch_gate=gate,
                gen_tokens=gen_tokens,
            )
            await rnd.done
        return {"ttft_s": res.t_first - t0, "result": res, "written": rnd.written}

    async def run_local(self, prompt, *, gen_tokens: int = 1):
        _, decode_ids, row = self.tables()
        t0 = time.perf_counter()
        res = await local_decode(
            self.params, self.config, prompt, self.fresh_caches(),
            decode_ids, row, self.first_token, gen_tokens=gen_tokens,
        )
        return {"ttft_s": res.t_first - t0, "result": res, "written": 0}

    def check_bytes(self, got: DecodeResult, oracle: DecodeResult) -> bool:
        """Bitwise first-token check against the local-recompute oracle; a
        mismatch is wrong bytes (counted, must stay 0)."""
        ok = bool(np.array_equal(got.first_logits, oracle.first_logits))
        if not ok:
            counters().bump("disagg_wrong_bytes")
        return ok


# -- the prefill role in its own process -------------------------------------


def prefill_argv(
    port: int,
    *,
    serve: bool = False,
    blocks: int = 4,
    n_layers: int = 6,
    block_tokens: int = 8,
    dim: int = 64,
    ffn_dim: int = 128,
    pace_ms: float = 0.0,
    seed: int = 0,
    prompt_seed: int = 0,
    stall_after_layer: Optional[int] = None,
    stall_s: float = 0.0,
    crash_after_layers: Optional[int] = None,
    trace_id: Optional[int] = None,
    device: str = "cuda",
) -> List[str]:
    """argv of a prefill-engine process (``python -m
    infinistore_tpu_torch.disagg``); :meth:`PrefillProcess.spawn` and tests
    that spawn the role use it, so every caller records the argv it ran."""
    argv = [
        sys.executable, "-m", "infinistore_tpu_torch.disagg",
        "--port", str(port), "--role", "prefill",
        "--blocks", str(blocks), "--n-layers", str(n_layers),
        "--block-tokens", str(block_tokens),
        "--dim", str(dim), "--ffn-dim", str(ffn_dim),
        "--pace-ms", str(pace_ms),
        "--seed", str(seed), "--prompt-seed", str(prompt_seed),
        "--device", str(device),
    ]
    if serve:
        argv.append("--serve")
    if stall_after_layer is not None:
        argv += ["--stall-after-layer", str(stall_after_layer), "--stall-s", str(stall_s)]
    if crash_after_layers is not None:
        argv += ["--crash-after-layers", str(crash_after_layers)]
    if trace_id is not None:
        argv += ["--trace-id", str(trace_id)]
    return argv


@dataclasses.dataclass
class _PrefillRound:
    """One ``go`` round's announce state: per-layer publication events (the
    decode side's ``fetch_gate`` awaits them) and the done future."""

    shipped: List[asyncio.Event]
    done: asyncio.Future
    written: int = 0


class PrefillProcess:
    """The prefill engine as a separate OS process, driven over a line
    protocol:

      stdin:  ``go <prompt_seed>``  prefill and stream that prompt's KV
              ``quit``              exit
      stdout: ``ready``             model up, store connected
              ``shipped <seed> <layer>``  that layer's puts are durable (the
              announce channel the decode side's fetch gate consumes)
              ``done <seed> <written>``   all layers durable

    The decode process's layer-``l`` read launches when ``shipped l``
    arrives, never before. Spawn with :meth:`spawn`."""

    def __init__(self, proc, n_layers: int):
        self.proc = proc
        self.n_layers = n_layers
        self._rounds: dict = {}
        self._reader: Optional[asyncio.Task] = None

    @classmethod
    async def spawn(
        cls, port: int, *, blocks: int = 4, n_layers: int = 6,
        block_tokens: int = 8, dim: int = 64, ffn_dim: int = 128,
        pace_ms: float = 0.0, seed: int = 0, ready_timeout_s: float = 180.0,
        device: str = "cuda",
    ) -> "PrefillProcess":
        argv = prefill_argv(
            port, serve=True, blocks=blocks, n_layers=n_layers,
            block_tokens=block_tokens, dim=dim, ffn_dim=ffn_dim,
            pace_ms=pace_ms, seed=seed, device=device,
        )
        proc = await asyncio.create_subprocess_exec(
            *argv, stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE
        )
        self = cls(proc, n_layers)

        async def until_ready():
            while True:
                line = await proc.stdout.readline()
                if not line:
                    raise RuntimeError("prefill process exited before ready")
                if line.decode().strip() == "ready":
                    return

        try:
            await asyncio.wait_for(until_ready(), ready_timeout_s)
        except BaseException:
            proc.kill()
            await proc.wait()
            raise
        self._reader = asyncio.ensure_future(self._read_loop())
        return self

    def start_round(self, prompt_seed: int) -> _PrefillRound:
        r = _PrefillRound(
            shipped=[asyncio.Event() for _ in range(self.n_layers)],
            done=asyncio.get_running_loop().create_future(),
        )
        self._rounds[prompt_seed] = r
        return r

    async def go(self, prompt_seed: int) -> None:
        self.proc.stdin.write(f"go {prompt_seed}\n".encode())
        await self.proc.stdin.drain()

    async def _read_loop(self) -> None:
        while True:
            line = await self.proc.stdout.readline()
            if not line:
                return
            parts = line.decode().split()
            if parts[:1] == ["shipped"] and len(parts) == 3:
                r = self._rounds.get(int(parts[1]))
                if r is not None:
                    r.shipped[int(parts[2])].set()
            elif parts[:1] == ["done"] and len(parts) == 3:
                r = self._rounds.get(int(parts[1]))
                if r is not None and not r.done.done():
                    r.written = int(parts[2])
                    r.done.set_result(r.written)

    async def close(self) -> None:
        if self._reader is not None:
            self._reader.cancel()
        try:
            self.proc.stdin.write(b"quit\n")
            await self.proc.stdin.drain()
            await asyncio.wait_for(self.proc.wait(), 10.0)
        except Exception:
            self.proc.kill()
            await self.proc.wait()


def _main(argv=None) -> int:
    """``python -m infinistore_tpu_torch.disagg``: the prefill engine as its
    own OS process. One-shot, it prints ``shipped layer N`` as each layer's
    puts become durable and ``prefill done wrote=...`` at the end; with
    ``--serve`` it speaks :class:`PrefillProcess`'s line protocol.
    ``--device`` defaults to ``cuda``; ``--device cpu`` runs the kernels'
    plain versions."""
    ap = argparse.ArgumentParser(prog="python -m infinistore_tpu_torch.disagg")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--role", choices=["prefill"], default="prefill")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-seed", type=int, default=0)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--n-layers", type=int, default=6)
    ap.add_argument("--block-tokens", type=int, default=8)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--ffn-dim", type=int, default=128)
    ap.add_argument("--pace-ms", type=float, default=0.0)
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--stall-after-layer", type=int, default=None)
    ap.add_argument("--stall-s", type=float, default=0.0)
    ap.add_argument("--crash-after-layers", type=int, default=None)
    ap.add_argument("--trace-id", type=int, default=None)
    args = ap.parse_args(argv)

    from .config import ClientConfig
    from .lib import InfinityConnection

    device = _ext.resolve_device(args.device)
    cfg = demo_config(
        n_layers=args.n_layers, block_tokens=args.block_tokens,
        dim=args.dim, ffn_dim=args.ffn_dim,
    )
    params = _demo_params(cfg, args.seed, device)
    conn = InfinityConnection(
        ClientConfig(host_addr="127.0.0.1", service_port=args.port, log_level="error")
    )
    conn.connect()
    kv = KVConnector(
        conn, cfg.kv_spec(args.blocks), "disagg-demo", max_blocks=args.blocks,
        device=device,
    )
    table = np.arange(args.blocks, dtype=np.int32)

    async def run_one(pr, on_layer_shipped) -> int:
        span = None
        if args.trace_id is not None:
            # Cross-process trace continuation: the decode side's installs
            # and this side's ships share one trace id.
            span = tracing.Span("disagg.prefill", trace_id=args.trace_id)
        with tracing.use_span(span):
            _, _, written = await stream_prefill(
                kv, params, cfg, pr, cfg.kv_spec(args.blocks).make_caches(device),
                table,
                on_layer_shipped=on_layer_shipped,
                stall_after_layer=args.stall_after_layer,
                stall_s=args.stall_s,
                crash_after_layers=args.crash_after_layers,
                pace_s=args.pace_ms / 1e3,
            )
        if span is not None:
            span.finish("ok")
        return written

    try:
        if args.serve:
            async def serve() -> None:
                loop = asyncio.get_running_loop()
                print("ready", flush=True)
                while True:
                    line = await loop.run_in_executor(None, sys.stdin.readline)
                    parts = line.split()
                    if not line or parts[:1] == ["quit"]:
                        return
                    if parts[:1] != ["go"] or len(parts) != 2:
                        continue
                    seed = int(parts[1])
                    written = await run_one(
                        demo_prompt(cfg, args.blocks, seed=seed),
                        lambda layer, s=seed: print(f"shipped {s} {layer}", flush=True),
                    )
                    print(f"done {seed} {written}", flush=True)

            asyncio.run(serve())
        else:
            written = asyncio.run(run_one(
                demo_prompt(cfg, args.blocks, seed=args.prompt_seed),
                lambda layer: print(f"shipped layer {layer}", flush=True),
            ))
            print(f"prefill done wrote={written}", flush=True)
    finally:
        kv.close()
        conn.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
