"""One run of one cell: build the system under test, drive the cell's traffic
through it, record the window, free the program, check its answers.

The system under test is the port's serving path:
``ContinuousBatchingHarness`` (engine, device gate, ragged decode waves) over
``EngineKVAdapter`` over ``KVConnector`` (layerwise reads and writes, host
staging) over an in-process store server on loopback TCP
(``lib.start_local_server`` with shared memory off, so the data path is the
socket, the same as across hosts), with the model configuration and weights
of the cell's architecture (``arch/``). The engine runs with its defaults: no
verification oracle, no drafter, the skew policy off.

The benchmark's own spans (no change to the program):

- ``TimedAdapter``, an ``EngineKVAdapter`` whose saves and loads are timed
  around the call into the connector;
- each turn's decode steps: the engine's ``WaveDecoder.step_chunk`` is
  wrapped on the instance so that, when a step returns, the benchmark waits
  for the wave on the device (as the engine's next line does when it reads
  the token) and stamps the row's position and the time on the turn.
"""

import asyncio
import contextvars
import gc
import math
import subprocess
import threading
import time
from types import SimpleNamespace
from typing import List, Optional

import torch

from . import check, records, spec
from . import trace as trace_mod
from .weights import DTYPES

# --trace 1 profiles the last seconds of the window.
TRACE_SPAN_S = 6.0

_TURN = contextvars.ContextVar("h100bench_turn", default=None)

def _timed_adapter(connector, block_bytes: int, block_tokens: int):
    from infinistore_tpu_torch.engine import EngineKVAdapter

    class TimedAdapter(EngineKVAdapter):
        """Records (start, end, bytes) of every save and load."""

        def __init__(self):
            super().__init__(connector)
            self.saves: List[tuple] = []
            self.loads: List[tuple] = []

        async def save_kv(self, token_ids, caches, block_table, first_block=0):
            t0 = time.perf_counter()
            nbytes = sum(k.nbytes + v.nbytes for k, v in caches)
            out = await super().save_kv(token_ids, caches, block_table, first_block=first_block)
            self.saves.append((t0, time.perf_counter(), nbytes))
            return out

        async def install_kv(self, prefetch, caches, block_table):
            t0 = time.perf_counter()
            out, tokens = await super().install_kv(prefetch, caches, block_table)
            self.loads.append((t0, time.perf_counter(), tokens // block_tokens * block_bytes))
            return out, tokens

        async def load_kv(self, token_ids, caches, block_table):
            t0 = time.perf_counter()
            out, tokens = await super().load_kv(token_ids, caches, block_table)
            self.loads.append((t0, time.perf_counter(), tokens // block_tokens * block_bytes))
            return out, tokens

    return TimedAdapter()


def _stamp_steps(harness, sync) -> None:
    """Stamp each decode step's rows on the turn that awaited it."""
    wave = harness.wave
    step_chunk = wave.step_chunk

    async def stamped(tokens, positions, padded_table, priority=0):
        rows = await step_chunk(tokens, positions, padded_table, priority=priority)
        sync()
        turn = _TURN.get()
        if turn is not None:
            now = time.perf_counter()
            turn.steps.extend(records.Step(int(p), now) for p in positions)
        return rows

    wave.step_chunk = stamped


def _build(device: torch.device) -> None:
    """The kernels (nvcc) while the store library builds (g++), each into
    ``infinistore_tpu_torch/_build/`` of this checkout; a warm checkout
    loads both."""
    errors = []

    def kernels():
        from infinistore_tpu_torch.cuda import _ext

        try:
            _ext.kernels()
        except BaseException as exc:  # re-raised below
            errors.append(exc)

    worker = threading.Thread(target=kernels) if device.type == "cuda" else None
    if worker is not None:
        worker.start()
    from infinistore_tpu_torch import lib  # noqa: F401  (builds the store library)

    if worker is not None:
        worker.join()
    if errors:
        raise errors[0]


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class System:
    """The program, set up for one cell: store server, client, connector,
    adapter, harness, on ``device``; the model configuration, the weights and
    the work counts come from ``arch``, the configuration's module."""

    def __init__(self, arch, cfg: dict, traffic, seed: int, device: torch.device,
                 model_id: str):
        from infinistore_tpu_torch import lib
        from infinistore_tpu_torch.config import ClientConfig
        from infinistore_tpu_torch.connector import KVConnector
        from infinistore_tpu_torch.engine import ContinuousBatchingHarness

        self.shapes = arch.shapes(cfg)
        self.config = arch.program(cfg, device)
        bt = self.shapes.block_tokens
        self.req_blocks = math.ceil(cfg["max_context"] / bt)
        num_blocks = traffic.in_flight * self.req_blocks
        # The pool holds twice the live sessions' KV at the cap, so that LRU
        # eviction removes only finished sessions.
        unit = cfg["store_unit_bytes"]
        pool = 2 * num_blocks * self.shapes.block_bytes()
        pool = -(-pool // unit) * unit
        self.params = arch.params(cfg, seed, device, DTYPES[cfg["torch_dtype"]])
        self.server = lib.start_local_server(prealloc_bytes=pool, block_bytes=unit,
                                             pin_memory=False, enable_shm=False)
        self.conn = lib.InfinityConnection(ClientConfig(
            host_addr="127.0.0.1", service_port=self.server.port, log_level="error",
            enable_shm=False))
        self.conn.connect()
        self.kv = KVConnector(self.conn, self.config.kv_spec(num_blocks), model_id,
                              max_blocks=self.req_blocks, device=device)
        self.adapter = _timed_adapter(self.kv, self.shapes.block_bytes(), bt)
        self.harness = ContinuousBatchingHarness(
            self.adapter, self.params, self.config, num_blocks, self.req_blocks, verify=False,
            device=device)
        if device.type == "cuda":
            sync = torch.cuda.current_stream(device).synchronize
        else:
            sync = lambda: None  # noqa: E731
        _stamp_steps(self.harness, sync)

    def close(self) -> None:
        """Free the program's state: cache, weights, staging, the store."""
        self.harness = self.params = None
        self.kv.close()
        self.conn.close()
        self.server.stop()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


async def drive(harness, traffic, seconds: float, dtrace=None) -> SimpleNamespace:
    """Warm up on the traffic itself until ``traffic.warmup_turns`` turns are
    done, then measure ``seconds``; the turns in flight at the close finish.
    With ``dtrace``, the last ``TRACE_SPAN_S`` of the window are profiled."""
    state = SimpleNamespace(done=0, start=None, end=None, turns=[])
    opened = asyncio.Event()

    def keep_going() -> bool:
        return state.end is None or time.perf_counter() < state.end

    async def send(prompt, gen):
        turn = records.Turn(prompt=list(prompt), gen=gen, t_send=time.perf_counter())
        state.turns.append(turn)
        _TURN.set(turn)
        try:
            stats = await harness.run_request(turn.prompt, gen_tokens=gen)
        except Exception as exc:  # a failed turn is counted, its session ends
            turn.error = f"{type(exc).__name__}: {exc}"
            stats = None
        turn.t_return = time.perf_counter()
        if stats is not None:
            turn.stats = stats
            turn.generated = list(stats.generated or [])
        state.done += 1
        if state.start is None and state.done >= traffic.warmup_turns:
            state.start = turn.t_return
            state.end = state.start + seconds
            opened.set()
        return turn.generated

    async def profile():
        await opened.wait()
        await asyncio.sleep(max(0.0, state.end - min(TRACE_SPAN_S, seconds) - time.perf_counter()))
        dtrace.start()
        await asyncio.sleep(max(0.0, state.end - time.perf_counter()))
        dtrace.stop()

    jobs = [traffic.drive(send, keep_going)]
    if dtrace is not None:
        jobs.append(profile())
    await asyncio.gather(*jobs)
    return state


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
        process_start: Optional[float] = None) -> dict:
    """One run. Returns the result's parts: the Run record, the device's
    readings, the check, and the counts."""
    device = torch.device(device)
    t_process = process_start if process_start is not None else time.perf_counter()
    cfg = cell.config
    phases = {"start": t_process}
    _build(device)
    phases["built"] = time.perf_counter()
    traffic = cell.traffic(seed)
    system = System(cell.arch, cfg, traffic, seed, device, f"{cell.name}-{seed}")
    phases["system"] = time.perf_counter()
    dtrace = None
    if trace:
        dtrace = trace_mod.DeviceTrace(torch)
        dtrace.warm()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    state = asyncio.run(drive(system.harness, traffic, seconds, dtrace))
    phases["window"], phases["closed"], phases["drained"] = state.start, state.end, time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run_ = records.Run(
        shapes=system.shapes, start=state.start, end=state.end, turns=state.turns,
        saves=system.adapter.saves, loads=system.adapter.loads,
        setup_s=state.start - t_process)
    if dtrace is not None:
        spans = _host_spans(run_)
        run_.trace = trace_mod.reduce(dtrace.events(), dtrace.t0, dtrace.t1, spans)
        run_.trace_span = (dtrace.t0, dtrace.t1)
        dtrace = None
    system.close()
    del system
    phases["freed"] = time.perf_counter()
    gap, compared = _check(cell, seed, run_, device)
    phases["checked"] = time.perf_counter()
    names = list(phases)
    timeline = " ".join(f"{b} {phases[b] - phases[a]:.2f}s" for a, b in zip(names, names[1:]))
    return {"run": run_, "memory_peak_bytes": peak, "max_logit_gap": gap,
            "tokens_compared": compared, "timeline": timeline,
            "trace_events": run_.trace.events if run_.trace is not None else None}


def _host_spans(run_: records.Run) -> List[tuple]:
    """What the host was doing, from the benchmark's own records: (kind,
    start, end) of saves, loads, admissions (send to the prompt resident)
    and the waits for decode steps."""
    spans = [("save", a, b) for a, b, _ in run_.saves]
    spans += [("load", a, b) for a, b, _ in run_.loads]
    for t in run_.turns:
        if not t.ok:
            continue
        ready = run_.prefix_ready(t)
        spans.append(("admission", t.t_send, ready))
        prev = ready
        for s in t.steps:
            spans.append(("decode_step", prev, s.t))
            prev = s.t
    return spans


def served_turns(run_: records.Run) -> List[check.Served]:
    """The turns the window's metrics cover that the program finished."""
    return [check.Served(t.prompt, t.generated) for t in run_.first_token_in_window()
            if t.generated]


def reference(cell: spec.Cell, seed: int, device, quant=None):
    """The cell's plain reference, its weights remade in the type they are
    served in."""
    cfg = cell.config
    return cell.arch.reference(cfg, seed, device, DTYPES[cfg["torch_dtype"]], quant)


def _check(cell: spec.Cell, seed: int, run_: records.Run, device):
    sample = check.sample(served_turns(run_), seed)
    if not sample:
        return None, 0
    g = check.gaps(reference(cell, seed, device), sample)
    return float(g.max()), int(g.size)
