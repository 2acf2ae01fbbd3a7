"""The CUDA graph path of the port's decode waves (``engine.WaveDecoder``,
"CUDA graphs") on the CPU. A stand-in takes the place of the capture
(``WaveDecoder.capture``): it runs the wave's call once as its recording,
and its graph's ``replay`` runs that call again on whatever the static
inputs then hold, writing the same output tensor. So the engine's side of
the mechanism is held without a card: the canonical bucket, the counters
and the span's ``graph`` attr, the recapture after the cache or the
parameters are replaced, the launch counts, the rows served as copies, the
workspace a graph keeps, and the eager path of a CPU harness. The card's
own capture and replay are held in ``tests/test_torch_cuda_wave_graph.py``.
"""

import asyncio
import gc
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from infinistore_tpu_torch import engine, tracing
from infinistore_tpu_torch.cuda import _ext
from infinistore_tpu_torch.engine import ContinuousBatchingHarness
from infinistore_tpu_torch.models import llama as tl

CFG = tl.LlamaConfig(vocab=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
                     block_tokens=8, dtype=torch.float32)
NUM_BLOCKS = 32
MRB = 4  # max_req_blocks
WAVE_TOL = 1e-5  # a wave against the same rows launched otherwise, f32
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def params():
    return tl.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


class _Graph:
    def __init__(self, run, out):
        self.run, self.out, self.replays = run, out, 0

    def replay(self):
        counted = dict(_ext.LAUNCHES)
        self.out.copy_(self.run())
        _ext.LAUNCHES.update(counted)  # the engine counts a replay's launches
        self.replays += 1


class StandIn:
    """``capture(run, stream, pool)`` on the CPU. ``workspace``: (floats,
    tickets) of split workspace the captured "kernels" take, as a decode
    kernel's wrapper does while it is captured. ``fail``: raise instead."""

    def __init__(self, workspace=None, fail=False):
        self.workspace, self.fail, self.calls = workspace, fail, 0

    def __call__(self, run, stream, pool):
        self.calls += 1
        if self.fail:
            raise RuntimeError("capture refused")
        if self.workspace:
            _ext.split_workspace(CPU, 0, *self.workspace)
        out = run()
        return _Graph(run, out), out


def _harness(params, capture=True, **kw):
    h = ContinuousBatchingHarness(SimpleNamespace(), params, CFG, NUM_BLOCKS, MRB,
                                  device="cpu", **kw)
    g = torch.Generator().manual_seed(1)
    for k, v in h.caches:  # some context to attend
        k.copy_(torch.randn(k.shape, generator=g))
        v.copy_(torch.randn(v.shape, generator=g))
    if capture:
        h.wave.capture = StandIn()
    return h


def _chunks(rows, seed):
    """``rows`` flat rows as up to four requests' chunks (request i on
    blocks 4i..4i+3): tokens, positions, padded table."""
    rng = np.random.default_rng(seed)
    n_req = min(rows, 4)
    sizes = [rows // n_req + (i < rows % n_req) for i in range(n_req)]
    out = []
    for i, n in enumerate(sizes):
        start = int(rng.integers(0, MRB * CFG.block_tokens - n))
        out.append((rng.integers(0, CFG.vocab, n).tolist(), list(range(start, start + n)),
                    np.arange(4 * i, 4 * i + 4, dtype=np.int32)))
    return out


def _wave(h, rows, seed=0):
    """One wave of ``rows`` flat rows; returns each request's logits rows."""

    async def go():
        return await asyncio.gather(*(h.wave.step_chunk(t, p, tab)
                                      for t, p, tab in _chunks(rows, seed)))

    waves = h.wave.waves
    out = asyncio.run(go())
    assert h.wave.waves == waves + 1, "the chunks did not coalesce into one wave"
    return out


def _kinds(h):
    m = h.metrics()
    return m["wave_graph_captures"], m["wave_graph_replays"], m["wave_eager"]


@pytest.mark.parametrize("policy", [False, True], ids=["policy_off", "policy_on"])
def test_graph_waves_launch_on_the_canonical_bucket(params, policy):
    h = _harness(params, wave_skew_policy=policy, wave_hold_max_s=0.0,
                 wave_defer_pad_frac=1.0)
    for rows in (1, 2, 3, 5, 5):
        _wave(h, rows)
    assert h.wave.bucket_sizes == {(t, t, t * MRB) for t in (1, 2, 4, 8)}


def test_each_kind_of_wave_is_counted_and_traced(params, monkeypatch):
    """The first wave at a rung captures, the next replays; a wave above
    the top rung runs eagerly. Each is counted and named on its span."""
    monkeypatch.setattr(engine, "GRAPH_MAX_ROWS", 2)
    h = _harness(params)
    rec = tracing.configure(enabled=True, capacity=1 << 12, slow_op_us=0)
    rec.clear()
    try:
        for rows in (1, 1, 2, 2, 2, 3):
            _wave(h, rows)
    finally:
        tracing.configure(enabled=False)
    assert _kinds(h) == (2, 3, 1)
    waves = [s for s in rec.snapshot() if s["name"] == "model.wave"]
    assert [w["attrs"]["graph"] for w in waves] == [
        "capture", "replay", "capture", "replay", "replay", "eager"]
    assert [w["attrs"]["t_bucket"] for w in waves] == [1, 1, 2, 2, 2, 4]
    assert h.wave.capture.calls == 2


@pytest.mark.parametrize("rows", [1, 3, 6])
def test_a_replayed_wave_serves_what_the_eager_wave_does(params, rows):
    """Replayed (the rung's second wave) against the same wave run eagerly
    on a harness without graphs: logits and caches within the tolerance a
    wave keeps against the same rows launched otherwise."""
    graphed, eager = _harness(params), _harness(params, capture=False)
    _wave(graphed, rows, seed=1)
    _wave(eager, rows, seed=1)
    got, want = _wave(graphed, rows, seed=2), _wave(eager, rows, seed=2)
    assert _kinds(graphed) == (1, 1, 0) and _kinds(eager) == (0, 0, 2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=WAVE_TOL, atol=WAVE_TOL)
    for (gk, gv), (ek, ev) in zip(graphed.caches, eager.caches):
        torch.testing.assert_close(gk, ek, rtol=WAVE_TOL, atol=WAVE_TOL)
        torch.testing.assert_close(gv, ev, rtol=WAVE_TOL, atol=WAVE_TOL)


@pytest.mark.parametrize("replace", ["caches", "params"])
def test_replaced_tensors_force_a_counted_recapture(params, replace):
    h = _harness(params)
    _wave(h, 2)
    _wave(h, 2)
    assert _kinds(h) == (1, 1, 0)
    if replace == "caches":
        h.caches = [(k.clone(), v.clone()) for k, v in h.caches]
    else:
        h.params = {n: t.clone() for n, t in h.params.items()}
    _wave(h, 2)
    assert _kinds(h) == (2, 1, 0)
    _wave(h, 2)
    assert _kinds(h) == (2, 2, 0)
    assert list(h.wave._graphs) == [2]
    assert h.wave._graph_identity == engine._wave_identity(h.params, h.caches)


def test_a_replay_adds_its_captured_launches(params, monkeypatch):
    """A capture counts no launch; each replay adds what the capture's call
    counted, so the per-kernel counters read as if every wave launched."""
    real = engine.verify_step_ragged

    def counting(*args):
        _ext.LAUNCHES["paged_decode_attention_ragged"] += CFG.n_layers
        return real(*args)

    monkeypatch.setattr(engine, "verify_step_ragged", counting)
    # The counter is process-wide: restored at teardown for later tests.
    monkeypatch.setitem(_ext.LAUNCHES, "paged_decode_attention_ragged", 0)
    h = _harness(params)
    for _ in range(3):
        _wave(h, 2)
    assert _kinds(h) == (1, 2, 0)
    assert _ext.LAUNCHES["paged_decode_attention_ragged"] == 3 * CFG.n_layers
    (graph,) = h.wave._graphs.values()
    assert graph.launches == {"paged_decode_attention_ragged": CFG.n_layers}


def test_served_rows_are_copies(params):
    """A later replay of the rung rewrites the graph's output; the rows an
    earlier wave served stay as they were."""
    h = _harness(params)
    _wave(h, 2, seed=1)
    served = _wave(h, 2, seed=2)
    kept = [r.clone() for r in served]
    later = _wave(h, 2, seed=3)
    (graph,) = h.wave._graphs.values()
    assert graph.graph.replays == 2
    for r, k, l in zip(served, kept, later):
        assert torch.equal(r, k)
        assert not torch.equal(r, l)
        assert r.untyped_storage().data_ptr() != graph.logits.untyped_storage().data_ptr()


def test_a_graph_keeps_its_workspace_after_it_grows(params):
    h = _harness(params)
    h.wave.capture = StandIn(workspace=(64, 64))
    try:
        _wave(h, 1)
        (graph,) = h.wave._graphs.values()
        scratch, tickets = _ext.split_workspace(CPU, 0, 0, 0)
        assert any(t is scratch for t in graph.keep) and any(t is tickets for t in graph.keep)
        gone = weakref.ref(scratch), weakref.ref(tickets)
        del scratch, tickets
        grown = _ext.split_workspace(CPU, 0, 1 << 16, 1 << 16)
        gc.collect()
        assert all(r() is not None for r in gone), "the captured workspace was freed"
        assert all(r() is not g for r, g in zip(gone, grown))
        _wave(h, 1)
        assert _kinds(h) == (1, 1, 0)
    finally:
        _ext._WORKSPACE.pop((CPU, 0), None)


def test_a_failed_capture_raises_to_its_waiters(params):
    h = _harness(params)
    h.wave.capture = StandIn(fail=True)
    with pytest.raises(RuntimeError, match="capture refused"):
        _wave(h, 2)
    assert h.wave._graphs == {} and _kinds(h) == (0, 0, 0)


def test_a_cpu_harness_never_leaves_the_eager_path(params):
    h = _harness(params, capture=False)
    assert h.wave.capture is None
    for rows in (1, 1, 2, 4, 4):
        _wave(h, rows)
    assert _kinds(h) == (0, 0, 5) and h.wave._graphs == {}
