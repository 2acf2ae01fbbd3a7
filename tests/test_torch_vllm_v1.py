"""The port's vLLM v1 connector (``infinistore_tpu_torch.vllm_v1``) on the CPU.

- The 14 contract tests of ``tests/test_vllm_v1.py``, on torch tensors and
  the port's ``KVConnector`` / ``ClusterKVConnector``: the published call
  order (scheduler probe -> alloc -> metadata build; worker bind ->
  start_load_kv -> per-layer wait/save -> wait_for_save -> clear), the
  sentinel committing last, chunked prefill's saved-block watermark, the
  hook-less load whose returned list is installed, and
  ``KVLoadUnderDelivery`` without the partial-delivery opt-in.
- Interop both ways: a prefix saved through one package's v1 connector
  loads byte for byte through the other's, on the same numpy bytes.
- Layer readiness: ``wait_for_layer_load`` consumes the event each layer's
  hook recorded (a fake event on the CPU), and only that layer's.
- A CPU rehearsal of ``chip_smoke.py``'s ``vllm_v1`` path at a small f32
  width, bitwise against engine A's own continuation.

The vLLM objects (Request, NewRequestData, CachedRequestData,
SchedulerOutput), duck-typed stand-ins carrying exactly the attributes the
connector reads, and the runner's call order are ``chip_smoke.py``'s, so
the card's path and these tests drive the connector the same way.
"""

import os
import sys
from typing import List

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import infinistore_tpu as its
import infinistore_tpu_torch as itt
from infinistore_tpu import vllm_v1 as jv1
from infinistore_tpu.connector import KVConnector as JaxKVConnector
from infinistore_tpu.tpu.paged import PagedKVCacheSpec as JaxSpec
from infinistore_tpu_torch import config as tconfig
from infinistore_tpu_torch import lib as tlib
from infinistore_tpu_torch import vllm_v1
from infinistore_tpu_torch.connector import KVConnector, token_chain_hashes
from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec
from infinistore_tpu_torch.vllm_v1 import (
    InfiniStoreConnectorMetadata,
    InfiniStoreKVConnectorV1,
    KVConnectorRole,
    KVLoadUnderDelivery,
    _LoadSpec,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the vLLM stand-ins and the runner step)

GEOM = (3, 16, 4, 2, 8)  # layers, blocks, block_tokens, kv_heads, head_dim
SPEC = PagedKVCacheSpec(*GEOM, torch.float32)
JSPEC = JaxSpec(*GEOM, jnp.float32)
MAX_BLOCKS = 4
LAYERS = [f"model.layers.{i}.self_attn" for i in range(SPEC.num_layers)]


# -- vLLM's objects and the runner's call order: chip_smoke.py's stand-ins ---

Request = chip_smoke.V1Request
NewRequestData = chip_smoke.V1NewRequestData
CachedRequestData = chip_smoke.V1CachedRequestData
SchedulerOutput = chip_smoke.V1SchedulerOutput


# -- fixtures ---------------------------------------------------------------


@pytest.fixture(scope="module")
def server():
    srv = tlib.start_local_server(
        prealloc_bytes=64 << 20, block_bytes=64 << 10, enable_shm=True
    )
    yield srv
    srv.stop()


def _connect(server):
    c = tlib.InfinityConnection(
        tconfig.ClientConfig(
            host_addr="127.0.0.1", service_port=server.port, log_level="error"
        )
    )
    c.connect()
    return c


def _vllm_config(kv, **extra):
    """Duck-typed vllm_config: kv_transfer_config.kv_connector_extra_config."""

    class KTC:
        kv_connector_extra_config = {"kv_connector": kv, **extra}

    class Cfg:
        kv_transfer_config = KTC()

    return Cfg()


def _connector(server, model_id: str, role: KVConnectorRole, **extra):
    conn = _connect(server)
    kv = KVConnector(conn, SPEC, model_id, max_blocks=MAX_BLOCKS, device="cpu")
    c = InfiniStoreKVConnectorV1(_vllm_config(kv, **extra), role)
    return c, conn


def _close(*connectors):
    for c in connectors:
        c.close()
        c.kv.close()
        c.kv.conn.close()


def _block_bytes(layer: int, kind: int, chain_i: int, seed: int = 0) -> np.ndarray:
    """Deterministic content for one logical block."""
    rng = np.random.default_rng(1000 * seed + 100 * layer + 10 * kind + chain_i)
    return rng.standard_normal(
        (SPEC.block_tokens, SPEC.num_kv_heads, SPEC.head_dim)
    ).astype(np.float32)


def _filled_numpy(phys_of_logical: List[int], n_logical: int, seed: int = 0):
    """Per-layer numpy (K, V) with logical block i's bytes at physical block
    phys_of_logical[i]; everything else zero."""
    out = []
    for layer in range(SPEC.num_layers):
        k = np.zeros(SPEC.cache_shape, np.float32)
        v = np.zeros_like(k)
        for i in range(n_logical):
            k[phys_of_logical[i]] = _block_bytes(layer, 0, i, seed)
            v[phys_of_logical[i]] = _block_bytes(layer, 1, i, seed)
        out.append((k, v))
    return out


def _filled_caches(phys_of_logical: List[int], n_logical: int, seed: int = 0):
    return [tuple(torch.from_numpy(a) for a in kv)
            for kv in _filled_numpy(phys_of_logical, n_logical, seed)]


def _zero_caches():
    return {name: SPEC.make_caches(device="cpu")[0] for name in LAYERS}


def _worker_step(connector, meta, caches_dict, *, layers=LAYERS, save=True):
    """Register ``caches_dict`` and run one runner step in the published
    order (``chip_smoke.v1_runner_step``). Returns the post-step per-layer
    caches."""
    connector.register_kv_caches(caches_dict)
    chip_smoke.v1_runner_step(connector, meta, layers, save=save)
    return {name: connector.kv_cache(name) for name in layers}


def _produce(server, model_id, prompt, phys, seed=0):
    """Run a full producer step (miss -> compute -> layer-wise save) and
    return (scheduler, worker) connectors still open."""
    sched, _s = _connector(server, model_id, KVConnectorRole.SCHEDULER)
    worker, _w = _connector(server, model_id, KVConnectorRole.WORKER)
    n_blocks = len(prompt) // SPEC.block_tokens
    req = Request("r-prod", prompt)
    external, is_async = sched.get_num_new_matched_tokens(req, 0)
    assert external == 0 and is_async is False
    sched.update_state_after_alloc(req, [phys], 0)
    meta = sched.build_connector_meta(
        SchedulerOutput([NewRequestData("r-prod", prompt, [phys])])
    )
    assert len(meta.saves) == 1 and len(meta.loads) == 0
    assert meta.saves[0].first_block == 0
    caches = _filled_caches(phys, n_blocks, seed)
    _worker_step(worker, meta, dict(zip(LAYERS, caches)))
    return sched, worker


def _probe(server, model_id):
    conn = _connect(server)
    return KVConnector(conn, SPEC, model_id, max_blocks=MAX_BLOCKS, device="cpu"), conn


# -- the 14 contract tests of tests/test_vllm_v1.py -------------------------


def test_published_call_order_roundtrip(server):
    """Producer saves via the layer-wise worker path; a consumer's
    scheduler probe sees the hit, its worker loads layer by layer, and
    every byte matches the producer's blocks."""
    prompt = list(range(14))  # 3 complete blocks + a 2-token tail
    sched_p, worker_p = _produce(server, "v1-rt", prompt, [2, 5, 7], seed=1)

    sched_c, _ = _connector(server, "v1-rt", KVConnectorRole.SCHEDULER)
    worker_c, _ = _connector(server, "v1-rt", KVConnectorRole.WORKER)
    req = Request("r-cons", prompt)
    external, _ = sched_c.get_num_new_matched_tokens(req, 0)
    assert external == 12, "store hit not reported to the scheduler"
    phys_cons = [[9, 3, 11]]
    sched_c.update_state_after_alloc(req, phys_cons, external)
    meta = sched_c.build_connector_meta(
        SchedulerOutput([NewRequestData("r-cons", prompt, phys_cons)])
    )
    assert len(meta.loads) == 1 and len(meta.saves) == 0, (
        "a full hit must not re-save the prefix"
    )
    zero = _zero_caches()
    out = _worker_step(worker_c, meta, zero, save=False)
    assert worker_c.loaded_tokens("r-cons") == 12
    for layer, name in enumerate(LAYERS):
        k, v = out[name]
        # In place: the registered tensors hold the loaded bytes.
        assert k is zero[name][0] and v is zero[name][1]
        for i, pb in enumerate(phys_cons[0]):
            np.testing.assert_array_equal(k[pb].numpy(), _block_bytes(layer, 0, i, seed=1))
            np.testing.assert_array_equal(v[pb].numpy(), _block_bytes(layer, 1, i, seed=1))
    _close(sched_p, worker_p, sched_c, worker_c)


def test_bytes_correct_immediately_after_each_layer_wait(server):
    """wait_for_layer_load(L) must deliver L's bytes BEFORE later layers
    are waited on — the layer-streaming contract the runner relies on to
    overlap network with per-layer compute."""
    prompt = list(range(10))  # 2 complete blocks + tail
    sched_p, worker_p = _produce(server, "v1-layerwise", prompt, [1, 4], seed=2)

    sched_c, _ = _connector(server, "v1-layerwise", KVConnectorRole.SCHEDULER)
    worker_c, _ = _connector(server, "v1-layerwise", KVConnectorRole.WORKER)
    req = Request("rc", prompt)
    external, _ = sched_c.get_num_new_matched_tokens(req, 0)
    assert external == 8
    sched_c.update_state_after_alloc(req, [[6, 2]], external)
    meta = sched_c.build_connector_meta(
        SchedulerOutput([NewRequestData("rc", prompt, [[6, 2]])])
    )
    worker_c.register_kv_caches(_zero_caches())
    worker_c.bind_connector_metadata(meta)
    worker_c.start_load_kv(forward_context=None)
    for layer, name in enumerate(LAYERS):
        worker_c.wait_for_layer_load(name)
        # Check THIS layer's bytes before any later wait.
        k, v = worker_c.kv_cache(name)
        for i, pb in enumerate([6, 2]):
            np.testing.assert_array_equal(k[pb].numpy(), _block_bytes(layer, 0, i, seed=2))
            np.testing.assert_array_equal(v[pb].numpy(), _block_bytes(layer, 1, i, seed=2))
    worker_c.wait_for_save()
    worker_c.clear_connector_metadata()
    # request_finished: saves completed within the step, so the engine may
    # free blocks immediately and no transfer params ride the response.
    assert sched_c.request_finished(req, [[6, 2]]) == (False, None)
    # get_finished: nothing is ever deferred across steps.
    assert worker_c.get_finished(set()) == (None, None)
    _close(sched_p, worker_p, sched_c, worker_c)


def test_sentinel_commits_last(server):
    """Layer 0's keys are the whole-block presence sentinel: after every
    save_kv_layer call but BEFORE wait_for_save, deeper layers are durable
    while the sentinel is absent — a concurrent lookup must see a miss,
    never a half-saved hit."""
    prompt = list(range(8))
    sched, _ = _connector(server, "v1-sentinel", KVConnectorRole.SCHEDULER)
    worker, _ = _connector(server, "v1-sentinel", KVConnectorRole.WORKER)
    probe_kv, probe = _probe(server, "v1-sentinel")

    req = Request("rs", prompt)
    assert sched.get_num_new_matched_tokens(req, 0)[0] == 0
    sched.update_state_after_alloc(req, [[0, 1]], 0)
    meta = sched.build_connector_meta(
        SchedulerOutput([NewRequestData("rs", prompt, [[0, 1]])])
    )
    caches = _filled_caches([0, 1], 2, seed=3)
    worker.register_kv_caches(dict(zip(LAYERS, caches)))
    worker.bind_connector_metadata(meta)
    worker.start_load_kv(forward_context=None)
    for name in LAYERS:
        worker.wait_for_layer_load(name)
        worker.save_kv_layer(name, None, attn_metadata=None)
    # Drain the non-sentinel (layer >= 1) saves deterministically.
    for f in list(worker._save_futures):
        f.result()
    # Deeper layers durable, sentinel absent -> lookup is a MISS.
    chain0 = token_chain_hashes(prompt, SPEC.block_tokens)[0]
    assert probe.check_exist(worker.kv.block_key(1, "k", chain0)), (
        "layer-1 save did not commit"
    )
    assert probe_kv.lookup(prompt) == 0, (
        "half-saved block visible as a hit before wait_for_save"
    )
    worker.wait_for_save()
    assert probe_kv.lookup(prompt) == 2, "sentinel missing after wait_for_save"
    worker.clear_connector_metadata()
    _close(sched, worker)
    probe_kv.close()
    probe.close()


def test_local_prefix_skips_load_and_save(server):
    """The engine's own prefix cache already computed block 0: the
    connector must promise only the EXTRA tokens, load only blocks [1, 3)
    into their physical slots, and (store hit == prompt) save nothing."""
    prompt = list(range(14))  # tail keeps the >=1-token-to-compute cap out of play
    sched_p, worker_p = _produce(server, "v1-local", prompt, [0, 1, 2], seed=4)

    sched, _ = _connector(server, "v1-local", KVConnectorRole.SCHEDULER)
    worker, _ = _connector(server, "v1-local", KVConnectorRole.WORKER)
    req = Request("rl", prompt)
    external, _ = sched.get_num_new_matched_tokens(req, num_computed_tokens=4)
    assert external == 8, "must not promise tokens the engine already has"
    phys = [[8, 9, 10]]
    sched.update_state_after_alloc(req, phys, external)
    meta = sched.build_connector_meta(
        SchedulerOutput([NewRequestData("rl", prompt, phys, num_computed_tokens=4)])
    )
    assert len(meta.loads) == 1 and meta.loads[0].first_block == 1
    assert list(meta.loads[0].block_ids) == [9, 10]
    assert len(meta.saves) == 0
    out = _worker_step(worker, meta, _zero_caches(), save=False)
    assert worker.loaded_tokens("rl") == 8
    for layer, name in enumerate(LAYERS):
        k, _v = out[name]
        # physical 8 (locally computed block 0's slot) untouched; 9/10 hold
        # logical blocks 1/2.
        assert not k[8].any()
        np.testing.assert_array_equal(k[9].numpy(), _block_bytes(layer, 0, 1, seed=4))
        np.testing.assert_array_equal(k[10].numpy(), _block_bytes(layer, 0, 2, seed=4))
    _close(sched_p, worker_p, sched, worker)


def test_local_compute_beyond_store_hit_saves_the_difference(server):
    """Store holds 1 block; the engine locally computed 2. No load (store
    has nothing new), and the save must cover [store_hit, prompt) so the
    store learns the locally-computed blocks."""
    short = list(range(4))
    sched_p, worker_p = _produce(server, "v1-diff", short, [3], seed=5)

    prompt = short + list(range(100, 108))  # 3 blocks, store has block 0
    sched, _ = _connector(server, "v1-diff", KVConnectorRole.SCHEDULER)
    worker, _ = _connector(server, "v1-diff", KVConnectorRole.WORKER)
    req = Request("rd", prompt)
    external, _ = sched.get_num_new_matched_tokens(req, num_computed_tokens=8)
    assert external == 0
    sched.update_state_after_alloc(req, [[4, 5, 6]], 0)
    meta = sched.build_connector_meta(
        SchedulerOutput([NewRequestData("rd", prompt, [[4, 5, 6]], 8)])
    )
    assert len(meta.loads) == 0
    assert len(meta.saves) == 1
    assert meta.saves[0].first_block == 1
    assert list(meta.saves[0].block_ids) == [5, 6]
    caches = _filled_caches([4, 5, 6], 3, seed=6)
    _worker_step(worker, meta, dict(zip(LAYERS, caches)))
    probe_kv, probe = _probe(server, "v1-diff")
    assert probe_kv.lookup(prompt) == 3, "store never learned the local blocks"
    probe_kv.close()
    probe.close()
    _close(sched_p, worker_p, sched, worker)


def test_full_aligned_hit_holds_back_one_block(server):
    """A block-aligned prompt fully cached in the store: the promise must
    leave >= 1 token for the engine to compute (vLLM's scheduler requires
    a non-empty local step), so one whole block is held back — and no save
    is built (the store already holds the held-back block)."""
    prompt = list(range(12))  # exactly 3 blocks, all cached
    sched_p, worker_p = _produce(server, "v1-cap", prompt, [0, 1, 2], seed=8)

    sched, _ = _connector(server, "v1-cap", KVConnectorRole.SCHEDULER)
    req = Request("rc", prompt)
    external, _ = sched.get_num_new_matched_tokens(req, 0)
    assert external == 8, "full-prompt promise would leave 0 tokens to compute"
    sched.update_state_after_alloc(req, [[4, 5, 6]], external)
    meta = sched.build_connector_meta(
        SchedulerOutput([NewRequestData("rc", prompt, [[4, 5, 6]])])
    )
    assert len(meta.loads) == 1
    assert meta.loads[0].first_block == 0
    assert list(meta.loads[0].block_ids) == [4, 5]
    assert len(meta.saves) == 0, "the held-back block is already stored"
    _close(sched_p, worker_p, sched)


def test_chunked_prefill_saves_only_scheduled_blocks(server):
    """vLLM chunks long prefills: with num_scheduled_tokens bounding the
    step, only blocks COMPLETE by end of step may be saved — committing an
    unscheduled block would publish garbage under a valid chain key."""
    prompt = list(range(200, 212))  # 3 blocks, cold
    sched, _ = _connector(server, "v1-chunk", KVConnectorRole.SCHEDULER)
    worker, _ = _connector(server, "v1-chunk", KVConnectorRole.WORKER)
    req = Request("rk", prompt)
    assert sched.get_num_new_matched_tokens(req, 0)[0] == 0
    sched.update_state_after_alloc(req, [[0, 1, 2]], 0)
    out = SchedulerOutput([NewRequestData("rk", prompt, [[0, 1, 2]])])
    out.num_scheduled_tokens = {"rk": 4}  # step computes 1 block of 3
    meta = sched.build_connector_meta(out)
    assert len(meta.saves) == 1
    assert meta.saves[0].first_block == 0
    assert list(meta.saves[0].block_ids) == [0], (
        "saved blocks the step never computed"
    )
    caches = _filled_caches([0, 1, 2], 3, seed=9)
    _worker_step(worker, meta, dict(zip(LAYERS, caches)))
    probe_kv, probe = _probe(server, "v1-chunk")
    assert probe_kv.lookup(prompt) == 1, "exactly the scheduled block is visible"
    probe_kv.close()
    probe.close()
    _close(sched, worker)


def test_call_order_is_enforced(server):
    """Worker entry points before bind_connector_metadata fail loudly (the
    runner contract), and an unknown layer name is a KeyError."""
    worker, _ = _connector(server, "v1-order", KVConnectorRole.WORKER)
    worker.register_kv_caches(_zero_caches())
    with pytest.raises(RuntimeError, match="bind_connector_metadata"):
        worker.start_load_kv(forward_context=None)
    with pytest.raises(RuntimeError, match="bind_connector_metadata"):
        worker.save_kv_layer(LAYERS[0], None, attn_metadata=None)
    worker.bind_connector_metadata(InfiniStoreConnectorMetadata())
    worker.start_load_kv(forward_context=None)
    with pytest.raises(KeyError):
        worker.wait_for_layer_load("no.such.layer")
    _close(worker)


def test_v1_composes_with_cluster_pool(server):
    """The duck-typed connector gate: the port's ClusterKVConnector drops
    into the vLLM v1 surface unchanged — layer-wise saves route to the
    prefix owner, a second engine's probe + load find them."""
    from infinistore_tpu_torch.cluster import ClusterKVConnector

    srv2 = tlib.start_local_server(
        prealloc_bytes=16 << 20, block_bytes=64 << 10, enable_shm=True
    )
    conns, clusters = [], []
    try:
        def mk_cluster():
            cs = [_connect(server), _connect(srv2)]
            conns.extend(cs)
            clusters.append(ClusterKVConnector(cs, SPEC, "v1-cluster", MAX_BLOCKS,
                                               device="cpu"))
            return clusters[-1]

        prompt = list(range(300, 310))  # 2 complete blocks + tail
        sched_p = InfiniStoreKVConnectorV1(
            _vllm_config(mk_cluster()), KVConnectorRole.SCHEDULER
        )
        worker_p = InfiniStoreKVConnectorV1(
            _vllm_config(mk_cluster()), KVConnectorRole.WORKER
        )
        req = Request("rp", prompt)
        assert sched_p.get_num_new_matched_tokens(req, 0)[0] == 0
        sched_p.update_state_after_alloc(req, [[0, 1]], 0)
        meta = sched_p.build_connector_meta(
            SchedulerOutput([NewRequestData("rp", prompt, [[0, 1]])])
        )
        caches = _filled_caches([0, 1], 2, seed=11)
        _worker_step(worker_p, meta, dict(zip(LAYERS, caches)))

        sched_c = InfiniStoreKVConnectorV1(
            _vllm_config(mk_cluster()), KVConnectorRole.SCHEDULER
        )
        worker_c = InfiniStoreKVConnectorV1(
            _vllm_config(mk_cluster()), KVConnectorRole.WORKER
        )
        req2 = Request("rq", prompt)
        external, _ = sched_c.get_num_new_matched_tokens(req2, 0)
        assert external == 8, "cluster routing lost the saved prefix"
        sched_c.update_state_after_alloc(req2, [[7, 8]], external)
        meta2 = sched_c.build_connector_meta(
            SchedulerOutput([NewRequestData("rq", prompt, [[7, 8]])])
        )
        out = _worker_step(worker_c, meta2, _zero_caches(), save=False)
        assert worker_c.loaded_tokens("rq") == 8
        for layer, name in enumerate(LAYERS):
            k, _v = out[name]
            for i, pb in enumerate([7, 8]):
                np.testing.assert_array_equal(k[pb].numpy(), _block_bytes(layer, 0, i, seed=11))
        for c in (worker_p, worker_c):
            c.close()
    finally:
        for cluster in clusters:
            cluster.close()
        for c in conns:
            c.close()
        srv2.stop()


def test_raced_eviction_degrades_to_recompute(server):
    """Keys deleted between the scheduler's probe and the worker's load,
    with the engine OPTED INTO the loaded_tokens() recompute protocol: the
    load must settle every layer wait and report loaded_tokens == 0 —
    cache semantics (the engine recomputes), never a hang or stale bytes."""
    prompt = list(range(10))
    sched_p, worker_p = _produce(server, "v1-race", prompt, [0, 1], seed=7)

    sched, _ = _connector(server, "v1-race", KVConnectorRole.SCHEDULER)
    worker, _ = _connector(
        server, "v1-race", KVConnectorRole.WORKER, allow_partial_delivery=True
    )
    req = Request("rr", prompt)
    external, _ = sched.get_num_new_matched_tokens(req, 0)
    assert external == 8
    sched.update_state_after_alloc(req, [[2, 3]], external)
    meta = sched.build_connector_meta(
        SchedulerOutput([NewRequestData("rr", prompt, [[2, 3]])])
    )
    # Race: drop the blocks before the worker loads.
    assert worker_p.kv.drop(prompt) > 0
    out = _worker_step(worker, meta, _zero_caches(), save=False)
    assert worker.loaded_tokens("rr") == 0
    for name in LAYERS:
        k, v = out[name]
        assert not k.any() and not v.any()
    _close(sched_p, worker_p, sched, worker)


def test_under_delivery_raises_without_opt_in(server):
    """WITHOUT the loaded_tokens() opt-in, a load delivering less than the
    scheduler was promised must fail the step loudly — stock vLLM already
    counted the promise as computed and would silently attend over
    zero-filled blocks."""
    prompt = list(range(10))
    sched_p, worker_p = _produce(server, "v1-strict", prompt, [0, 1], seed=12)

    sched, _ = _connector(server, "v1-strict", KVConnectorRole.SCHEDULER)
    worker, _ = _connector(server, "v1-strict", KVConnectorRole.WORKER)
    req = Request("ru", prompt)
    external, _ = sched.get_num_new_matched_tokens(req, 0)
    assert external == 8
    sched.update_state_after_alloc(req, [[2, 3]], external)
    meta = sched.build_connector_meta(
        SchedulerOutput([NewRequestData("ru", prompt, [[2, 3]])])
    )
    assert worker_p.kv.drop(prompt) > 0  # the race
    worker.register_kv_caches(_zero_caches())
    worker.bind_connector_metadata(meta)
    worker.start_load_kv(forward_context=None)
    with pytest.raises(RuntimeError) as ei:
        for name in LAYERS:
            worker.wait_for_layer_load(name)
        worker.wait_for_save()
    assert isinstance(
        ei.value if isinstance(ei.value, KVLoadUnderDelivery) else ei.value.__cause__,
        KVLoadUnderDelivery,
    )
    worker.clear_connector_metadata()
    _close(sched_p, worker_p, sched, worker)


def test_chunked_prefill_resumed_chunks_are_saved(server):
    """A long prompt chunked over several steps: chunks after the first
    arrive via scheduled_cached_reqs (no prompt data). The per-request
    saved-block watermark must carry across steps so EVERY computed block
    reaches the store — and be cleared at request_finished."""
    prompt = list(range(400, 412))  # 3 blocks, cold
    sched, _ = _connector(server, "v1-resume", KVConnectorRole.SCHEDULER)
    worker, _ = _connector(server, "v1-resume", KVConnectorRole.WORKER)
    req = Request("rz", prompt)
    assert sched.get_num_new_matched_tokens(req, 0)[0] == 0
    sched.update_state_after_alloc(req, [[0, 1, 2]], 0)
    # Step 1: the new request computes 1 of 3 blocks.
    out1 = SchedulerOutput([NewRequestData("rz", prompt, [[0, 1, 2]])])
    out1.num_scheduled_tokens = {"rz": 4}
    meta1 = sched.build_connector_meta(out1)
    assert [list(s.block_ids) for s in meta1.saves] == [[0]]
    caches = _filled_caches([0, 1, 2], 3, seed=13)
    _worker_step(worker, meta1, dict(zip(LAYERS, caches)))
    # Step 2: the SAME request resumes via scheduled_cached_reqs — 8 more
    # tokens complete blocks 1 and 2.
    out2 = SchedulerOutput([])
    out2.scheduled_cached_reqs = [CachedRequestData("rz", [[]], 4)]
    out2.num_scheduled_tokens = {"rz": 8}
    meta2 = sched.build_connector_meta(out2)
    assert len(meta2.loads) == 0
    assert len(meta2.saves) == 1
    assert meta2.saves[0].first_block == 1
    assert list(meta2.saves[0].block_ids) == [1, 2]
    _worker_step(worker, meta2, dict(zip(LAYERS, caches)))
    probe_kv, probe = _probe(server, "v1-resume")
    assert probe_kv.lookup(prompt) == 3, "resumed chunks never reached the store"
    probe_kv.close()
    probe.close()
    # request_finished clears the watermark (no unbounded growth, and a
    # reused request id starts fresh).
    assert sched.request_finished(req, [[0, 1, 2]]) == (False, None)
    assert "rz" not in sched._save_watermark
    # A third step for the (finished) request emits nothing.
    out3 = SchedulerOutput([])
    out3.scheduled_cached_reqs = [CachedRequestData("rz", [[]], 12)]
    meta3 = sched.build_connector_meta(out3)
    assert meta3.saves == []
    _close(sched, worker)


def test_preemption_resume_replaces_block_list(server):
    """resumed_from_preemption=True means the old physical blocks were
    freed and new_block_ids is the FULL replacement list: the tracker must
    REPLACE, not append. The saved-block watermark survives."""
    prompt = list(range(500, 512))  # 3 blocks, cold
    sched, _ = _connector(server, "v1-preempt", KVConnectorRole.SCHEDULER)
    req = Request("rp2", prompt)
    assert sched.get_num_new_matched_tokens(req, 0)[0] == 0
    sched.update_state_after_alloc(req, [[0, 1, 2]], 0)
    out1 = SchedulerOutput([NewRequestData("rp2", prompt, [[0, 1, 2]])])
    out1.num_scheduled_tokens = {"rp2": 4}  # step 1 computes block 0
    meta1 = sched.build_connector_meta(out1)
    assert [list(s.block_ids) for s in meta1.saves] == [[0]]
    # Preempted; resumed later with a completely new physical placement.
    out2 = SchedulerOutput([])
    out2.scheduled_cached_reqs = [
        CachedRequestData("rp2", [[5, 6, 7]], 4, resumed_from_preemption=True)
    ]
    out2.num_scheduled_tokens = {"rp2": 8}  # completes blocks 1 and 2
    meta2 = sched.build_connector_meta(out2)
    assert len(meta2.saves) == 1
    assert meta2.saves[0].first_block == 1
    assert list(meta2.saves[0].block_ids) == [6, 7], (
        "resume must save from the REPLACEMENT block list, not the stale one"
    )
    sched.request_finished(req, [[5, 6, 7]])
    _close(sched)


def test_hookless_donating_load_installs_returned_caches(server):
    """A connector whose load returns a NEW per-layer list but fires no
    on_layer hooks (the quantized connector's scales-race miss returns
    zipped new tuples and 0): the worker must install the returned list,
    so kv_cache names what the load left."""

    class ReturningKV:
        """KVConnector-shaped; load hands back new tensors for every layer,
        fires no hooks, reports 0 loaded. No start_fetch: exercises the
        one-phase branch the miss path takes."""

        spec = SPEC

        def lookup(self, token_ids):
            return 2

        async def load(self, token_ids, caches, block_ids, first_block=0,
                       on_layer=None):
            replaced = [(k + 1.0, v + 1.0) for k, v in caches]
            return replaced, 0

        def stage_layer_save(self, *a, **kw):
            async def noop():
                return 0

            return noop

    worker = InfiniStoreKVConnectorV1(
        _vllm_config(ReturningKV(), allow_partial_delivery=True), KVConnectorRole.WORKER
    )
    zero = _zero_caches()
    originals = dict(zero)
    worker.register_kv_caches(zero)
    meta = InfiniStoreConnectorMetadata(
        loads=[
            _LoadSpec(
                req_id="dq",
                token_ids=list(range(8)),
                block_ids=np.array([1, 2], np.int32),
                num_tokens=8,
                first_block=0,
            )
        ]
    )
    worker.bind_connector_metadata(meta)
    worker.start_load_kv(forward_context=None)
    for name in LAYERS:
        worker.wait_for_layer_load(name)
        k, v = worker.kv_cache(name)
        # The returned replacements (all ones) were installed, not the
        # originals.
        assert k is not originals[name][0]
        assert float(k[0, 0, 0, 0]) == 1.0
    worker.wait_for_save()
    assert worker.loaded_tokens("dq") == 0
    worker.clear_connector_metadata()
    worker.close()


# -- interop with the JAX package's connector --------------------------------


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_prefix_saved_by_one_package_loads_in_the_other(server, saver):
    """A prefix saved through one package's v1 worker (layer-wise, sentinel
    last) is found by the other package's scheduler probe and loaded by its
    worker byte for byte, on the same numpy bytes."""
    model_id = f"v1-interop-{saver}"
    prompt = list(range(600, 614))  # 3 complete blocks + a 2-token tail
    phys_prod, phys_cons = [2, 5, 7], [9, 3, 11]
    filled = _filled_numpy(phys_prod, 3, seed=21)

    def cfg_jax():
        conn = its.InfinityConnection(its.ClientConfig(
            host_addr="127.0.0.1", service_port=server.port, log_level="error"))
        conn.connect()
        kv = JaxKVConnector(conn, JSPEC, model_id, max_blocks=MAX_BLOCKS)
        return kv, conn

    def cfg_torch():
        conn = _connect(server)
        return KVConnector(conn, SPEC, model_id, max_blocks=MAX_BLOCKS, device="cpu"), conn

    pkgs = {
        "jax": (jv1, cfg_jax, lambda a: jnp.asarray(a), lambda t: np.asarray(t)),
        "torch": (vllm_v1, cfg_torch, torch.from_numpy, lambda t: t.numpy()),
    }
    loader = "torch" if saver == "jax" else "jax"
    opened = []

    def v1(pkg, role):
        mod, mk, _, _ = pkgs[pkg]
        kv, conn = mk()
        opened.append((kv, conn))
        return mod.InfiniStoreKVConnectorV1(_vllm_config(kv), getattr(mod.KVConnectorRole, role))

    try:
        mod, _, to_dev, to_np = pkgs[saver]
        sched, worker = v1(saver, "SCHEDULER"), v1(saver, "WORKER")
        assert sched.get_num_new_matched_tokens(Request("p", prompt), 0)[0] == 0
        sched.update_state_after_alloc(Request("p", prompt), [phys_prod], 0)
        meta = sched.build_connector_meta(
            SchedulerOutput([NewRequestData("p", prompt, [phys_prod])]))
        caches = {name: tuple(to_dev(a) for a in filled[i]) for i, name in enumerate(LAYERS)}
        _worker_step(worker, meta, caches)
        worker.close()

        mod, _, to_dev, to_np = pkgs[loader]
        sched, worker = v1(loader, "SCHEDULER"), v1(loader, "WORKER")
        external, _ = sched.get_num_new_matched_tokens(Request("c", prompt), 0)
        assert external == 12, "the other package's save is not a hit"
        sched.update_state_after_alloc(Request("c", prompt), [phys_cons], external)
        meta = sched.build_connector_meta(
            SchedulerOutput([NewRequestData("c", prompt, [phys_cons])]))
        zeros = np.zeros(SPEC.cache_shape, np.float32)
        out = _worker_step(worker, meta,
                           {name: (to_dev(zeros.copy()), to_dev(zeros.copy())) for name in LAYERS},
                           save=False)
        assert worker.loaded_tokens("c") == 12
        for layer, name in enumerate(LAYERS):
            for kind in (0, 1):
                got = to_np(out[name][kind])[phys_cons]
                want = filled[layer][kind][phys_prod]
                assert got.tobytes() == want.tobytes(), (layer, kind)
        worker.close()
    finally:
        for kv, conn in opened:
            close = getattr(kv, "close", None)
            if close is not None:
                close()
            conn.close()


# -- layer readiness on the card ---------------------------------------------


class _FakeEvent:
    """Stands in for a CUDA event: remembers the layer it was recorded for
    and whether a stream was made to wait on it."""

    def __init__(self, log, tag):
        self.log, self.tag = log, tag

    def wait(self, stream=None):
        self.log.append(("wait", self.tag))


def test_wait_for_layer_load_consumes_the_layers_scatter_event(server):
    """Each layer's hook records the layer's readiness (an event on the
    stream that holds its scatter, here a fake), and wait_for_layer_load(L)
    makes the caller's stream wait on L's events and on no other layer's;
    wait_for_save consumes nothing twice."""
    prompt = list(range(700, 710))  # 2 complete blocks + tail
    sched_p, worker_p = _produce(server, "v1-ready", prompt, [1, 4], seed=22)
    sched, _ = _connector(server, "v1-ready", KVConnectorRole.SCHEDULER)
    worker, _ = _connector(server, "v1-ready", KVConnectorRole.WORKER)
    req = Request("re", prompt)
    external, _ = sched.get_num_new_matched_tokens(req, 0)
    sched.update_state_after_alloc(req, [[6, 2]], external)
    meta = sched.build_connector_meta(SchedulerOutput([NewRequestData("re", prompt, [[6, 2]])]))

    log, recorded = [], []

    def readiness_event():
        event = _FakeEvent(log, len(recorded))
        recorded.append(event)
        return event

    worker._readiness_event = readiness_event
    worker.register_kv_caches(_zero_caches())
    worker.bind_connector_metadata(meta)
    worker.start_load_kv(forward_context=None)
    for layer, name in enumerate(LAYERS):
        worker.wait_for_layer_load(name)
        # The hook of layer L recorded event L; this wait consumed exactly it.
        assert log == [("wait", i) for i in range(layer + 1)], log
    worker.wait_for_save()
    worker.clear_connector_metadata()
    assert len(recorded) == len(LAYERS)
    assert log == [("wait", i) for i in range(len(LAYERS))]
    assert worker.loaded_tokens("re") == 8
    _close(sched_p, worker_p, sched, worker)


def test_hookless_load_readiness_is_consumed_at_the_layer_waits():
    """A load that fires no hook still leaves its scatters' readiness for
    every layer (one event after the load returned), which each layer's
    wait consumes."""

    class HooklessKV:
        spec = SPEC

        def lookup(self, token_ids):
            return 2

        async def load(self, token_ids, caches, block_ids, first_block=0, on_layer=None):
            return list(caches), 2

        def stage_layer_save(self, *a, **kw):
            raise AssertionError("no save in this step")

    worker = InfiniStoreKVConnectorV1(_vllm_config(HooklessKV()), KVConnectorRole.WORKER)
    log = []
    worker._readiness_event = lambda: _FakeEvent(log, "after-load")
    worker.register_kv_caches(_zero_caches())
    worker.bind_connector_metadata(InfiniStoreConnectorMetadata(loads=[_LoadSpec(
        req_id="h", token_ids=list(range(8)), block_ids=np.array([1, 2], np.int32),
        num_tokens=8, first_block=0)]))
    worker.start_load_kv(forward_context=None)
    for name in LAYERS:
        worker.wait_for_layer_load(name)
    assert log == [("wait", "after-load")] * len(LAYERS)
    worker.wait_for_save()
    assert len(log) == len(LAYERS)
    worker.close()


def test_lazy_names_resolve_to_the_v1_module():
    for name in ("InfiniStoreKVConnectorV1", "KVConnectorRole", "KVConnectorMetadata",
                 "KVLoadUnderDelivery"):
        assert getattr(itt, name) is getattr(vllm_v1, name)


# -- chip_smoke.py's vllm_v1 path, rehearsed at a small width ----------------


def test_chip_smoke_vllm_v1_path_rehearsal_on_cpu():
    """``chip_smoke._run_vllm_v1`` at a small f32 width on the CPU (2
    layers, head_dim 64, block 8): engine A's chunked prefill saved and
    looked up whole, engine B's four prefix loads byte-equal, the sentinel
    committing last, B's suffix and decode logits bitwise engine A's own
    continuation."""
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab=96, dim=128, n_layers=2, n_heads=2, n_kv_heads=1,
                            ffn_dim=256, block_tokens=8, dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    srv = tlib.start_local_server(prealloc_bytes=64 << 20, block_bytes=4 << 10)
    try:
        summary, launches = chip_smoke._run_vllm_v1(
            torch, srv.port, params, cfg, "cpu", prompt_tokens=64, chunk_tokens=32,
            suffix_tokens=8, decode_steps=4)
    finally:
        srv.stop()
    assert summary["prompts"] == chip_smoke.PROMPTS
    assert summary["lookup_after_chunks"] == [8] * chip_smoke.PROMPTS
    assert summary["promised_tokens"] == [64] * chip_smoke.PROMPTS
    assert summary["lookup_before_wait_for_save"] == [8]
    assert summary["lookup_after_wait_for_save"] == [9]
    assert summary["time_to_first_decode_logits_s"] > 0
    assert summary["loaded_tokens"] == [64] * chip_smoke.PROMPTS
    assert len(summary["steps"]) == 3
    assert set(launches) >= {"gather_blocks", "scatter_blocks"}
