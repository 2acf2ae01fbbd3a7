"""The port's two-phase load (infinistore_tpu_torch: ``KVConnector.start_fetch``
-> ``LayerwisePrefetch.install``, ``FetchCoalescer``, the staging pool's
reservations) under the tests the JAX package's passes
(tests/test_prefetch.py, connector half), on the CPU over the port's own
loopback store. Bytes must land exactly (bitwise). Plus interop: a prefix
the JAX ``KVConnector`` saved is fetched and installed by the port's
``start_fetch``, byte-identical."""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import infinistore_tpu as its
from infinistore_tpu.connector import KVConnector as JaxKVConnector
from infinistore_tpu.tpu.paged import PagedKVCacheSpec as JaxSpec
from infinistore_tpu_torch import config as tconfig
from infinistore_tpu_torch import lib as tlib
from infinistore_tpu_torch.connector import KVConnector
from infinistore_tpu_torch.cuda.layerwise import PrefetchDiscarded
from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec
from infinistore_tpu_torch.cuda.staging import HostStagingPool, StagingPoolExhausted

GEOM = (3, 16, 8, 2, 32)  # layers, blocks, block_tokens, kv_heads, head_dim
SPEC = PagedKVCacheSpec(*GEOM, torch.float32)


@pytest.fixture()
def server():
    srv = tlib.start_local_server(prealloc_bytes=64 << 20, block_bytes=64 << 10,
                                  enable_shm=True)
    yield srv
    srv.stop()


@pytest.fixture()
def conn(server):
    c = tlib.InfinityConnection(tconfig.ClientConfig(
        host_addr="127.0.0.1", service_port=server.port, log_level="error"))
    c.connect()
    yield c
    c.close()


def _rand_caches(seed):
    rng = np.random.default_rng(seed)
    return [tuple(torch.from_numpy(rng.standard_normal(SPEC.cache_shape).astype(np.float32))
                  for _ in range(2)) for _ in range(SPEC.num_layers)]


def _caches():
    return SPEC.make_caches(device="cpu")


def _kvc(conn, model_id):
    return KVConnector(conn, SPEC, model_id, max_blocks=8, device="cpu")


def _assert_blocks(out, caches, src, dst):
    for layer in range(GEOM[0]):
        for side in (0, 1):
            assert torch.equal(out[layer][side][dst.tolist()], caches[layer][side][src.tolist()])


async def _drain_pool(pool, timeout_s=3.0):
    for _ in range(int(timeout_s / 0.02)):
        if pool.slots_in_use == 0:
            return
        await asyncio.sleep(0.02)
    raise AssertionError(f"staging slots leaked: {pool.slots_in_use} in use")


# -- staging-pool reservation accounting -------------------------------------


def test_staging_pool_reserve_release_accounting():
    pool = HostStagingPool(16 * 1024, 1024, device="cpu")
    a = pool.reserve(6)
    b = pool.reserve(10)
    assert pool.slots_in_use == 16
    with pytest.raises(StagingPoolExhausted):
        pool.reserve(1)
    a.release()
    a.release()  # idempotent
    assert pool.slots_in_use == 10
    c = pool.reserve(6)
    b.release()
    c.release()
    assert pool.slots_in_use == 0
    with pytest.raises(ValueError):
        pool.reserve(0)


def test_staging_pool_reserve_needs_contiguity():
    pool = HostStagingPool(8 * 1024, 1024, device="cpu")
    holds = [pool.reserve(2) for _ in range(4)]
    holds[0].release()
    holds[2].release()
    with pytest.raises(StagingPoolExhausted):
        pool.reserve(3)  # 4 free, but split 2 + 2
    lease = pool.reserve(2)
    assert lease.num_slots == 2
    for h in holds[1::2] + [lease]:
        h.release()
    assert pool.slots_in_use == 0


# -- connector-level fetch/install -------------------------------------------


def test_start_fetch_install_roundtrips_bytes(conn):
    kvc = _kvc(conn, "pf-rt")
    caches = _rand_caches(1)
    toks = list(range(32))
    src = np.array([3, 7, 1, 9], np.int32)
    dst = np.array([8, 0, 14, 2], np.int32)

    async def drive():
        await kvc.save(toks, caches, src)
        h = kvc.start_fetch(toks)
        assert h.hit_blocks == 4 and h.n_blocks == 4
        await h.primed()
        out, n = await h.install(_caches(), dst)
        assert n == 4
        _assert_blocks(out, caches, src, dst)
        await _drain_pool(kvc._prefetch_pool)

    asyncio.run(drive())


def test_prefetch_wraps_regions_when_pool_is_shallow(conn):
    """Fewer regions than layers: a region refills only after install
    consumed its occupant, and the bytes still land exactly."""
    kvc = _kvc(conn, "pf-wrap")
    caches = _rand_caches(2)
    toks = list(range(32))
    src = np.array([2, 11, 5, 6], np.int32)
    dst = np.array([1, 4, 9, 13], np.int32)
    tiny = HostStagingPool(2 * 2 * 4 * SPEC.block_nbytes, SPEC.block_nbytes, conn=conn,
                           device="cpu")

    async def drive():
        await kvc.save(toks, caches, src)
        h = kvc.start_fetch(toks, prefetch_pool=tiny)
        assert h.regions == 2 < SPEC.num_layers
        out, loaded = await h.install(_caches(), dst)
        assert loaded == 4
        _assert_blocks(out, caches, src, dst)
        await _drain_pool(tiny)

    asyncio.run(drive())


def test_discard_returns_pool_to_baseline_and_counts_waste(conn):
    kvc = _kvc(conn, "pf-disc")
    toks = list(range(32))

    async def drive():
        await kvc.save(toks, _rand_caches(3), np.arange(4, dtype=np.int32))
        h = kvc.start_fetch(toks)
        await h.primed()
        await h.discard()
        assert kvc._prefetch_pool.slots_in_use == 0
        assert h.wasted_blocks == h.blocks_fetched > 0
        with pytest.raises(PrefetchDiscarded):
            await h.install(_caches(), np.arange(4, dtype=np.int32))
        h2 = kvc.start_fetch(toks)
        _, n = await h2.install(_caches(), np.arange(4, dtype=np.int32))
        assert n == 4
        await _drain_pool(kvc._prefetch_pool)

    asyncio.run(drive())


def test_raced_eviction_mid_fetch_reports_miss_and_releases(conn):
    kvc = _kvc(conn, "pf-race")
    toks = list(range(32))

    async def drive():
        await kvc.save(toks, _rand_caches(4), np.arange(4, dtype=np.int32))
        h = kvc.start_fetch(toks)  # lookup hits...
        kvc.drop(toks)  # ...but the blocks race away before the reads land
        _, n = await h.install(_caches(), np.arange(4, dtype=np.int32))
        assert n == 0, "raced-away blocks must read as a miss, never stale bytes"
        await _drain_pool(kvc._prefetch_pool)

    asyncio.run(drive())


def test_wave_of_fetches_coalesces_store_reads(conn):
    kvc = _kvc(conn, "pf-coal")
    caches = _rand_caches(5)
    toks_a, toks_b = list(range(32)), list(range(500, 532))

    async def drive():
        await kvc.save(toks_a, caches, np.arange(4, dtype=np.int32))
        await kvc.save(toks_b, caches, np.arange(4, 8, dtype=np.int32))
        ha = kvc.start_fetch(toks_a)
        hb = kvc.start_fetch(toks_b)
        _, na = await ha.install(_caches(), np.arange(4, dtype=np.int32))
        _, nb = await hb.install(_caches(), np.arange(4, dtype=np.int32))
        assert na == 4 and nb == 4
        co = kvc._coalescer
        assert co.submissions == 2 * SPEC.num_layers
        assert co.calls < co.submissions, "wave reads never coalesced"
        assert co.max_batch >= 2
        await _drain_pool(kvc._prefetch_pool)

    asyncio.run(drive())


def test_exhausted_arena_raises_not_hangs(conn):
    kvc = _kvc(conn, "pf-full")
    toks = list(range(32))
    tiny = HostStagingPool(SPEC.block_nbytes, SPEC.block_nbytes, conn=conn, device="cpu")

    async def drive():
        await kvc.save(toks, _rand_caches(6), np.arange(4, dtype=np.int32))
        with pytest.raises(StagingPoolExhausted) as err:
            kvc.start_fetch(toks, prefetch_pool=tiny)
        assert err.value.hit_blocks == 4  # the probe's answer rides the error

    asyncio.run(drive())


def test_start_fetch_async_and_promote(conn):
    """The executor-probe variant builds the same handle; promote() flips a
    background fetch's class for the reads not issued yet."""
    kvc = _kvc(conn, "pf-async")
    caches = _rand_caches(7)
    toks = list(range(64, 96))
    src = np.array([0, 5, 10, 15], np.int32)

    async def drive():
        await kvc.save(toks, caches, src)
        h = await kvc.start_fetch_async(toks, limit_blocks=3, priority=1)
        assert (h.hit_blocks, h.n_blocks) == (4, 3)
        h.promote()
        assert h._pri_cell["value"] == 0
        out, n = await h.install(_caches(), src[:3] + 1)
        assert n == 3
        _assert_blocks(out, caches, src[:3], src[:3] + 1)
        await _drain_pool(kvc._prefetch_pool)

    asyncio.run(drive())


def test_jax_saved_prefix_installs_through_port_start_fetch(server, conn):
    """A prefix saved by the JAX package's KVConnector is fetched and
    installed by the port's two-phase path, byte-identical."""
    tokens = list(range(100, 132))  # 4 blocks
    src = np.array([3, 7, 1, 9], np.int32)
    dst = np.array([0, 12, 5, 2], np.int32)
    rng = np.random.default_rng(9)
    base = [[rng.standard_normal(SPEC.cache_shape).astype(np.float32) for _ in range(2)]
            for _ in range(GEOM[0])]
    jconn = its.InfinityConnection(its.ClientConfig(
        host_addr="127.0.0.1", service_port=server.port, log_level="error"))
    jconn.connect()
    try:
        saver = JaxKVConnector(jconn, JaxSpec(*GEOM, jnp.float32), "interop-pf", 8)
        jcaches = [tuple(jnp.asarray(x) for x in pair) for pair in base]
        assert asyncio.run(saver.save(tokens, jcaches, src)) == 4 * 2 * GEOM[0]
    finally:
        jconn.close()
    kvc = _kvc(conn, "interop-pf")

    async def drive():
        h = await kvc.start_fetch_async(tokens)
        assert h.hit_blocks == 4
        out, n = await h.install(_caches(), dst)
        assert n == 4
        await _drain_pool(kvc._prefetch_pool)
        return out

    out = asyncio.run(drive())
    for layer in range(GEOM[0]):
        for kind in (0, 1):
            assert out[layer][kind][dst.tolist()].numpy().tobytes() == base[layer][kind][src].tobytes()
