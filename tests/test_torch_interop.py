"""Interop between the JAX package and its PyTorch port over one store.

The chain hashes, key strings and block bytes are the same in both, so a
prefix either package's ``KVConnector`` saved loads byte-identically through
the other's. Also pins the port's copy of the client library on its own
server: write/read round trip, longest-prefix match, typed miss."""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import infinistore_tpu as its
from infinistore_tpu.connector import KVConnector as JaxKVConnector
from infinistore_tpu.connector import token_chain_hashes as jax_chain_hashes
from infinistore_tpu.tpu.paged import PagedKVCacheSpec as JaxSpec
from infinistore_tpu_torch import config as tconfig
from infinistore_tpu_torch import lib as tlib
from infinistore_tpu_torch.connector import KVConnector, token_chain_hashes
from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec

GEOM = (2, 16, 8, 2, 32)  # layers, blocks, block_tokens, kv_heads, head_dim
JSPEC = JaxSpec(*GEOM, jnp.bfloat16)
TSPEC = PagedKVCacheSpec(*GEOM, torch.bfloat16)
MAX_BLOCKS = 4


@pytest.fixture()
def port_server():
    srv = tlib.start_local_server(
        prealloc_bytes=64 << 20, block_bytes=16 << 10, extend_bytes=64 << 20
    )
    yield srv
    srv.stop()


@pytest.fixture(params=["shm", "socket"])
def conns(port_server, request):
    """One store, one client of each package on the same data plane."""
    shm = request.param == "shm"
    tconn = tlib.InfinityConnection(tconfig.ClientConfig(
        host_addr="127.0.0.1", service_port=port_server.port, log_level="error",
        enable_shm=shm,
    ))
    jconn = its.InfinityConnection(its.ClientConfig(
        host_addr="127.0.0.1", service_port=port_server.port, log_level="error",
        enable_shm=shm,
    ))
    tconn.connect()
    jconn.connect()
    yield jconn, tconn
    jconn.close()
    tconn.close()


def _random_bf16_caches(seed):
    """Per-layer (K, V) with the same bf16 bits as a jax list and a torch list."""
    rng = np.random.default_rng(seed)
    jax_caches, torch_caches = [], []
    for _ in range(GEOM[0]):
        pair_j, pair_t = [], []
        for _ in range(2):
            base = rng.standard_normal(JSPEC.cache_shape).astype(np.float32)
            pair_j.append(jnp.asarray(base).astype(jnp.bfloat16))
            pair_t.append(torch.from_numpy(base).to(torch.bfloat16))
        jax_caches.append(tuple(pair_j))
        torch_caches.append(tuple(pair_t))
    return jax_caches, torch_caches


def _block_bytes(cache, ids) -> bytes:
    if isinstance(cache, torch.Tensor):
        return cache[list(ids)].view(torch.uint8).numpy().tobytes()
    return np.asarray(cache)[list(ids)].tobytes()


def test_chain_hashes_and_keys_match_jax():
    rng = np.random.default_rng(0)
    for n in (0, 7, 8, 40, 129):
        toks = rng.integers(0, 128256, n).tolist()
        assert token_chain_hashes(toks, 8) == jax_chain_hashes(toks, 8)
        assert token_chain_hashes(toks, 16) == jax_chain_hashes(toks, 16)
    jax_conn = JaxKVConnector(None, JSPEC, "llama-3-8b", MAX_BLOCKS)
    port_conn = KVConnector(None, TSPEC, "llama-3-8b", MAX_BLOCKS, device="cpu")
    toks = rng.integers(0, 128256, 32).tolist()
    for layer in range(GEOM[0]):
        for kind in ("k", "v"):
            for c in token_chain_hashes(toks, 8):
                assert port_conn.block_key(layer, kind, c) == jax_conn.block_key(layer, kind, c)
    assert port_conn.manifest(toks) == jax_conn.manifest(toks)
    assert TSPEC.block_nbytes == JSPEC.block_nbytes


def test_jax_saved_prefix_loads_in_port(conns):
    jconn, tconn = conns
    jax_caches, _ = _random_bf16_caches(1)
    tokens = list(range(100, 132))  # 4 blocks
    src = np.array([3, 7, 1, 9], np.int32)
    saver = JaxKVConnector(jconn, JSPEC, "interop", MAX_BLOCKS)
    assert asyncio.run(saver.save(tokens, jax_caches, src)) == 4 * 2 * GEOM[0]

    loader = KVConnector(tconn, TSPEC, "interop", MAX_BLOCKS, device="cpu")
    assert loader.lookup(tokens) == 4
    dst = np.array([0, 12, 5, 2], np.int32)
    loaded, n = asyncio.run(loader.load(tokens, TSPEC.make_caches("cpu"), dst))
    assert n == 4
    for layer in range(GEOM[0]):
        for kind in (0, 1):
            assert _block_bytes(loaded[layer][kind], dst) == _block_bytes(jax_caches[layer][kind], src)


def test_port_saved_prefix_loads_in_jax(conns):
    jconn, tconn = conns
    _, torch_caches = _random_bf16_caches(2)
    tokens = list(range(500, 524))  # 3 blocks
    src = np.array([15, 4, 8], np.int32)
    saver = KVConnector(tconn, TSPEC, "interop-rev", MAX_BLOCKS, device="cpu")
    assert asyncio.run(saver.save(tokens, torch_caches, src)) == 3 * 2 * GEOM[0]

    loader = JaxKVConnector(jconn, JSPEC, "interop-rev", MAX_BLOCKS)
    assert loader.lookup(tokens) == 3
    dst = np.array([6, 0, 11], np.int32)
    loaded, n = asyncio.run(loader.load(tokens, JSPEC.make_caches(), dst))
    assert n == 3
    for layer in range(GEOM[0]):
        for kind in (0, 1):
            assert _block_bytes(loaded[layer][kind], dst) == _block_bytes(torch_caches[layer][kind], src)


def test_port_lib_roundtrip_match_and_typed_miss(conns):
    _, conn = conns
    block = 4096
    src = np.random.default_rng(3).integers(0, 256, 8 * block, dtype=np.uint8)
    dst = np.zeros_like(src)
    conn.register_mr(src)
    conn.register_mr(dst)
    keys = [f"port-k{i}" for i in range(8)]
    asyncio.run(conn.write_cache_async([(k, i * block) for i, k in enumerate(keys)], block, src.ctypes.data))
    conn.read_cache([(k, i * block) for i, k in enumerate(keys)], block, dst.ctypes.data)
    assert np.array_equal(src, dst)
    assert conn.get_match_last_index(keys[:5] + ["port-missing-a", "port-missing-b"]) == 4
    with pytest.raises(tlib.InfiniStoreNoMatch):
        conn.get_match_last_index(["port-missing-a"])
    with pytest.raises(tlib.InfiniStoreKeyNotFound):
        conn.read_cache([("port-missing-a", 0)], block, dst.ctypes.data)
