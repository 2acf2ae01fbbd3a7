"""The PyTorch port's flagship round trip: prefill on one engine, KV blocks
through the store, decode resumed on a second engine with another block
layout — the port's version of the JAX package's
``test_disagg_prefill_store_decode``, on a server from the port's own
``start_local_server``, over both the shm and the socket data planes. The
disaggregated logits must equal the JAX package's non-disaggregated
``decode_step`` logits for the same weights (2e-4)."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.models import llama as jl
from infinistore_tpu_torch import config as tconfig
from infinistore_tpu_torch import lib as tlib
from infinistore_tpu_torch.connector import KVConnector
from infinistore_tpu_torch.cuda.layerwise import (
    LayerwiseKVReader,
    LayerwiseKVWriter,
    kv_block_key,
)
from infinistore_tpu_torch.cuda.staging import HostStagingPool
from infinistore_tpu_torch.models import llama as tl

SHAPE = dict(vocab=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
             block_tokens=8)
JCFG = jl.LlamaConfig(dtype=jnp.float32, **SHAPE)
TCFG = tl.LlamaConfig(dtype=torch.float32, **SHAPE)
NUM_BLOCKS = 16
MAX_BLOCKS = 4
TOL = 2e-4


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tparams = tl.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, TCFG, device="cpu")
    return jparams, tparams


@pytest.fixture()
def port_server():
    srv = tlib.start_local_server(
        prealloc_bytes=64 << 20, block_bytes=16 << 10, extend_bytes=64 << 20
    )
    yield srv
    srv.stop()


@pytest.fixture(params=["shm", "socket"])
def port_conn(port_server, request):
    c = tlib.InfinityConnection(tconfig.ClientConfig(
        host_addr="127.0.0.1", service_port=port_server.port, log_level="error",
        enable_shm=request.param == "shm",
    ))
    c.connect()
    assert c.shm_active == (request.param == "shm")
    yield c
    c.close()


def _jax_reference(jparams, prompt, next_tok):
    """Decode on the prefill engine itself (no store in the loop)."""
    caches = JCFG.kv_spec(NUM_BLOCKS).make_caches()
    _, caches = jl.prefill(jparams, jnp.asarray(prompt), caches, jnp.asarray([5, 9], jnp.int32), JCFG)
    logits, _ = jl.decode_step(jparams, jnp.int32(next_tok), jnp.int32(16), caches,
                               jnp.asarray([5, 9, 12, 13], jnp.int32), JCFG, MAX_BLOCKS)
    return np.asarray(logits)


def test_disagg_prefill_store_decode(port_conn, weights):
    """Prefill engine -> store -> fresh decode engine; logits must match the
    JAX package's non-disaggregated continuation."""
    jparams, tparams = weights
    prompt = np.random.default_rng(3).integers(0, SHAPE["vocab"], 16).astype(np.int32)
    next_tok = 42
    table = np.array([5, 9], np.int32)  # prefill engine's blocks
    spec = TCFG.kv_spec(NUM_BLOCKS)

    # --- prefill engine ---
    _, prefill_caches = tl.prefill(tparams, prompt, spec.make_caches("cpu"), table, TCFG)
    pool = HostStagingPool(nbytes=4 * 2 * spec.block_nbytes * 2, block_size=spec.block_nbytes,
                           conn=port_conn, device="cpu")
    writer = LayerwiseKVWriter(port_conn, pool, spec, max_blocks=2)

    def key_fn(layer, kind, i):
        return kv_block_key("demo", "prompt-hash", layer, kind, i)

    assert asyncio.run(writer.write(prefill_caches, table, key_fn)) == 2 * 2 * SHAPE["n_layers"]

    # --- decode engine (different block layout!) ---
    decode_table = np.array([1, 2, 14, 3], np.int32)
    reader = LayerwiseKVReader(port_conn, pool, spec, max_blocks=2)
    decode_caches = asyncio.run(reader.read(spec.make_caches("cpu"), decode_table[:2], key_fn))
    logits, _ = tl.decode_step(tparams, next_tok, 16, decode_caches, decode_table, TCFG, MAX_BLOCKS)
    np.testing.assert_allclose(
        logits.numpy(), _jax_reference(jparams, prompt, next_tok), rtol=TOL, atol=TOL
    )


def test_connector_save_lookup_load_decode(port_conn, weights):
    """The same round trip through KVConnector.save / lookup / load."""
    jparams, tparams = weights
    prompt = np.random.default_rng(3).integers(0, SHAPE["vocab"], 16).astype(np.int32)
    spec = TCFG.kv_spec(NUM_BLOCKS)
    producer = KVConnector(port_conn, spec, "demo-llama", max_blocks=MAX_BLOCKS, device="cpu")
    consumer = KVConnector(port_conn, spec, "demo-llama", max_blocks=MAX_BLOCKS, device="cpu")

    assert consumer.lookup(prompt.tolist()) == 0
    _, caches = tl.prefill(tparams, prompt, spec.make_caches("cpu"), np.array([5, 9]), TCFG)
    written = asyncio.run(producer.save(prompt.tolist(), caches, np.array([5, 9], np.int32)))
    assert written == 2 * 2 * SHAPE["n_layers"]
    assert consumer.lookup(prompt.tolist()) == 2
    # A prompt sharing one block and then diverging hits exactly one.
    other = prompt.tolist()[:8] + [1] * 8
    assert consumer.lookup(other) == 1

    decode_table = np.array([1, 2, 14, 3], np.int32)
    loaded, n = asyncio.run(consumer.load(prompt.tolist(), spec.make_caches("cpu"), decode_table))
    assert n == 2
    for layer in range(SHAPE["n_layers"]):
        for kind in (0, 1):
            assert torch.equal(loaded[layer][kind][[1, 2]], caches[layer][kind][[5, 9]])
    logits, _ = tl.decode_step(tparams, 42, 16, loaded, decode_table, TCFG, MAX_BLOCKS)
    np.testing.assert_allclose(
        logits.numpy(), _jax_reference(jparams, prompt, 42), rtol=TOL, atol=TOL
    )

    # manifest lists every key with the layer-0 K sentinels last; drop
    # removes them all, after which the prefix misses.
    ((nbytes, keys),) = producer.manifest(prompt.tolist())
    assert nbytes == spec.block_nbytes and len(keys) == 2 * 2 * SHAPE["n_layers"]
    assert all("/L0/k/" in k for k in keys[-2:])
    assert producer.drop(prompt.tolist()) == len(keys)
    assert consumer.lookup(prompt.tolist()) == 0
    assert isinstance(producer.get_stats(), dict)


def test_load_mid_read_race_returns_partial_caches(port_conn):
    """Blocks raced away between lookup and read, after layer 0 was
    scattered: load reports a miss and hands back the partially updated
    list (layer 0 holds the fetched bytes, later layers are untouched)."""
    spec = TCFG.kv_spec(NUM_BLOCKS)
    kv = KVConnector(port_conn, spec, "race", max_blocks=MAX_BLOCKS, device="cpu")
    tokens = list(range(16))
    rng = np.random.default_rng(8)
    caches = [
        tuple(torch.from_numpy(rng.standard_normal(spec.cache_shape).astype(np.float32))
              for _ in range(2))
        for _ in range(SHAPE["n_layers"])
    ]
    asyncio.run(kv.save(tokens, caches, np.array([1, 2], np.int32)))
    chains = kv._chains(tokens)
    assert port_conn.delete_keys([kv.block_key(1, "k", c) for c in chains]) == 2
    fresh = spec.make_caches("cpu")
    loaded, n = asyncio.run(kv.load(tokens, fresh, np.array([4, 5], np.int32)))
    assert n == 0
    assert loaded[-1][0] is fresh[-1][0] and not loaded[-1][0].any()
    assert torch.equal(loaded[0][0][[4, 5]], caches[0][0][[1, 2]])


def test_chip_smoke_main_path_rehearsal_on_cpu(port_server):
    """``chip_smoke.py``'s main path — prefill 4 prompts, save, lookup,
    load into other block ids, byte compare, 16-step wave decode on both
    engines with bitwise-equal logits — run here at a tiny geometry on the
    CPU, so the control flow the card runs at Llama-3-8B width is exercised
    by every test run."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    geometry = dict(vocab=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=256,
                    block_tokens=16, rope_theta=500000.0)
    metrics, launches, params, state = chip_smoke.main_path(
        torch, port_server.port, device="cpu", geometry=geometry, prompt_tokens=64
    )
    assert params["embed"].shape == (256, 256)  # handed on to the engine phase
    assert metrics["kv_bytes_moved"] == chip_smoke.PROMPTS * 4 * 4096 * 2 * 2
    assert metrics["store_bytes_per_key"] == 16 << 10  # one 4 KiB block, one 16 KiB unit
    assert state["caches_a"][0][0].shape == (state["spec"].num_blocks, 16, 2, 64)
    # The CPU runs the plain versions: no kernel was launched.
    assert set(launches.values()) == {0}


@pytest.mark.parametrize("count,seed,req_blocks", [(9, 0, 4), (5, 7, 2), (0, 3, 4)])
def test_heterogeneous_prompts_match_the_jax_harness(count, seed, req_blocks):
    """``DisaggHarness.heterogeneous_prompts``: the JAX harness's lists (block
    counts cycling 1..req_blocks, each prompt from its own seed) for the
    same config, count and seed."""
    from infinistore_tpu import disagg as jd
    from infinistore_tpu_torch import disagg as td

    jh = jd.DisaggHarness(lambda: None, jd.demo_config(n_layers=1), req_blocks=req_blocks)
    th = td.DisaggHarness(lambda: None, td.demo_config(n_layers=1), req_blocks=req_blocks,
                          device="cpu")
    want = jh.heterogeneous_prompts(count, seed=seed)
    got = th.heterogeneous_prompts(count, seed=seed)
    assert got == want
    assert [len(p) // th.config.block_tokens for p in got] == [
        1 + i % req_blocks for i in range(count)]
