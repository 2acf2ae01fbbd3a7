"""The port's sequence-parallel prefill (infinistore_tpu_torch/models/
long_context.py) against the JAX package's, end to end with the store.

Mirrors tests/test_long_context.py: the port's ``prefill_ring`` on 4 gloo
ranks (each a process of its own holding its token chunk) against the JAX
``prefill_ring`` on 4 CPU devices, with the same weights carried across by
``params_from_numpy``: logits and every layer's K/V within 1e-5. Each rank
saves ITS OWN chunk through its own connector under the full token list; a
fresh connector then loads the whole prefix, which must be the ring's K/V
byte for byte and the JAX dense prefill's within 1e-5. The same ranks also
rehearse ``chip_smoke.py``'s long-context path (``_run_long_context``) at a
tiny bf16 width, on 4 gloo ranks."""

import asyncio
import importlib.util
import os

import numpy as np
import pytest
import torch

from test_torch_ring_attention import HERE, spawn_ranks

REPO = os.path.dirname(HERE)
SHAPE = dict(vocab=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
             block_tokens=8)
B, S, RING = 1, 64, 4
REHEARSAL = dict(vocab=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=256,
                 block_tokens=16)
REHEARSAL_TOKENS = 256
TOL = 1e-5


def _configs():
    from infinistore_tpu_torch.models.llama import LlamaConfig
    from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec

    cfg = LlamaConfig(dtype=torch.float32, **SHAPE)
    spec = PagedKVCacheSpec(cfg.n_layers, S // cfg.block_tokens, cfg.block_tokens,
                            cfg.n_kv_heads, cfg.head_dim, torch.float32)
    return cfg, spec


def _rank_main(world, rank, init_file, data_path, port, out_path):
    """One gloo rank: its chunk through ``prefill_ring``, its K/V saved
    under the full token list, then ``chip_smoke._run_long_context``."""
    import torch.distributed as dist

    from infinistore_tpu_torch import config, lib
    from infinistore_tpu_torch.connector import KVConnector
    from infinistore_tpu_torch.models.llama import params_from_numpy
    from infinistore_tpu_torch.models.long_context import prefill_ring

    cfg, spec = _configs()
    data = np.load(data_path)
    params = params_from_numpy({k: data[k] for k in data.files if k != "tokens"}, cfg,
                               device="cpu")
    tokens = data["tokens"]
    s_loc, bps = S // world, S // world // cfg.block_tokens
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        logits, kvs = prefill_ring(params, tokens[:, rank * s_loc:(rank + 1) * s_loc], cfg)
    finally:
        dist.destroy_process_group()
    out = {"logits": logits.numpy()}
    for layer, (k, v) in enumerate(kvs):
        out[f"k{layer}"], out[f"v{layer}"] = k.numpy(), v.numpy()

    # This shard into a scratch paged cache at its GLOBAL block positions,
    # saved under the full token list from its first block on.
    conn = lib.InfinityConnection(config.ClientConfig(
        host_addr="127.0.0.1", service_port=port, log_level="error"))
    conn.connect()
    kvc = KVConnector(conn, spec, "longctx", max_blocks=S // cfg.block_tokens, device="cpu")
    try:
        ids = np.arange(rank * bps, (rank + 1) * bps, dtype=np.int32)
        caches = spec.make_caches("cpu")
        for layer, (k, v) in enumerate(kvs):
            caches[layer][0][ids] = k[0].reshape(bps, *spec.block_shape)
            caches[layer][1][ids] = v[0].reshape(bps, *spec.block_shape)
        out["written"] = np.array(asyncio.run(kvc.save(
            [int(t) for t in tokens[0]], caches, ids, first_block=rank * bps)))
    finally:
        kvc.close()
        conn.close()

    spec_file = importlib.util.spec_from_file_location("chip_smoke",
                                                       os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec_file)
    spec_file.loader.exec_module(chip_smoke)
    metrics, launches = chip_smoke._run_long_context(
        torch, port, None, device="cpu", backend="gloo", geometry=REHEARSAL,
        tokens=REHEARSAL_TOKENS, rank=rank, world=world, init_file=f"{init_file}.rehearsal")
    out["rehearsal_world"] = np.array(metrics["world_size"])
    out["rehearsal_launches"] = np.array(sum(launches.values()))
    np.savez(f"{out_path}{rank}.npz", **out)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX weights and prompt, the 4 ranks' outputs, and the store they
    saved to (stopped after the module)."""
    import jax

    from infinistore_tpu.models import LlamaConfig, init_params
    from infinistore_tpu_torch import lib

    jcfg = LlamaConfig(dtype=jax.numpy.float32, **SHAPE)
    jparams = init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (B, S), 0, SHAPE["vocab"]),
                        np.int32)
    tmp = tmp_path_factory.mktemp("longctx")
    data_path = str(tmp / "inputs.npz")
    np.savez(data_path, tokens=tokens, **{k: np.asarray(v) for k, v in jparams.items()})
    server = lib.start_local_server(prealloc_bytes=64 << 20, block_bytes=16 << 10,
                                    pin_memory=False)
    try:
        spawn_ranks(tmp, RING, "test_torch_long_context", "_rank_main", data_path, server.port,
                    str(tmp / "out"))
        outs = [np.load(str(tmp / f"out{rank}.npz")) for rank in range(RING)]
        yield jcfg, jparams, tokens, outs, server
    finally:
        server.stop()


def _jax_ring(jcfg, jparams, tokens):
    import jax
    from jax.sharding import Mesh

    from infinistore_tpu.models.long_context import prefill_ring

    mesh = Mesh(np.array(jax.devices()[:RING]), ("sp",))
    return prefill_ring(jparams, jax.numpy.asarray(tokens), jcfg, mesh=mesh, axis="sp")


def test_sp_prefill_matches_jax(run):
    jcfg, jparams, tokens, outs, _ = run
    logits, kvs = _jax_ring(jcfg, jparams, tokens)
    np.testing.assert_allclose(np.concatenate([o["logits"] for o in outs], axis=1),
                               np.asarray(logits), rtol=TOL, atol=TOL)
    for layer in range(jcfg.n_layers):
        for side, name in enumerate("kv"):
            np.testing.assert_allclose(
                np.concatenate([o[f"{name}{layer}"] for o in outs], axis=1),
                np.asarray(kvs[layer][side]), rtol=TOL, atol=TOL)


def test_sp_prefill_streams_to_store_per_shard(run):
    """Each rank saved its own chunk (same model id, so chain keys line up);
    a decode-side connector finds the whole prefix and loads the ring's K/V
    byte for byte, within 1e-5 of the JAX dense prefill's."""
    import jax.numpy as jnp

    from infinistore_tpu.models.llama import _kv_proj
    from infinistore_tpu_torch import config, lib
    from infinistore_tpu_torch.connector import KVConnector

    jcfg, jparams, tokens, outs, server = run
    cfg, spec = _configs()
    bps = S // RING // cfg.block_tokens
    assert all(int(o["written"]) == 2 * cfg.n_layers * bps for o in outs)
    conn = lib.InfinityConnection(config.ClientConfig(
        host_addr="127.0.0.1", service_port=server.port, log_level="error"))
    conn.connect()
    kvc = KVConnector(conn, spec, "longctx", max_blocks=S // cfg.block_tokens, device="cpu")
    try:
        token_list = [int(t) for t in tokens[0]]
        assert kvc.lookup(token_list) == S // cfg.block_tokens
        ids = np.arange(S // cfg.block_tokens, dtype=np.int32)
        got, loaded = asyncio.run(kvc.load(token_list, spec.make_caches("cpu"), ids))
        assert loaded == S // cfg.block_tokens
    finally:
        kvc.close()
        conn.close()
    # The JAX dense reference's K/V: layer by layer, as tests/test_long_context.py builds it.
    from infinistore_tpu.models.llama import _block

    positions = jnp.arange(S, dtype=jnp.int32)[None]
    x = jnp.take(jparams["embed"], jnp.asarray(tokens), axis=0)
    mask = positions[:, :, None] >= positions[:, None, :]
    for layer in range(cfg.n_layers):
        k, v = _kv_proj(jparams, layer, x, positions, jcfg)
        x = _block(jparams, layer, x, k, v, positions, mask, jcfg)
        for side, (name, ref) in enumerate((("k", k), ("v", v))):
            flat = got[layer][side].reshape(S, cfg.n_kv_heads, cfg.head_dim).numpy()
            ring = np.concatenate([o[f"{name}{layer}"] for o in outs], axis=1)[0]
            assert flat.tobytes() == ring.tobytes()
            np.testing.assert_allclose(flat, np.asarray(ref)[0], rtol=TOL, atol=TOL)


def test_chip_smoke_long_context_rehearsal_on_cpu(run):
    """``chip_smoke.py``'s long-context path on 4 gloo ranks at a tiny bf16
    width: every rank's checks held (they raise), on the CPU's plain
    versions (no launch counted)."""
    _, _, _, outs, _ = run
    assert [int(o["rehearsal_world"]) for o in outs] == [RING] * RING
    assert [int(o["rehearsal_launches"]) for o in outs] == [0] * RING


def test_prefill_ring_needs_a_group_and_a_dense_config():
    from infinistore_tpu_torch.models.llama import LlamaConfig, init_params
    from infinistore_tpu_torch.models.long_context import prefill_ring

    cfg, _ = _configs()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        prefill_ring(params, np.zeros((1, 8), np.int64), cfg)
    moe = LlamaConfig(dtype=torch.float32, **dict(SHAPE, n_experts=2))
    with pytest.raises(ValueError, match="dense"):
        prefill_ring(init_params(moe, torch.Generator(), device="cpu"), np.zeros((1, 8)), moe)
