"""The port's same-mesh block transfer (infinistore_tpu_torch/cuda/ici.py)
and the connector's interconnect branch, against the JAX package's
(infinistore_tpu/tpu/ici.py) on the same numpy inputs.

Mirrors the 10 tests of tests/test_ici.py. The port's mesh is 8 ``"cpu"``
entries (K1/K2 run their plain versions there), the JAX side the 8-device
CPU mesh that conftest forces; every result must be byte-equal to the JAX
package's. Also rehearses ``chip_smoke.py``'s ICI handoff path at a tiny
width on a mesh naming the CPU twice."""

import asyncio
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.tpu.ici import IciBlockTransfer as JaxIci
from infinistore_tpu.tpu.ici import mesh_from_devices as jax_mesh_from_devices
from infinistore_tpu_torch.cuda.ici import IciBlockTransfer, mesh_from_devices

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DEV = 8


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == N_DEV, "conftest must force 8 CPU devices"
    return jax_mesh_from_devices(axis_name="store"), mesh_from_devices(["cpu"] * N_DEV)


def _shards(arr):
    """numpy [N_DEV, ...] -> the port's per-shard list (copies)."""
    return [torch.from_numpy(np.array(a)) for a in arr]


def _same(port_shards, jax_arr):
    """Byte equality of the port's shards with the JAX array."""
    want = np.asarray(jax_arr)
    got = np.stack([t.numpy() for t in port_shards])
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_transfer_point_to_point(meshes):
    jmesh, tmesh = meshes
    blocks = np.arange(N_DEV * 4 * 8, dtype=np.float32).reshape(N_DEV, 4, 8)
    jout = JaxIci(jmesh, "store", perm=[(2, 5)]).transfer(jnp.asarray(blocks))
    out = IciBlockTransfer(tmesh, "store", perm=[(2, 5)]).transfer(_shards(blocks))
    _same(out, jout)
    assert np.array_equal(out[5].numpy(), blocks[2]) and out[0].sum() == 0


def test_transfer_pairwise_exchange(meshes):
    jmesh, tmesh = meshes
    blocks = np.stack([np.full((2, 4), i, np.float32) for i in range(N_DEV)])
    jout = JaxIci(jmesh, "store", perm=[(0, 1), (1, 0)]).transfer(jnp.asarray(blocks))
    out = IciBlockTransfer(tmesh, "store", perm=[(0, 1), (1, 0)]).transfer(_shards(blocks))
    _same(out, jout)
    assert (out[0] == 1).all() and (out[1] == 0).all()


def test_send_blocks_gather_and_deliver(meshes):
    """Prefill shard 1 sends selected paged blocks to decode shard 6."""
    jmesh, tmesh = meshes
    cache = _rand(0, (N_DEV, 16, 4, 2, 8))
    ids = np.array([3, 11, 7], np.int32)
    jtr = JaxIci(jmesh, "store", perm=[(1, 6)])
    jout = jtr.send_blocks(jnp.asarray(cache), ids, src=1, dst=6)
    out = IciBlockTransfer(tmesh, "store", perm=[(1, 6)]).send_blocks(_shards(cache), ids, 1, 6)
    _same(out, jout)
    assert np.array_equal(out[6].numpy(), cache[1][ids]) and out[0].sum() == 0


def test_handoff_blocks_single_program(meshes):
    """Gather + move + scatter: src shard's pages land at dst's chosen
    slots; every other page of every shard keeps its bytes."""
    jmesh, tmesh = meshes
    cache = _rand(3, (N_DEV, 16, 4, 2, 8))
    src_ids, dst_ids = np.array([2, 9], np.int32), np.array([14, 0], np.int32)
    jout = JaxIci(jmesh, "store", perm=[(1, 6)]).handoff_blocks(
        jnp.asarray(cache), src_ids, dst_ids, src=1, dst=6)
    shards = _shards(cache)
    tr = IciBlockTransfer(tmesh, "store", perm=[(1, 6)])
    out = tr.handoff_blocks(shards, src_ids, dst_ids, 1, 6)
    _same(out, jout)
    assert all(a is b for a, b in zip(out, shards))  # in place
    assert np.array_equal(out[6][14].numpy(), cache[1][2])
    mask = np.ones((N_DEV, 16), bool)
    mask[6][14] = mask[6][0] = False
    assert np.array_equal(np.stack([t.numpy() for t in out])[mask], cache[mask])


def test_transfer_counts_one_launch_a_call(meshes):
    """The port's counterpart of test_transfer_jit_is_cached: no program is
    compiled, so what stays is the launch count (one a call, repeated calls
    alike) and that shards already on their devices are used as given,
    while a shard on another device is refused, not moved."""
    jmesh, tmesh = meshes
    cache = np.zeros((N_DEV, 4, 2, 2), np.float32)
    ids = np.array([1], np.int32)
    jtr = JaxIci(jmesh, "store", perm=[(0, 3)])
    tr = IciBlockTransfer(tmesh, "store", perm=[(0, 3)])
    for _ in range(2):
        _same(tr.send_blocks(_shards(cache), ids, 0, 3),
              jtr.send_blocks(jnp.asarray(cache), ids, 0, 3))
    assert tr.launches == jtr.launches == 2
    shards = _shards(cache)
    assert tr._check_shards("t", shards)[0] is shards[0]
    with pytest.raises(ValueError, match="mesh device"):
        tr.transfer([torch.zeros(2, device="meta")] + [torch.zeros(2)] * (N_DEV - 1))


def test_handoff_layers_single_launch(meshes):
    """An 8-layer handoff is ONE launch (one K1 over all 16 caches, one copy,
    one K2), byte-equal to the JAX package's and to the per-layer path."""
    jmesh, tmesh = meshes
    L = 8
    refs = [(_rand(7 + 2 * l, (N_DEV, 12, 4, 2, 8)), _rand(8 + 2 * l, (N_DEV, 12, 4, 2, 8)))
            for l in range(L)]
    src_ids, dst_ids = np.array([2, 9, 5], np.int32), np.array([11, 0, 7], np.int32)
    jout = JaxIci(jmesh, "store", perm=[(1, 6)]).handoff_layers(
        [(jnp.asarray(k), jnp.asarray(v)) for k, v in refs], src_ids, dst_ids, src=1, dst=6)
    tr = IciBlockTransfer(tmesh, "store", perm=[(1, 6)])
    out = tr.handoff_layers([(_shards(k), _shards(v)) for k, v in refs], src_ids, dst_ids, 1, 6)
    assert tr.launches == 1
    tr2 = IciBlockTransfer(tmesh, "store", perm=[(1, 6)])
    for l in range(L):
        _same(out[l][0], jout[l][0])
        _same(out[l][1], jout[l][1])
        k2, v2 = tr2.handoff_kv(_shards(refs[l][0]), _shards(refs[l][1]), src_ids, dst_ids, 1, 6)
        _same(k2, jout[l][0])
        _same(v2, jout[l][1])
    assert tr2.launches == L
    tr.handoff_layers([(_shards(k), _shards(v)) for k, v in refs], src_ids, dst_ids, 1, 6)
    assert tr.launches == 2


def test_handoff_layers_rejects_ragged_caches(meshes):
    jmesh, tmesh = meshes
    a, b = np.zeros((N_DEV, 4, 2, 2), np.float32), np.zeros((N_DEV, 6, 2, 2), np.float32)
    with pytest.raises(ValueError, match="uniform"):
        JaxIci(jmesh, "store", perm=[(0, 1)]).handoff_layers(
            [(jnp.asarray(a), jnp.asarray(a)), (jnp.asarray(b), jnp.asarray(b))], [0], [1],
            src=0, dst=1)
    tr = IciBlockTransfer(tmesh, "store", perm=[(0, 1)])
    with pytest.raises(ValueError, match="uniform"):
        tr.handoff_layers([(_shards(a), _shards(a)), (_shards(b), _shards(b))], [0], [1], 0, 1)
    with pytest.raises(ValueError, match="out of range"):
        tr.handoff_layers([(_shards(a), _shards(a))], [0], [1], 0, N_DEV)
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        tr.handoff_layers([(_shards(a), _shards(a))], [4], [1], 0, 1)
    assert tr.launches == 0


class _CudaLike:
    """What ``paged._launch`` reads of a cache or an id tensor, on a named
    CUDA device that this CPU host does not have."""

    def __init__(self, index, ptr, shape=(4, 2, 8)):
        self.device = torch.device("cuda", index)
        self.shape = shape
        self._ptr = ptr

    def data_ptr(self):
        return self._ptr

    def element_size(self):
        return 4


def test_kernel_launches_run_under_their_tensors_device(monkeypatch):
    """K1/K2 enter their caches' device around the library call (the
    library works on the current device), so a cache on a mesh's second
    card launches there while another card is current."""
    from infinistore_tpu_torch.cuda import _ext, paged

    entered, seen = [], []

    class Device:
        def __init__(self, device):
            self.device = torch.device(device)

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            entered.pop()

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                seen.append((name, entered[-1] if entered else None))
                return 0
            return entry

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(_ext, "kernels", Lib)
    monkeypatch.setattr(_ext, "stream_of", lambda t: 0)
    monkeypatch.setattr(_ext, "LAUNCHES", dict(_ext.LAUNCHES))  # these launches stay here
    caches = [_CudaLike(1, 4096 * (c + 1)) for c in range(paged.MAX_CACHES + 1)]
    paged._launch("gather_blocks", caches, _CudaLike(1, 64, (3,)),
                  [1 << 20 + c for c in range(len(caches))])
    paged._launch("scatter_blocks", caches[:2], _CudaLike(1, 64, (3,)), [1 << 20, 1 << 21])
    assert seen == [("its_gather_blocks_many", torch.device("cuda", 1))] * 2 + [
        ("its_scatter_blocks_many", torch.device("cuda", 1))]
    assert not entered


def test_handoff_gathers_on_src_shards_and_scatters_on_dst(meshes, monkeypatch):
    """K1 takes shard ``src`` of every cache and K2 shard ``dst``, each on
    its own mesh device, with the packed blocks copied to ``mesh[dst]``
    between them: with K1/K2 entering their caches' device, the gather runs
    on the source card and the scatter on the destination card."""
    from infinistore_tpu_torch.cuda import ici

    _, tmesh = meshes
    calls = []
    real_gather, real_scatter = ici.gather_blocks_many, ici.scatter_blocks_many

    def gather(caches, ids):
        calls.append(("K1", [id(c) for c in caches], ids.device))
        return real_gather(caches, ids)

    def scatter(caches, ids, blocks):
        calls.append(("K2", [id(c) for c in caches], ids.device, blocks.device))
        return real_scatter(caches, ids, blocks)

    monkeypatch.setattr(ici, "gather_blocks_many", gather)
    monkeypatch.setattr(ici, "scatter_blocks_many", scatter)
    layers = [(_shards(_rand(30 + 2 * l, (N_DEV, 6, 2, 4))),
               _shards(_rand(31 + 2 * l, (N_DEV, 6, 2, 4)))) for l in range(3)]
    tr = IciBlockTransfer(tmesh, "store", perm=[(3, 6)])
    tr.handoff_layers(layers, [1, 4], [0, 5], 3, 6)
    flat = [shards for kv in layers for shards in kv]
    assert calls == [
        ("K1", [id(s[3]) for s in flat], tmesh[3]),
        ("K2", [id(s[6]) for s in flat], tmesh[6], tmesh[6]),
    ]


def _spec_and_caches(seed_k, seed_v):
    from infinistore_tpu.tpu.paged import PagedKVCacheSpec as JaxSpec

    from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec

    geom = (2, 8, 4, 2, 8)
    jspec, tspec = JaxSpec(*geom, dtype=jnp.float32), PagedKVCacheSpec(*geom, torch.float32)
    refs = [(_rand(seed_k + l, (N_DEV, *tspec.cache_shape)),
             _rand(seed_v + l, (N_DEV, *tspec.cache_shape))) for l in range(geom[0])]
    return jspec, tspec, refs


def test_connector_handoff_routes_ici_without_store(meshes):
    """With a transfer bound, the connector's handoff moves blocks device to
    device in one launch and never touches a store (conn None)."""
    from infinistore_tpu.connector import KVConnector as JaxKVConnector

    from infinistore_tpu_torch.connector import KVConnector

    jmesh, tmesh = meshes
    jspec, tspec, refs = _spec_and_caches(10, 20)
    src_ids, dst_ids = np.array([1, 6], np.int32), np.array([3, 0], np.int32)
    jtr = JaxIci(jmesh, "store", perm=[(0, 5)])
    tr = IciBlockTransfer(tmesh, "store", perm=[(0, 5)])
    jkvc = JaxKVConnector(None, jspec, "ici-model", max_blocks=4, ici=jtr)
    jout, jn = asyncio.run(jkvc.handoff(
        list(range(8)), [(jnp.asarray(k), jnp.asarray(v)) for k, v in refs], src_ids, dst_ids,
        src=0, dst=5))
    kvc = KVConnector(None, tspec, "ici-model", max_blocks=4, device="cpu", ici=tr)
    assert kvc.pool is None  # no store data plane
    out, n = asyncio.run(kvc.handoff(list(range(8)), [(_shards(k), _shards(v)) for k, v in refs],
                                     src_ids, dst_ids, src=0, dst=5))
    assert n == jn == 2 and tr.launches == 1
    for l in range(tspec.num_layers):
        for side in (0, 1):
            _same(out[l][side], jout[l][side])
            assert np.array_equal(out[l][side][5][3].numpy(), refs[l][side][0][1])
    with pytest.raises(ValueError, match="src and dst"):
        asyncio.run(kvc.handoff(list(range(8)), out, src_ids, dst_ids))
    kvc.close()


def test_connector_handoff_ragged_layers_fall_back_per_layer(meshes):
    """Ragged layers cannot share one packed buffer: one K + V launch per
    layer, the JAX package's bytes."""
    from infinistore_tpu.connector import KVConnector as JaxKVConnector

    from infinistore_tpu_torch.connector import KVConnector

    jmesh, tmesh = meshes
    jspec, tspec, _ = _spec_and_caches(0, 0)
    # Layer 1 has twice the blocks of layer 0.
    layers = [tuple(np.full((N_DEV, nb, 4, 2, 8), fill, np.float32) for fill in fills)
              for nb, fills in ((8, (1, 2)), (16, (3, 4)))]
    src_ids, dst_ids = np.array([1, 2]), np.array([5, 0])
    jtr = JaxIci(jmesh, "store", perm=[(0, 3)])
    tr = IciBlockTransfer(tmesh, "store", perm=[(0, 3)])
    jkvc = JaxKVConnector(None, jspec, "ragged", max_blocks=4, ici=jtr)
    kvc = KVConnector(None, tspec, "ragged", max_blocks=4, device="cpu", ici=tr)
    jout, _ = asyncio.run(jkvc.handoff(
        list(range(8)), [(jnp.asarray(k), jnp.asarray(v)) for k, v in layers], src_ids, dst_ids,
        src=0, dst=3))
    out, n = asyncio.run(kvc.handoff(
        list(range(8)), [(_shards(k), _shards(v)) for k, v in layers], src_ids, dst_ids,
        src=0, dst=3))
    assert n == 2 and tr.launches == jtr.launches == 2
    for l in range(2):
        for side in (0, 1):
            _same(out[l][side], jout[l][side])


def test_connector_handoff_degrades_to_store():
    """Without a bound transfer the same call rides the store, bytes as the
    JAX package's test checks them; with one bound but no shard indices, a
    connector with a store also takes the store."""
    from infinistore_tpu_torch import config, lib
    from infinistore_tpu_torch.connector import KVConnector
    from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec

    spec = PagedKVCacheSpec(2, 16, 4, 2, 8, torch.bfloat16)
    srv = lib.start_local_server(prealloc_bytes=32 << 20, block_bytes=16 << 10)
    conn = lib.InfinityConnection(config.ClientConfig(
        host_addr="127.0.0.1", service_port=srv.port, log_level="error"))
    conn.connect()
    try:
        for ici in (None, IciBlockTransfer(["cpu", "cpu"], "store", perm=[(0, 1)])):
            kvc = KVConnector(conn, spec, "dcn-model", max_blocks=4, device="cpu", ici=ici)
            g = torch.Generator().manual_seed(3)
            caches = [tuple(torch.randn(spec.cache_shape, generator=g).to(spec.dtype)
                            for _ in range(2)) for _ in range(spec.num_layers)]
            refs = [tuple(c.clone() for c in kv) for kv in caches]
            src_ids, dst_ids = np.array([5, 11], np.int32), np.array([0, 3], np.int32)
            out, n = asyncio.run(kvc.handoff(list(range(8)), caches, src_ids, dst_ids))
            assert n == 2 and (ici is None or ici.launches == 0)
            for l in range(spec.num_layers):
                for side in (0, 1):
                    assert torch.equal(out[l][side][dst_ids], refs[l][side][src_ids])
            kvc.drop(list(range(8)))
            kvc.close()
    finally:
        conn.close()
        srv.stop()


def test_chip_smoke_ici_handoff_rehearsal_on_cpu():
    """``chip_smoke.py``'s ICI handoff path at a tiny width on the CPU: a
    mesh naming the CPU twice, engine A's prefill moved into engine B's
    cache by the connector's interconnect branch, byte-equal, one launch a
    request, and B's greedy steps bitwise those after the store handoff."""
    from infinistore_tpu_torch import lib

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    geometry = dict(vocab=256, dim=128, n_layers=2, n_heads=2, n_kv_heads=1, ffn_dim=256,
                    block_tokens=16)
    server = lib.start_local_server(prealloc_bytes=64 << 20, block_bytes=16 << 10,
                                    pin_memory=False)
    try:
        metrics, launches = chip_smoke._run_ici_handoff(
            torch, server.port, None, device="cpu", geometry=geometry, prompt_tokens=64)
    finally:
        server.stop()
    assert metrics["handoff_launches"] == [1] * chip_smoke.PROMPTS
    assert set(launches.values()) == {0}  # the CPU runs the plain versions
