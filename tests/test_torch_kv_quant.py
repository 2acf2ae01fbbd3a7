"""The port's int8 KV scheme (infinistore_tpu_torch/cuda/kv_quant.py) against
the JAX package's (infinistore_tpu/tpu/kv_quant.py), on the CPU with the
plain versions of the kernels, over the port's own loopback store.

Mirrors the five tests of tests/test_kv_quant.py (the quantizer's error
bound, K8's plain version against the JAX kernel in interpret mode and
against full precision, the half-bytes store round trip, the engine over
``QuantizingKVAdapter``, the scales race degrading to a miss), and adds:
``quantize_kv``/``dequantize_kv`` bitwise against JAX (f32 and bf16 inputs,
ties at .5); prefixes saved by either package's ``QuantizedKVConnector``
loading byte-identically in the other; the manifest's order; the zipped
``PartialReadError``; and ``stage_layer_save`` (its ``first_block`` bounds,
a layer-streamed round trip, and a quantized layer-streamed save whose
shipping order keeps the data plane's sentinel last)."""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import infinistore_tpu as its
from infinistore_tpu.tpu import kv_quant as jkq
from infinistore_tpu.tpu.paged import PagedKVCacheSpec as JaxSpec
from infinistore_tpu_torch import config as tconfig
from infinistore_tpu_torch import lib as tlib
from infinistore_tpu_torch.connector import KVConnector
from infinistore_tpu_torch.cuda import kv_quant as tkq
from infinistore_tpu_torch.cuda.layerwise import PartialReadError
from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec
from infinistore_tpu_torch.cuda.paged_attention import paged_decode_attention_plain_batched

GEOM = (2, 16, 8, 2, 32)  # layers, blocks, block_tokens, kv_heads, head_dim
SPEC = PagedKVCacheSpec(*GEOM, torch.float32)
JSPEC = JaxSpec(*GEOM, jnp.float32)


@pytest.fixture()
def port_server():
    srv = tlib.start_local_server(
        prealloc_bytes=64 << 20, block_bytes=16 << 10, extend_bytes=64 << 20
    )
    yield srv
    srv.stop()


def _port_conn(port, shm=True):
    c = tlib.InfinityConnection(tconfig.ClientConfig(
        host_addr="127.0.0.1", service_port=port, log_level="error", enable_shm=shm))
    c.connect()
    return c


@pytest.fixture(params=["shm", "socket"])
def tconn(port_server, request):
    c = _port_conn(port_server.port, request.param == "shm")
    yield c
    c.close()


@pytest.fixture(params=["shm", "socket"])
def conns(port_server, request):
    """One store, one client of each package on the same data plane."""
    shm = request.param == "shm"
    tc = _port_conn(port_server.port, shm)
    jc = its.InfinityConnection(its.ClientConfig(
        host_addr="127.0.0.1", service_port=port_server.port, log_level="error",
        enable_shm=shm,
    ))
    jc.connect()
    yield jc, tc
    jc.close()
    tc.close()


def _quant_caches(seed, spec=SPEC):
    """Per layer ((k_int8, k_scales), (v_int8, v_scales)) from seeded floats."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(spec.num_layers):
        k = torch.from_numpy(rng.standard_normal(spec.cache_shape).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal(spec.cache_shape).astype(np.float32))
        out.append((tkq.quantize_kv(k), tkq.quantize_kv(v)))
    return out


def _fresh(spec=SPEC):
    def side():
        return (torch.zeros(spec.cache_shape, dtype=torch.int8),
                torch.zeros(spec.cache_shape[:-1], dtype=torch.float32))

    return [(side(), side()) for _ in range(spec.num_layers)]


def _block_bytes(t, ids) -> bytes:
    if isinstance(t, torch.Tensor):
        return t[list(ids)].contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(t)[list(ids)].tobytes()


def _assert_quant_blocks_equal(a, a_ids, b, b_ids):
    for layer in range(len(a)):
        for side in (0, 1):
            for part in (0, 1):  # int8 data, f32 scales
                assert _block_bytes(a[layer][side][part], a_ids) == _block_bytes(
                    b[layer][side][part], b_ids), (layer, side, part)


# --- the quantizer ---------------------------------------------------------


def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((16, 8, 2, 32)) * 3.0).astype(np.float32))
    q, s = tkq.quantize_kv(x)
    assert q.dtype == torch.int8 and tuple(s.shape) == tuple(x.shape[:-1])
    back = tkq.dequantize_kv(q, s)
    # Per-vector bound: half a quantization step of that vector's absmax.
    step = x.abs().amax(dim=-1) / 127.0
    err = (back - x).abs()
    assert bool((err <= step[..., None] * 0.5000001 + 1e-7).all())
    # Zero vectors: scale 0, exact zeros back.
    zq, zs = tkq.quantize_kv(torch.zeros((4, 8)))
    assert float(tkq.dequantize_kv(zq, zs).abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_bitwise_jax(dtype):
    rng = np.random.default_rng(2)
    for scale in (1e-3, 1.0, 37.5):
        base = (rng.standard_normal((8, 16, 4, 64)) * scale).astype(np.float32)
        base[0, 0, 0] = 0.0  # a zero vector: scale 0
        x_t = torch.from_numpy(base).to(getattr(torch, dtype))
        x_j = jnp.asarray(base).astype(getattr(jnp, dtype))
        tq_, ts = tkq.quantize_kv(x_t)
        jq_, js = jkq.quantize_kv(x_j)
        assert np.array_equal(tq_.numpy(), np.asarray(jq_))
        assert np.array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
        for out in ("float32", "bfloat16"):
            td = tkq.dequantize_kv(tq_, ts, getattr(torch, out))
            jd = jkq.dequantize_kv(jq_, js, dtype=getattr(jnp, out))
            assert np.array_equal(td.float().numpy(), np.asarray(jd.astype(jnp.float32)))


def test_quantize_ties_round_half_to_even_like_jax():
    # absmax 127 gives scale exactly 1, so these products are exact ties.
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -2.5]], np.float32)
    tq_, ts = tkq.quantize_kv(torch.from_numpy(x))
    jq_, js = jkq.quantize_kv(jnp.asarray(x))
    assert float(ts[0]) == 1.0
    assert tq_.tolist() == [[127, 0, 2, 2, 0, -2, 126, -2]]
    assert np.array_equal(tq_.numpy(), np.asarray(jq_))


# --- K8's plain version ----------------------------------------------------


def test_plain_matches_jax_kernel_and_tracks_full_precision():
    rng = np.random.default_rng(2)
    N, bt, kvh, d, h, ntbl, bsz = 16, 8, 4, 16, 8, 8, 3
    k = rng.standard_normal((N, bt, kvh, d)).astype(np.float32)
    v = rng.standard_normal((N, bt, kvh, d)).astype(np.float32)
    q = rng.standard_normal((bsz, h, d)).astype(np.float32)
    tbls = np.stack([rng.permutation(N)[:ntbl] for _ in range(bsz)]).astype(np.int32)
    sls = np.array([1, 30, ntbl * bt], np.int32)
    jk, jv = jkq.quantize_kv(jnp.asarray(k)), jkq.quantize_kv(jnp.asarray(v))
    want = jkq._quant_decode_pallas(jnp.asarray(q), *jk, *jv, jnp.asarray(tbls),
                                    jnp.asarray(sls), interpret=True)
    tk, tv = tkq.quantize_kv(torch.from_numpy(k)), tkq.quantize_kv(torch.from_numpy(v))
    args = (torch.from_numpy(q), *tk, *tv, torch.from_numpy(tbls), torch.from_numpy(sls))
    got = tkq.paged_decode_attention_quantized(*args)
    assert torch.equal(got, tkq._quant_decode_plain(*args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # Against full precision: bounded by the int8 scheme, not exploding
    # through the softmax.
    full = paged_decode_attention_plain_batched(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tbls), torch.from_numpy(sls))
    assert float((got - full).abs().max()) < 5e-2


# K8 folds a row of n pages in about 8 splits of 4 to 16 pages on the card
# (csrc/kv_quant.cu): 4-page splits up to 32 pages, 16-page ones from 128
# up, a tree merge past 16 splits. Rows either side of those edges, at 2
# tokens a block: 1, 4, 5, 32, 33, 128, 129, 256 and 257 pages, a token short
# of some.
K8_EDGE_PAGES = (1, 4, 5, 32, 33, 128, 129, 256, 257)


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_across_k8_split_edges(qdtype):
    """The port's plain K8 (what the card's K8 is held against) against the
    JAX package's kernel in interpret mode, at rows that straddle K8's split
    edges, within the JAX package's own tolerance (1e-5 with f32 q; with
    bf16 q, one bf16 ulp of the output)."""
    rng = np.random.default_rng(11)
    bt, kvh, d, h = 2, 2, 16, 4
    lens = [p * bt - (i % 2) for i, p in enumerate(K8_EDGE_PAGES)] + [0]
    width = max(K8_EDGE_PAGES)
    n = width + 3
    k = (rng.standard_normal((n, bt, kvh, d)) * 2).astype(np.float32)
    v = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    q = rng.standard_normal((len(lens), h, d)).astype(np.float32)
    tbls = np.stack([rng.permutation(n)[:width] for _ in lens]).astype(np.int32)
    sls = np.array(lens, np.int32)
    jk, jv = jkq.quantize_kv(jnp.asarray(k)), jkq.quantize_kv(jnp.asarray(v))
    jq = jnp.asarray(q).astype(qdtype)
    want = jkq._quant_decode_pallas(jq, *jk, *jv, jnp.asarray(tbls), jnp.asarray(sls),
                                    interpret=True)
    tk, tv = tkq.quantize_kv(torch.from_numpy(k)), tkq.quantize_kv(torch.from_numpy(v))
    tq = torch.from_numpy(q).to(getattr(torch, qdtype))
    got = tkq.paged_decode_attention_quantized(tq, *tk, *tv, torch.from_numpy(tbls),
                                               torch.from_numpy(sls))
    assert got.dtype == tq.dtype and torch.all(got[-1] == 0)
    tol = 1e-5 if qdtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_plain_zero_row_and_bf16_query():
    rng = np.random.default_rng(3)
    k, v = (torch.from_numpy(rng.standard_normal((6, 8, 2, 64)).astype(np.float32))
            for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((2, 4, 64)).astype(np.float32))
    tk, tv = tkq.quantize_kv(k), tkq.quantize_kv(v)
    tbls = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    sls = torch.tensor([0, 11], dtype=torch.int32)
    out = tkq.paged_decode_attention_quantized(q.to(torch.bfloat16), *tk, *tv, tbls, sls)
    assert out.dtype == torch.bfloat16 and torch.all(out[0] == 0)
    ref = tkq.paged_decode_attention_quantized(q.to(torch.bfloat16).float(), *tk, *tv, tbls, sls)
    assert torch.equal(out, ref.to(torch.bfloat16))


# --- the store --------------------------------------------------------------


def test_store_roundtrip_half_bytes(tconn):
    qc = tkq.QuantizedKVConnector(tconn, SPEC, "quant-demo", max_blocks=4, device="cpu")
    tokens = list(range(16))  # 2 blocks
    caches = _quant_caches(3)
    src = np.array([3, 9], np.int32)
    assert asyncio.run(qc.save(tokens, caches, src)) == 2 * 2 * SPEC.num_layers
    assert qc.lookup(tokens) == 2
    dst = np.array([5, 0], np.int32)
    loaded, n = asyncio.run(qc.load(tokens, _fresh(), dst))
    assert n == 2
    _assert_quant_blocks_equal(caches, src, loaded, dst)
    for layer in range(SPEC.num_layers):
        for side in (0, 1):
            a = tkq.dequantize_kv(*caches[layer][side])[src.tolist()]
            b = tkq.dequantize_kv(*loaded[layer][side])[dst.tolist()]
            assert torch.equal(a, b)
    # Half the data bytes of the float cache per block, plus the scales.
    assert qc.data.spec.block_nbytes * 4 == SPEC.block_nbytes
    assert qc.scales.spec.block_nbytes * SPEC.head_dim == SPEC.block_nbytes
    # Drop removes BOTH key families (data + scales).
    assert qc.drop(tokens) == 2 * (2 * 2 * SPEC.num_layers)
    assert qc.lookup(tokens) == 0
    qc.close()


def test_scales_race_degrades_to_miss(tconn):
    """Data sentinel present but scales evicted: load must report 0 (the
    engine recomputes), never hand back data with garbage scales."""
    qc = tkq.QuantizedKVConnector(tconn, SPEC, "quant-race", max_blocks=4, device="cpu")
    tokens = list(range(16))
    asyncio.run(qc.save(tokens, _quant_caches(4), np.array([1, 2], np.int32)))
    assert qc.scales.drop(tokens) > 0  # the race, made deterministic
    _, n = asyncio.run(qc.load(tokens, _fresh(), np.array([4, 5], np.int32)))
    assert n == 0


def test_engine_harness_over_quantizing_adapter(tconn):
    """A float engine runs unmodified over the quantizing adapter: prefix
    hits come back as dequantized floats within the int8 scheme's tolerance
    (verify_tol), with real hits on wave two."""
    from infinistore_tpu_torch.engine import ContinuousBatchingHarness
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=128, block_tokens=8, dtype=torch.float32)
    # 4 prompt blocks + 1 generated block per request.
    qc = tkq.QuantizedKVConnector(tconn, cfg.kv_spec(5), "quant-engine", max_blocks=5,
                                  device="cpu")
    params = llama.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    h = ContinuousBatchingHarness(
        tkq.QuantizingKVAdapter(qc), params, cfg, num_blocks=16, max_req_blocks=5,
        verify=True, verify_tol=5e-2, device="cpu",
    )
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, size=4 * cfg.block_tokens).tolist()
               for _ in range(3)]

    async def drive():
        m1 = await h.run(prompts, concurrency=3)
        h.stats.clear()
        # Second wave also GENERATES: full hits + lockstep decode waves over
        # dequantized prefixes in one flow.
        m2 = await h.run(prompts, concurrency=3, gen_tokens=cfg.block_tokens)
        return m1, m2

    m1, m2 = asyncio.run(drive())
    assert m1["all_verified"], "first wave (compute + quantized save) diverged"
    assert m2["hit_rate"] == 1.0, "second wave should be served from the store"
    assert m2["all_verified"], "dequantized blocks exceeded the int8 tolerance"
    assert m2["generated_tokens"] == 3 * cfg.block_tokens
    assert m2["max_wave_size"] >= 2


def test_jax_saved_quantized_prefix_loads_in_port(conns):
    jconn, tconn = conns
    rng = np.random.default_rng(7)
    jcaches = [
        tuple(jkq.quantize_kv(jnp.asarray(rng.standard_normal(JSPEC.cache_shape),
                                          jnp.float32)) for _ in range(2))
        for _ in range(JSPEC.num_layers)
    ]
    tokens = list(range(300, 324))  # 3 blocks
    src = np.array([3, 7, 1], np.int32)
    saver = jkq.QuantizedKVConnector(jconn, JSPEC, "q-interop", max_blocks=4)
    assert asyncio.run(saver.save(tokens, jcaches, src)) == 3 * 2 * JSPEC.num_layers
    loader = tkq.QuantizedKVConnector(tconn, SPEC, "q-interop", max_blocks=4, device="cpu")
    assert loader.lookup(tokens) == 3
    dst = np.array([0, 12, 5], np.int32)
    loaded, n = asyncio.run(loader.load(tokens, _fresh(), dst))
    assert n == 3
    _assert_quant_blocks_equal(jcaches, src, loaded, dst)


def test_port_saved_quantized_prefix_loads_in_jax(conns):
    jconn, tconn = conns
    tcaches = _quant_caches(8)
    tokens = list(range(700, 732))  # 4 blocks
    src = np.array([15, 4, 8, 2], np.int32)
    saver = tkq.QuantizedKVConnector(tconn, SPEC, "q-interop-rev", max_blocks=4, device="cpu")
    assert asyncio.run(saver.save(tokens, tcaches, src)) == 4 * 2 * SPEC.num_layers
    loader = jkq.QuantizedKVConnector(jconn, JSPEC, "q-interop-rev", max_blocks=4)
    assert loader.lookup(tokens) == 4
    fresh = [
        ((jnp.zeros(JSPEC.cache_shape, jnp.int8), jnp.zeros(JSPEC.cache_shape[:-1])),
         (jnp.zeros(JSPEC.cache_shape, jnp.int8), jnp.zeros(JSPEC.cache_shape[:-1])))
        for _ in range(JSPEC.num_layers)
    ]
    dst = np.array([6, 0, 11, 9], np.int32)
    loaded, n = asyncio.run(loader.load(tokens, fresh, dst))
    assert n == 4
    _assert_quant_blocks_equal(tcaches, src, loaded, dst)


def test_manifest_lists_scales_first_like_jax():
    port = tkq.QuantizedKVConnector(None, SPEC, "q-man", max_blocks=4, device="cpu")
    jax_conn = jkq.QuantizedKVConnector(None, JSPEC, "q-man", max_blocks=4)
    tokens = list(range(40))
    got = port.manifest(tokens)
    assert got == jax_conn.manifest(tokens)
    assert [size for size, _ in got] == [SPEC.block_tokens * SPEC.num_kv_heads * 4,
                                         SPEC.block_tokens * SPEC.num_kv_heads * SPEC.head_dim]
    assert got[-1][1][-1].startswith("q-man/q8/L0/k/")  # the data sentinel is last


@pytest.mark.parametrize("failing", ["data", "scales"])
def test_partial_read_error_carries_the_zipped_structure(failing):
    qc = tkq.QuantizedKVConnector(None, SPEC, "q-partial", max_blocks=4, device="cpu")
    caches = _fresh()
    cause = tlib.InfiniStoreException("transport died")

    async def data_load(token_ids, data_caches, block_ids, first_block=0):
        if failing == "data":
            raise PartialReadError(list(data_caches), cause)
        return list(data_caches), 2

    async def scales_load(token_ids, scale_caches, block_ids, first_block=0, on_layer=None):
        raise PartialReadError(list(scale_caches), cause)

    qc.data.load, qc.scales.load = data_load, scales_load
    with pytest.raises(PartialReadError) as info:
        asyncio.run(qc.load(list(range(16)), caches, np.array([0, 1], np.int32)))
    assert info.value.cause is cause
    for layer, ((kq, ks), (vq, vs)) in enumerate(info.value.caches):
        assert kq is caches[layer][0][0] and vq is caches[layer][1][0]
        assert tuple(ks.shape) == tuple(SPEC.cache_shape[:-1])
        # The scale planes are views: the scatter writes the caller's scales.
        assert ks.data_ptr() == caches[layer][0][1].data_ptr()
        assert vs.data_ptr() == caches[layer][1][1].data_ptr()


# --- layer-streamed saves ----------------------------------------------------


def test_stage_layer_save_validates_first_block():
    """stage_layer_save applies the same first_block bounds contract as
    save()/load(): out of range raises instead of a silent no-op ship."""
    spec = PagedKVCacheSpec(*GEOM, torch.bfloat16)
    connector = KVConnector(None, spec, "demo-llama", max_blocks=8, device="cpu")
    tokens = list(range(16))  # 2 complete blocks
    kv_pair = spec.make_caches("cpu")[0]
    ids = np.array([0, 1], dtype=np.int32)
    with pytest.raises(ValueError, match="first_block"):
        connector.stage_layer_save(tokens, 0, kv_pair, ids, first_block=3)
    with pytest.raises(ValueError, match="first_block"):
        connector.stage_layer_save(tokens, 0, kv_pair, ids, first_block=-1)
    # The boundary value (== block count) is legal: an empty-span no-op.
    ship = connector.stage_layer_save(tokens, 0, kv_pair, ids, first_block=2)
    assert asyncio.run(ship()) == 0


def test_stage_layer_save_streams_a_loadable_prefix(conns):
    """Layers staged one by one (layer 0 shipped last) make a prefix the
    JAX connector loads byte for byte."""
    from infinistore_tpu.connector import KVConnector as JaxKVConnector

    jconn, tconn = conns
    spec = PagedKVCacheSpec(*GEOM, torch.bfloat16)
    rng = np.random.default_rng(9)
    caches = [tuple(torch.from_numpy(rng.standard_normal(spec.cache_shape).astype(np.float32))
                    .to(torch.bfloat16) for _ in range(2)) for _ in range(spec.num_layers)]
    tokens = list(range(50, 74))  # 3 blocks
    src = np.array([2, 11, 5], np.int32)
    saver = KVConnector(tconn, spec, "staged", max_blocks=4, device="cpu")

    async def stream():
        ships = [saver.stage_layer_save(tokens, layer, caches[layer], src)
                 for layer in range(spec.num_layers)]
        written = 0
        for ship in ships[1:] + ships[:1]:  # layer 0 (the sentinel) last
            written += await ship()
        return written

    assert asyncio.run(stream()) == 3 * 2 * spec.num_layers
    loader = JaxKVConnector(jconn, JaxSpec(*GEOM, jnp.bfloat16), "staged", 4)
    assert loader.lookup(tokens) == 3
    dst = np.array([0, 7, 3], np.int32)
    loaded, n = asyncio.run(loader.load(tokens, JaxSpec(*GEOM, jnp.bfloat16).make_caches(),
                                        dst))
    assert n == 3
    for layer in range(spec.num_layers):
        for kind in (0, 1):
            assert _block_bytes(caches[layer][kind], src) == _block_bytes(
                loaded[layer][kind], dst)


def test_quantized_layer_streamed_save_ships_data_sentinel_last(tconn):
    qc = tkq.QuantizedKVConnector(tconn, SPEC, "q-staged", max_blocks=4, device="cpu")
    caches = _quant_caches(10)
    tokens = list(range(16))  # 2 blocks
    src = np.array([4, 6], np.int32)
    order = []
    orig = tconn.write_cache_async

    async def spy(blocks, block_size, ptr, **kw):
        order.extend(k for k, _ in blocks)
        return await orig(blocks, block_size, ptr, **kw)

    tconn.write_cache_async = spy

    async def stream():
        ships = [qc.stage_layer_save(tokens, layer, caches[layer], src)
                 for layer in range(SPEC.num_layers)]
        for ship in ships[1:] + ships[:1]:
            await ship()

    try:
        asyncio.run(stream())
    finally:
        tconn.write_cache_async = orig
    plane = [("q8s" if "/q8s/" in k else "q8", k.split("/")[2]) for k in order]
    # Per layer, every scale key before any data key; layer 0 last; the data
    # plane's layer-0 K keys (the lookup sentinel) among the very last.
    assert plane == sorted(plane, key=lambda p: (p[1] == "L0", p[0] == "q8"))
    assert all(k.startswith("q-staged/q8/L0/") for k in order[-4:])
    assert qc.lookup(tokens) == 2
    loaded, n = asyncio.run(qc.load(tokens, _fresh(), np.array([0, 1], np.int32)))
    assert n == 2
    _assert_quant_blocks_equal(caches, src, loaded, np.array([0, 1]))
    qc.close()


# --- chip_smoke.py's int8 phases, rehearsed at a tiny width ------------------


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_int8_round_trip_rehearsal_on_cpu(port_server):
    """``chip_smoke.py``'s int8 round trip (quantise the main path's
    prefixes, save, look up, load into other block ids byte for byte, K8's
    plain version per layer bitwise over the dequantised cache) on the CPU
    at a tiny geometry."""
    chip_smoke = _chip_smoke()
    geometry = dict(vocab=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=256,
                    block_tokens=16, rope_theta=500000.0)
    metrics, _, _, state = chip_smoke.main_path(
        torch, port_server.port, device="cpu", geometry=geometry, prompt_tokens=64)
    got, launches = chip_smoke.int8_round_trip(torch, port_server.port, state, metrics)
    assert set(launches.values()) == {0}  # the CPU runs the plain versions
    per_pair = 16 * 2 * 64 + 16 * 2 * 4  # int8 data + f32 scales of one block side
    assert got["kv_bytes_moved"] == chip_smoke.PROMPTS * 4 * 2 * 2 * per_pair
    assert 0 < got["max_abs_err_vs_bf16_cache"] < 0.1


def test_chip_smoke_int8_engine_rounds_rehearsal_on_cpu():
    """``chip_smoke.py``'s int8 engine phase: the engine rounds through
    ``QuantizingKVAdapter``, round 2 verified within the tolerance derived
    from the int8 scheme, on the CPU at a tiny width."""
    from infinistore_tpu_torch.models import llama

    chip_smoke = _chip_smoke()
    cfg = llama.LlamaConfig(vocab=1000, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=128, block_tokens=16, dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    srv = tlib.start_local_server(prealloc_bytes=128 << 20, block_bytes=16 << 10)
    try:
        results, h, store = chip_smoke._run_engine(
            torch, srv.port, params, cfg, "cpu", "rehearsal-q8", chip_smoke.ENGINE,
            chip_smoke.ENGINE_BLOCKS, chip_smoke.ENGINE_REQ_BLOCKS, 2e-4, quantized=True)
    finally:
        srv.stop()
    chip_smoke._check_rounds(results, chip_smoke.ENGINE, cfg.block_tokens, "rehearsal")
    assert results[0][0]["computed_blocks"] == 4 * 64
    assert results[1][0]["loaded_blocks"] == 4 * 48
    absmax = max(float(c.abs().max()) for pair in h.caches for c in pair)
    assert 2e-4 < h.verify_tol <= 2e-4 + 2 * absmax / 127 + 1e-12
    # Data and scale keys (K and V, every layer) of at least round 1's blocks.
    assert store["keys"] >= 4 * 64 * cfg.n_layers * 2 * 2
