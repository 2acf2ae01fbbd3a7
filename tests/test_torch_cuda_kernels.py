"""The port's CUDA kernels against their plain PyTorch versions on the card,
over the edge cases the main path does not reach: unaligned blocks and
out-of-range ids (K1/K2), every supported head_dim and GQA group, padded
and over-long tables, zero-length rows (K3, and K6 over a ragged wave with
pad pages, held bitwise against K3 row by row), ragged query tiles, full
attention over a longer context and batch > 1 (K4); plus the layerwise
writer/reader round trip through pinned staging on the card and one engine
wave against sequential decode (within the engine's stated tolerance).

Needs an NVIDIA GPU and nvcc; skipped elsewhere (the decision is taken in
a fixture, never at import). On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import asyncio

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(seed, shape, dtype, dev):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float32).to(device=dev, dtype=dtype)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("shape", [(40, 16, 8, 128), (33, 3, 1, 5)], ids=["vec16", "bytes"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_scatter_bitwise(dev, shape, dtype):
    from infinistore_tpu_torch.cuda import paged

    cache = _randn(1, shape, dtype, dev)
    ids = torch.tensor([7, 0, 32, 2, 19], dtype=torch.int32, device=dev)
    assert torch.equal(paged.gather_blocks(cache, ids), paged.gather_blocks_plain(cache, ids))
    blocks = _randn(2, (5, *shape[1:]), dtype, dev)
    got = paged.scatter_blocks(cache.clone(), ids, blocks)
    assert torch.equal(got, paged.scatter_blocks_plain(cache.clone(), ids, blocks))


def test_scatter_skips_out_of_range_ids(dev):
    from infinistore_tpu_torch.cuda import paged

    cache = _randn(3, (8, 4, 2, 64), torch.bfloat16, dev)
    before = cache.clone()
    blocks = _randn(4, (2, 4, 2, 64), torch.bfloat16, dev)
    paged.scatter_blocks(cache, torch.tensor([3, 99], dtype=torch.int32, device=dev), blocks)
    torch.cuda.synchronize()
    assert torch.equal(cache[3], blocks[0])
    keep = [i for i in range(8) if i != 3]
    assert torch.equal(cache[keep], before[keep])


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 4), (16, 4), (32, 4)], ids=["g1", "g2", "g4", "g8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_matches_plain(dev, d, h, kvh, dtype):
    from infinistore_tpu_torch.cuda import paged_attention as pa

    bt, n, max_blocks = 16, 40, 9
    q = _randn(5, (6, h, d), dtype, dev)
    kc = _randn(6, (n, bt, kvh, d), dtype, dev)
    vc = _randn(7, (n, bt, kvh, d), dtype, dev)
    g = torch.Generator().manual_seed(8)
    tables = torch.stack([torch.randperm(n, generator=g)[:max_blocks] for _ in range(6)])
    tables = tables.to(device=dev, dtype=torch.int32)
    # Zero, one token, a block boundary, partial, full table, past the table.
    lens = torch.tensor([0, 1, bt, 3 * bt + 5, max_blocks * bt, max_blocks * bt + 50],
                        dtype=torch.int32, device=dev)
    got = pa.paged_decode_attention_batched(q, kc, vc, tables, lens)
    want = pa.paged_decode_attention_plain_batched(q, kc, vc, tables, lens.clamp(max=max_blocks * bt))
    assert _err(got, want) <= TOL[dtype]
    assert torch.all(got[0] == 0)


def test_paged_decode_ignores_padding_and_rejects_shapes(dev):
    from infinistore_tpu_torch.cuda import paged_attention as pa

    q = _randn(9, (1, 8, 128), torch.bfloat16, dev)
    kc = _randn(10, (8, 16, 2, 128), torch.bfloat16, dev)
    vc = _randn(11, (8, 16, 2, 128), torch.bfloat16, dev)
    lens = torch.tensor([20], dtype=torch.int32, device=dev)
    a = pa.paged_decode_attention_batched(q, kc, vc, torch.tensor([[2, 5, 0, 0]], dtype=torch.int32, device=dev), lens)
    b = pa.paged_decode_attention_batched(q, kc, vc, torch.tensor([[2, 5, 7, 1]], dtype=torch.int32, device=dev), lens)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_decode_attention_batched(q[..., :96].contiguous(), kc[..., :96].contiguous(),
                                          vc[..., :96].contiguous(),
                                          torch.zeros((1, 2), dtype=torch.int32, device=dev), lens)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_decode_attention_batched(q.transpose(1, 2).contiguous().transpose(1, 2), kc, vc,
                                          torch.zeros((1, 2), dtype=torch.int32, device=dev), lens)


@pytest.mark.parametrize("s", [1, 37, 64, 100, 200])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_causal_matches_plain(dev, s, d, dtype):
    from infinistore_tpu_torch.cuda import flash_prefill as fp

    q = _randn(12, (2, s, 8, d), dtype, dev)
    k = _randn(13, (2, s, 2, d), dtype, dev)
    v = _randn(14, (2, s, 2, d), dtype, dev)
    got = fp.flash_prefill_attention(q, k, v, causal=True)
    assert _err(got, fp.flash_prefill_plain(q, k, v, causal=True)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_full_attention_over_longer_context(dev, dtype):
    from infinistore_tpu_torch.cuda import flash_prefill as fp

    q = _randn(15, (1, 70, 4, 64), dtype, dev)
    k = _randn(16, (1, 150, 4, 64), dtype, dev)
    v = _randn(17, (1, 150, 4, 64), dtype, dev)
    got = fp.flash_prefill_attention(q, k, v, causal=False)
    assert _err(got, fp.flash_prefill_plain(q, k, v, causal=False)) <= TOL[dtype]


@pytest.mark.parametrize("enable_shm", [True, False], ids=["shm", "socket"])
def test_layerwise_roundtrip_through_pinned_staging(dev, enable_shm):
    from infinistore_tpu_torch import config, lib
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda.layerwise import LayerwiseKVReader, LayerwiseKVWriter, kv_block_key
    from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec
    from infinistore_tpu_torch.cuda.staging import HostStagingPool

    spec = PagedKVCacheSpec(3, 24, 16, 8, 128, torch.bfloat16)
    caches = [(_randn(20 + i, spec.cache_shape, spec.dtype, dev),
               _randn(40 + i, spec.cache_shape, spec.dtype, dev)) for i in range(3)]
    srv = lib.start_local_server(prealloc_bytes=64 << 20, block_bytes=32 << 10)
    conn = lib.InfinityConnection(config.ClientConfig(
        host_addr="127.0.0.1", service_port=srv.port, log_level="error", enable_shm=enable_shm))
    conn.connect()
    pool = HostStagingPool(12 * 6 * spec.block_nbytes, spec.block_nbytes, conn=conn, device=dev)
    try:
        src = np.array([3, 9, 0, 17, 22, 12], np.int32)
        dst = np.array([1, 2, 5, 8, 13, 21], np.int32)

        def key_fn(layer, kind, i):
            return kv_block_key("cuda-test", "h", layer, kind, i)

        before = dict(_ext.LAUNCHES)
        writer = LayerwiseKVWriter(conn, pool, spec, max_blocks=6)
        assert asyncio.run(writer.write(caches, src, key_fn)) == 2 * 3 * 6
        reader = LayerwiseKVReader(conn, pool, spec, max_blocks=6)
        out = asyncio.run(reader.read(spec.make_caches(dev), dst, key_fn))
        torch.cuda.synchronize()
        for layer in range(3):
            for kind in (0, 1):
                assert torch.equal(out[layer][kind][dst.tolist()], caches[layer][kind][src.tolist()])
        assert _ext.LAUNCHES["gather_blocks"] - before["gather_blocks"] == 6
        assert _ext.LAUNCHES["scatter_blocks"] - before["scatter_blocks"] == 6
    finally:
        pool.close()
        conn.close()
        srv.stop()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 4), (16, 4), (32, 4)], ids=["g1", "g2", "g4", "g8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_decode_matches_plain_and_k3_bitwise(dev, d, h, kvh, dtype):
    """K6 over a wave of zero, partial, full and over-long rows (an
    over-long row asks for more tokens than its slice of the flat list
    holds; both versions stop at its own pages), with a verification chunk
    sharing its pages and pow2 pad pages: within tolerance of the plain
    version, and bitwise K3 on each row's rebuilt table."""
    from infinistore_tpu_torch.cuda import paged_attention as pa

    bt, n, width = 16, 40, 6
    g = torch.Generator().manual_seed(18)
    kc = _randn(19, (n, bt, kvh, d), dtype, dev)
    vc = _randn(20, (n, bt, kvh, d), dtype, dev)
    tables = [torch.randperm(n, generator=g)[:width].numpy() for _ in range(3)]
    row_tables = [tables[0], tables[1], tables[1], tables[1], tables[2], tables[2]]
    lens = [0, 3 * bt + 5, 3 * bt + 6, 3 * bt + 7, width * bt, bt]
    m = pa.build_ragged_wave(row_tables, lens, bt, pad_to_pow2=True)
    assert m.pad_pages > 0
    meta = [torch.from_numpy(x).to(dev) for x in (m.pages, m.page_rows, m.page_starts)]
    q = _randn(21, (len(lens), h, d), dtype, dev)
    for over_long in (False, True):
        sl = np.array(lens, np.int32)
        if over_long:
            sl[-1] = 4 * bt  # the last row owns 1 real page + pads
            sl[1] = 5 * bt  # row 1 owns 4 pages
        seq = torch.from_numpy(sl).to(dev)
        got = pa.paged_decode_attention_ragged(q, kc, vc, meta[0], meta[1], meta[2], seq,
                                               table_width=width)
        want = pa.paged_decode_attention_ragged_plain(q, kc, vc, meta[0], meta[2], seq, width)
        torch.cuda.synchronize()
        assert _err(got, want) <= TOL[dtype], over_long
        assert torch.all(got[0] == 0)
        rows = pa._ragged_row_tables(meta[0], meta[2], width).contiguous()
        owned = pa._owned_tokens(meta[0], meta[2]) * bt
        k3 = pa.paged_decode_attention_batched(
            q, kc, vc, rows, torch.minimum(seq.long(), owned).to(torch.int32))
        assert torch.equal(got, k3), over_long


def test_ragged_row_does_not_depend_on_its_wave(dev):
    from infinistore_tpu_torch.cuda import paged_attention as pa

    bt, n, h, kvh, d = 16, 64, 32, 8, 128
    kc = _randn(22, (n, bt, kvh, d), torch.bfloat16, dev)
    vc = _randn(23, (n, bt, kvh, d), torch.bfloat16, dev)
    q = _randn(24, (4, h, d), torch.bfloat16, dev)
    tables = [np.arange(i * 16, i * 16 + 16) for i in range(4)]
    lens = [1, 200, 17, 255]
    m = pa.build_ragged_wave(tables, lens, bt, pad_to_pow2=True)
    wave = pa.paged_decode_attention_ragged(q, kc, vc, m.pages, m.page_rows, m.page_starts,
                                            m.seq_lens, table_width=16)
    for r in range(4):
        solo = pa.build_ragged_wave([tables[r]], [lens[r]], bt)
        one = pa.paged_decode_attention_ragged(q[r:r + 1].contiguous(), kc, vc, solo.pages,
                                               solo.page_rows, solo.page_starts, solo.seq_lens,
                                               table_width=16)
        torch.cuda.synchronize()
        assert torch.equal(one[0], wave[r]), r


def test_engine_wave_matches_sequential_on_the_card(dev):
    """A mixed wave (two decode rows beside a 3-token verification chunk)
    through the engine's WaveDecoder against each request alone: logits and
    cache values within the engine's stated tolerance (1e-5, f32)."""
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.engine import ContinuousBatchingHarness, DeviceGate, WaveDecoder
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab=128, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=256, block_tokens=8, dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(61)
    tables = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]], np.int32)
    base = cfg.kv_spec(16).make_caches(device=dev)
    for tab in tables:
        _, base = llama.prefill(params, rng.integers(0, cfg.vocab, 16).tolist(), base, tab[:2], cfg)
    chunks = [([5], [16]), ([9, 11, 12], [16, 17, 18]), ([13], [16])]

    def harness():
        h = ContinuousBatchingHarness.__new__(ContinuousBatchingHarness)
        h.params, h.config, h.max_req_blocks, h.gate = params, cfg, 4, DeviceGate()
        h.caches = [(k.clone(), v.clone()) for k, v in base]
        return h

    async def wave_run():
        h = harness()
        wave = WaveDecoder(h)
        outs = await asyncio.gather(*(wave.step_chunk(t, p, tables[b])
                                      for b, (t, p) in enumerate(chunks)))
        return outs, h.caches, wave

    async def seq_run():
        h = harness()
        outs = [await WaveDecoder(h).step_chunk(t, p, tables[b]) for b, (t, p) in enumerate(chunks)]
        return outs, h.caches

    before = _ext.LAUNCHES["paged_decode_attention_ragged"]
    w_outs, w_caches, wave = asyncio.run(wave_run())
    s_outs, s_caches = asyncio.run(seq_run())
    torch.cuda.synchronize()
    assert wave.max_wave == 3
    assert _ext.LAUNCHES["paged_decode_attention_ragged"] - before == 4 * cfg.n_layers
    for a, b in zip(w_outs, s_outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for (wk, wv), (sk, sv) in zip(w_caches, s_caches):
        torch.testing.assert_close(wk, sk, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(wv, sv, rtol=1e-5, atol=1e-5)
