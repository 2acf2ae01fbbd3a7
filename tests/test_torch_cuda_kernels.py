"""The port's CUDA kernels against their plain PyTorch versions on the card,
over the edge cases the main path does not reach: unaligned blocks and
out-of-range ids (K1/K2), every supported head_dim and GQA group, padded
and over-long tables, zero-length rows (K3), ragged query tiles, full
attention over a longer context and batch > 1 (K4); plus the layerwise
writer/reader round trip through pinned staging on the card.

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
