"""The port's CUDA kernels against their plain PyTorch versions on the card,
over the edge cases the main path does not reach: unaligned blocks and
out-of-range ids on both routes, and blocks at the TMA bulk ring's chunk
and stage edges, over one cache and many (K1/K2), every supported
head_dim (8, 16, 32, 64, 80, 96, 128, 256) and GQA group (1, 2, 4, 8, and 3
and 7), the JAX package's own kernel cases (the model tests' head_dim 8
among them), padded and over-long tables, zero-length rows
(K3, and K6 over a ragged wave with pad pages, held bitwise against K3 row by row), ragged query tiles, full
attention over a longer context and batch > 1 (K4: its bf16 tensor-core
kernel at every 128-row tile edge, GQA group 1 and 4, and on inputs where
one leaked or dropped key would move the output by order 1; its f32 path
on the CUDA cores, each counted by its own counter; both bodies at every
head_dim, prompts of 200 and 2,047 tokens, 1 and 4 prompts, groups 1, 2,
4, 8 and 7, causal and full; bf16 at head_dim 256, whose heaviest query
tiles are split over keys and merged, bitwise across launches and each
prompt bitwise its solo launch, its merge workspace sized by the wrapper's
plan and its tickets left zero; f32 inputs off a 16-byte boundary); the split-KV decode
fold of K3, K5-K7 at and around every split edge (rows of 0 and 1 tokens,
one split less, equal and more by a token, several splits, rows merged in
the tree of more than 16 splits) and, with K8, at every launch split count
from 1 to 16 and two past it, with tables padded by out-of-range ids and
every bitwise contract (two launches, K6 == K3 per row, solo == wave, K5/K7's
one-shard combine == K3/K6, tickets left zero); K8's own fold at and around
its split edges, held to the JAX package's contract (within 1e-5 with f32
q, 2e-2 with bf16 q, of its plain version and of K3 over the dequantised
cache) with two launches bitwise equal and each row bitwise its solo
launch; plus the layerwise writer/reader round trip through pinned staging
on the card, one engine wave against sequential decode (within the
engine's stated tolerance), and the overlapped prefill -> decode handoff
(``disagg``) at a small f32 width: bitwise the local recompute on the card,
within 2e-4 of the same legs on the CPU.

Needs an NVIDIA GPU and nvcc; skipped elsewhere (the decision is taken in
a fixture, never at import). On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import asyncio
import os

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
# Query heads a KV head: 1, 2, 4 and 8 (the kernels' own groups), 3 and 7
# (folded as 3 and 7 virtual KV heads of one query head each), over 4 and
# over 2 KV heads.
# Every head_dim the attention kernels take (``_ext.HEAD_DIMS``, written out:
# the module decides its tests without importing the package).
HEAD_DIMS = [8, 16, 32, 64, 80, 96, 128, 256]
GROUP_IDS = ["g1", "g2", "g4", "g8", "g3", "g7"]
GROUPS4 = [(4 * g, 4) for g in (1, 2, 4, 8, 3, 7)]
GROUPS2 = [(2 * g, 2) for g in (1, 2, 4, 8, 3, 7)]


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


# Blocks at the bulk ring's chunk edges (a chunk is 16 or 32 KiB): exactly
# one chunk, a chunk and 16 bytes (a 16-byte tail chunk), the 512 B scale
# block, the 16 KiB int8 block, the 64 KiB f32 block.
COPY_BLOCKS = {
    "16KiB-bf16": ((16, 8, 64), torch.bfloat16),
    "16KiB+16": ((8200,), torch.bfloat16),
    "32KiB-bf16": ((16, 8, 128), torch.bfloat16),
    "32KiB+16": ((16392,), torch.bfloat16),
    "512B-scales": ((16, 8, 1), torch.float32),
    "16KiB-int8": ((16, 8, 128), torch.int8),
    "64KiB-f32": ((16, 8, 128), torch.float32),
}


def _draw(seed, shape, dtype, dev):
    if dtype is torch.int8:
        g = torch.Generator().manual_seed(seed)
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(dev)
    return _randn(seed, shape, dtype, dev)


def _copy_counts():
    from infinistore_tpu_torch.cuda import _ext

    return {k: v for k, v in _ext.LAUNCHES.items() if "blocks" in k}


def _delta(before):
    return {k: v - before[k] for k, v in _copy_counts().items()}


@pytest.mark.parametrize("count", [1, 2, 5])
@pytest.mark.parametrize("block", list(COPY_BLOCKS))
def test_many_bitwise_at_chunk_edges(dev, block, count):
    from infinistore_tpu_torch.cuda import paged

    shape, dtype = COPY_BLOCKS[block]
    caches = [_draw(100 + c, (40, *shape), dtype, dev) for c in range(count)]
    ids = torch.tensor([7, 0, 32, 2, 19, 39], dtype=torch.int32, device=dev)
    before = _copy_counts()
    got = paged.gather_blocks_many(caches, ids)
    assert torch.equal(got, paged.gather_blocks_many_plain(caches, ids))
    blocks = _draw(200, (count * 6, *shape), dtype, dev)
    mine = paged.scatter_blocks_many([c.clone() for c in caches], ids, blocks)
    theirs = paged.scatter_blocks_many_plain([c.clone() for c in caches], ids, blocks)
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    parts = [blocks[c * 6:(c + 1) * 6].clone() for c in range(count)]
    mine = paged.scatter_blocks_many([c.clone() for c in caches], ids, parts)
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    torch.cuda.synchronize()
    assert _delta(before) == {"gather_blocks": 1, "gather_blocks_bulk": 1,
                              "scatter_blocks": 2, "scatter_blocks_bulk": 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_many_bitwise_with_more_items_than_ctas_times_stages(dev, dtype):
    """8,192 items and more (4 caches x 1,024 blocks of 32 or 64 KiB): every
    CTA walks many items and refills each stage many times."""
    from infinistore_tpu_torch.cuda import paged

    caches = [_randn(300 + c, (1100, 16, 8, 128), dtype, dev) for c in range(4)]
    ids = torch.randperm(1100, generator=torch.Generator().manual_seed(5))[:1024]
    ids = ids.to(device=dev, dtype=torch.int32)
    got = paged.gather_blocks_many(caches, ids)
    assert torch.equal(got, paged.gather_blocks_many_plain(caches, ids))
    blocks = got.flip(0).contiguous()
    mine = paged.scatter_blocks_many([c.clone() for c in caches], ids, blocks)
    theirs = paged.scatter_blocks_many_plain([c.clone() for c in caches], ids, blocks)
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))


def test_many_splits_65_caches_into_two_launches(dev):
    from infinistore_tpu_torch.cuda import paged

    caches = [_randn(400 + c, (12, 16, 8, 16), torch.bfloat16, dev) for c in range(65)]
    ids = torch.tensor([11, 3, 0], dtype=torch.int32, device=dev)
    before = _copy_counts()
    got = paged.gather_blocks_many(caches, ids)
    assert torch.equal(got, paged.gather_blocks_many_plain(caches, ids))
    blocks = got.roll(1, 0)
    mine = paged.scatter_blocks_many([c.clone() for c in caches], ids, blocks)
    theirs = paged.scatter_blocks_many_plain([c.clone() for c in caches], ids, blocks)
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    assert _delta(before) == {"gather_blocks": 2, "gather_blocks_bulk": 2,
                              "scatter_blocks": 2, "scatter_blocks_bulk": 2}


@pytest.mark.parametrize("route", ["bulk", "vector", "bytes"])
def test_out_of_range_ids_are_left_unwritten_on_both_routes(dev, route):
    """Ids -1 and num_blocks: the scatter leaves every cache block it does
    not name as it was, and the gather's in-range rows are right. The
    vector kernel is reached by a cache 2 bytes off a 16-byte boundary
    (``vector``) or a 60-byte block (``bytes``)."""
    from infinistore_tpu_torch.cuda import paged

    shape = (10, 15) if route == "bytes" else (10, 16, 8, 128)
    dtype = torch.float32 if route == "bytes" else torch.bfloat16
    caches = [_randn(500 + c, shape, dtype, dev) for c in range(2)]
    if route == "vector":
        shifted = torch.empty(caches[1].numel() + 1, dtype=dtype, device=dev)[1:].view(shape)
        shifted.copy_(caches[1])
        caches[1] = shifted
    ids = torch.tensor([4, -1, 10, 0], dtype=torch.int32, device=dev)
    before = _copy_counts()
    got = paged.gather_blocks_many(caches, ids)
    for c in range(2):
        assert torch.equal(got[c * 4], caches[c][4])
        assert torch.equal(got[c * 4 + 3], caches[c][0])
    blocks = _randn(600, (8, *shape[1:]), dtype, dev)
    olds = [c.clone() for c in caches]
    paged.scatter_blocks_many(caches, ids, blocks)
    torch.cuda.synchronize()
    keep = [i for i in range(10) if i not in (4, 0)]
    for c in range(2):
        assert torch.equal(caches[c][4], blocks[c * 4])
        assert torch.equal(caches[c][0], blocks[c * 4 + 3])
        assert torch.equal(caches[c][keep], olds[c][keep])
    bulk = int(route == "bulk")
    assert _delta(before) == {"gather_blocks": 1, "gather_blocks_bulk": bulk,
                              "scatter_blocks": 1, "scatter_blocks_bulk": bulk}


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("h,kvh", GROUPS4, ids=GROUP_IDS)
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
    # A head_dim outside _ext.HEAD_DIMS is refused.
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_decode_attention_batched(q[..., :72].contiguous(), kc[..., :72].contiguous(),
                                          vc[..., :72].contiguous(),
                                          torch.zeros((1, 2), dtype=torch.int32, device=dev), lens)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_decode_attention_batched(q.transpose(1, 2).contiguous().transpose(1, 2), kc, vc,
                                          torch.zeros((1, 2), dtype=torch.int32, device=dev), lens)


@pytest.mark.parametrize("s", [1, 37, 64, 100, 200])
@pytest.mark.parametrize("d", HEAD_DIMS)
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


def _k4_launch(fp, q, k, v, causal):
    """One K4 call on bf16 inputs, which must go through the tensor-core
    kernel: both counters move by one."""
    from infinistore_tpu_torch.cuda import _ext

    before = dict(_ext.LAUNCHES)
    got = fp.flash_prefill_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["flash_prefill"] == before["flash_prefill"] + 1
    assert _ext.LAUNCHES["flash_prefill_wgmma"] == before["flash_prefill_wgmma"] + 1
    return got


# Query-tile (128 rows) and key-tile (128 keys) edges, the engine's and the
# main path's prompt lengths.
@pytest.mark.parametrize("s", [1, 63, 64, 127, 128, 129, 1000, 1024, 2048])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("group", [1, 4], ids=["g1", "g4"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_prefill_wgmma_causal_matches_plain(dev, s, b, group, d):
    from infinistore_tpu_torch.cuda import flash_prefill as fp

    kvh = 2
    q = _randn(30, (b, s, kvh * group, d), torch.bfloat16, dev)
    k = _randn(31, (b, s, kvh, d), torch.bfloat16, dev)
    v = _randn(32, (b, s, kvh, d), torch.bfloat16, dev)
    got = _k4_launch(fp, q, k, v, True)
    assert _err(got, fp.flash_prefill_plain(q, k, v, causal=True)) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("s,t", [(1, 300), (70, 150), (129, 1000), (300, 2100)])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_prefill_wgmma_full_attention_matches_plain(dev, s, t, d):
    from infinistore_tpu_torch.cuda import flash_prefill as fp

    q = _randn(33, (2, s, 8, d), torch.bfloat16, dev)
    k = _randn(34, (2, t, 2, d), torch.bfloat16, dev)
    v = _randn(35, (2, t, 2, d), torch.bfloat16, dev)
    got = _k4_launch(fp, q, k, v, False)
    assert _err(got, fp.flash_prefill_plain(q, k, v, causal=False)) <= TOL[torch.bfloat16]


def _rising_keys(b, s, t, h, kvh, d, dev):
    """Inputs whose logit rises by 256 / sqrt(d) (at least 22) from each key
    to the next, for every query: q . k_t = 256 t - 2^20, exact in bf16
    operands and f32 sums (k_t = [t // 256, t % 256, 1, 0, ...], q = [2^16,
    2^8, -2^20, 0, ...]). So every row's output is, to bf16, the value of the
    last key it may see, and one leaked or dropped key moves it to a
    neighbour's random value: a change of order 1 against the 2e-2
    tolerance. Real logits are negative, so a key read past T (zero-filled)
    would win with logit 0 and give 0. Values are N(0, 1/16), below 2 in
    size, where a bf16 step is 2^-7: the kernel's exponent (up to 2^20 /
    sqrt(d) in size, rounded in f32) and its bf16 probabilities put the
    output within 0.004 of the winning key's value, and within 2e-2 after
    the output's own rounding."""
    pos = torch.arange(t, dtype=torch.float32)
    k = torch.zeros((b, t, kvh, d))
    k[..., 0] = (pos // 256)[None, :, None]
    k[..., 1] = (pos % 256)[None, :, None]
    k[..., 2] = 1.0
    q = torch.zeros((b, s, h, d))
    q[..., 0], q[..., 1], q[..., 2] = 2.0 ** 16, 2.0 ** 8, -(2.0 ** 20)
    v = (0.25 * _randn(36, (b, t, kvh, d), torch.float32, dev)).to(torch.bfloat16)
    return q.to(dev, torch.bfloat16), k.to(dev, torch.bfloat16), v


@pytest.mark.parametrize("s,t,causal", [(127, 127, True), (129, 129, True), (1000, 1000, True),
                                        (2048, 2048, True), (129, 1000, False),
                                        (300, 2100, False)])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_prefill_wgmma_mask_is_exact(dev, s, t, causal, d):
    """Every query row against the key it must end on: the diagonal (causal)
    or the last key T - 1 (full attention over a ragged tail), across every
    query-tile boundary and the ragged last tile."""
    from infinistore_tpu_torch.cuda import flash_prefill as fp

    b, h, kvh = 2, 8, 2
    q, k, v = _rising_keys(b, s, t, h, kvh, d, dev)
    got = _k4_launch(fp, q, k, v, causal)
    last = torch.arange(s, device=dev) if causal else torch.full((s,), t - 1, device=dev)
    want = v[:, last].repeat_interleave(h // kvh, dim=2)  # [b, s, h, d]
    # A neighbouring key's value differs from the right one by over 10x the
    # tolerance in every row, so a leak or a drop cannot hide inside it.
    prev = v[:, (last - 1).clamp(min=0)].repeat_interleave(h // kvh, dim=2)
    gap = (want.float() - prev.float()).abs().amax(dim=(0, 2, 3))
    assert float(gap[1:].min()) > 10 * TOL[torch.bfloat16]
    assert _err(got, want) <= TOL[torch.bfloat16]
    assert _err(got, fp.flash_prefill_plain(q, k, v, causal=causal)) <= TOL[torch.bfloat16]


# Lengths off both bodies' tiles (f32: 64 rows, 64 keys; bf16: 128 rows,
# 128 keys, 80 at head_dim 256, whose key split starts at 561 tokens).
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 7], ids=["g1", "g2", "g4", "g8", "g7"])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("s", [200, 2047])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_prefill_both_bodies_match_plain(dev, d, dtype, s, b, group, causal):
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import flash_prefill as fp

    kvh = 2
    q = _randn(50, (b, s, kvh * group, d), dtype, dev)
    k = _randn(51, (b, s, kvh, d), dtype, dev)
    v = _randn(52, (b, s, kvh, d), dtype, dev)
    before = dict(_ext.LAUNCHES)
    got = fp.flash_prefill_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["flash_prefill"] == before["flash_prefill"] + 1
    assert _ext.LAUNCHES["flash_prefill_wgmma"] == \
        before["flash_prefill_wgmma"] + (dtype == torch.bfloat16)
    assert _err(got, fp.flash_prefill_plain(q, k, v, causal=causal)) <= TOL[dtype]


@pytest.mark.parametrize("s", [1000, 2047, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_d256_bitwise_across_launches_and_batches(dev, s, dtype):
    """Gemma-2B's heads (8 over 1) at head_dim 256: two launches bitwise
    equal, and each prompt of a 4-prompt batch bitwise its solo launch (the
    bf16 kernel's key split and merge order depend on the prompt alone)."""
    from infinistore_tpu_torch.cuda import flash_prefill as fp

    q = _randn(53, (4, s, 8, 256), dtype, dev)
    k = _randn(54, (4, s, 1, 256), dtype, dev)
    v = _randn(55, (4, s, 1, 256), dtype, dev)
    got = fp.flash_prefill_attention(q, k, v, causal=True)
    assert torch.equal(got, fp.flash_prefill_attention(q, k, v, causal=True))
    for i in range(4):
        solo = fp.flash_prefill_attention(q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
                                          v[i:i + 1].contiguous(), causal=True)
        assert torch.equal(solo, got[i:i + 1])
    assert _err(got, fp.flash_prefill_plain(q, k, v, causal=True)) <= TOL[dtype]


@pytest.mark.parametrize("s,t,causal", [(2048, 2048, True), (600, 600, True),
                                        (300, 2100, False)])
def test_flash_prefill_wgmma_merge_workspace_is_the_plans(dev, s, t, causal):
    """The kernel refuses a merge workspace one slot short of the wrapper's
    plan (``wgmma_split``), so the two agree; with the plan's slots it gives
    the wrapper's output and leaves every ticket zero."""
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import flash_prefill as fp

    b, h, kvh, d = 2, 4, 1, 256
    q = _randn(56, (b, s, h, d), torch.bfloat16, dev)
    k = _randn(57, (b, t, kvh, d), torch.bfloat16, dev)
    v = _randn(58, (b, t, kvh, d), torch.bfloat16, dev)
    n_qt, _, q_s = fp.wgmma_split(s, t, causal, h)
    slots = (n_qt - q_s) * b * h
    assert slots > 0
    scratch = torch.empty(slots * 2 * 128 * 132, dtype=torch.float32, device=dev)
    tickets = torch.zeros(2 * slots, dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    lib = _ext.kernels()

    def launch(n):
        return lib.its_flash_prefill_wgmma(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           out.data_ptr(), scratch.data_ptr(),
                                           tickets.data_ptr(), b, s, t, h, kvh, d,
                                           int(causal), n, 0, _ext.stream_of(q))

    assert launch(slots - 1) != 0
    assert launch(slots) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, fp.flash_prefill_attention(q, k, v, causal=causal))
    assert int(tickets.abs().sum()) == 0


def test_flash_prefill_f32_takes_inputs_off_a_16_byte_boundary(dev):
    """The f32 kernel copies its tiles 16 bytes at a time, or 4 at a time
    when an input is not 16-byte aligned; both give the plain version's
    output."""
    from infinistore_tpu_torch.cuda import flash_prefill as fp

    for d in (64, 80, 256):
        flat = _randn(59, (1 + 300 * 4 * d,), torch.float32, dev)
        q = flat[1:].view(1, 300, 4, d)  # contiguous, 4 bytes past a 16-byte boundary
        k = _randn(60, (1, 300, 2, d), torch.float32, dev)
        v = _randn(61, (1, 300, 2, d), torch.float32, dev)
        got = fp.flash_prefill_attention(q, k, v, causal=True)
        assert _err(got, fp.flash_prefill_plain(q, k, v, causal=True)) <= TOL[torch.float32]


def test_flash_prefill_f32_stays_on_the_cuda_cores(dev):
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import flash_prefill as fp

    q = _randn(37, (1, 300, 8, 128), torch.float32, dev)
    k = _randn(38, (1, 300, 2, 128), torch.float32, dev)
    v = _randn(39, (1, 300, 2, 128), torch.float32, dev)
    before = dict(_ext.LAUNCHES)
    got = fp.flash_prefill_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["flash_prefill"] == before["flash_prefill"] + 1
    assert _ext.LAUNCHES["flash_prefill_wgmma"] == before["flash_prefill_wgmma"]
    assert _err(got, fp.flash_prefill_plain(q, k, v, causal=True)) <= TOL[torch.float32]


def test_flash_prefill_wgmma_rejects_misaligned_inputs(dev):
    from infinistore_tpu_torch.cuda import flash_prefill as fp

    flat = _randn(40, (1 + 64 * 2 * 64,), torch.bfloat16, dev)
    q = flat[1:].view(1, 64, 2, 64)  # contiguous, 2 bytes past a 16-byte boundary
    k = _randn(41, (1, 64, 2, 64), torch.bfloat16, dev)
    with pytest.raises(ValueError, match="16-byte"):
        fp.flash_prefill_attention(q, k, k, causal=True)


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
        # One launch a layer (its K and V together), each on the bulk ring.
        for name in ("gather_blocks", "gather_blocks_bulk", "scatter_blocks",
                     "scatter_blocks_bulk"):
            assert _ext.LAUNCHES[name] - before[name] == 3, name
    finally:
        pool.close()
        conn.close()
        srv.stop()


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("h,kvh", GROUPS4, ids=GROUP_IDS)
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


# K8 against K3 run on q.float() over the f32-dequantised cache: both fold in
# f32 (1e-5 apart); with bf16 q each result is then rounded to bf16, so the
# two may also sit that rounding (2^-7 of the value) apart.
K8_K3_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}


def _assert_near_k3(k8, k3, dtype):
    diff = (k8.float() - k3.float()).abs()
    assert bool((diff <= 1e-5 + K8_K3_RTOL[dtype] * k3.float().abs()).all()), float(diff.max())


def _assert_k8_contract(kq, pa, q, kd, ks, vd, vs, tables, lens, got, plain_tables=None):
    """K8's contract on one launch's output ``got``: within TOL of its plain
    version (the JAX package's contract), within 1e-5 (and, with bf16 q, the
    bf16 rounding) of K3 run on q.float() over the f32-dequantised cache; a
    second launch bitwise equal; each row bitwise its solo launch."""
    dtype = q.dtype
    want = kq._quant_decode_plain(q, kd, ks, vd, vs,
                                  tables if plain_tables is None else plain_tables,
                                  lens.clamp(max=tables.shape[1] * kd.shape[1]))
    k3 = pa.paged_decode_attention_batched(
        q.float(), kq.dequantize_kv(kd, ks), kq.dequantize_kv(vd, vs), tables, lens).to(dtype)
    again = kq.paged_decode_attention_quantized(q, kd, ks, vd, vs, tables, lens)
    torch.cuda.synchronize()
    assert _err(got, want) <= TOL[dtype]
    _assert_near_k3(got, k3, dtype)
    assert torch.equal(got, again)
    for r in range(q.shape[0]):
        solo = kq.paged_decode_attention_quantized(
            q[r:r + 1].contiguous(), kd, ks, vd, vs, tables[r:r + 1].contiguous(),
            lens[r:r + 1].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(solo[0], got[r]), r


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("h,kvh", GROUPS4, ids=GROUP_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_decode_matches_plain_and_k3_over_the_dequantised_cache(dev, d, h, kvh,
                                                                           dtype):
    """K8 over zero, one-token, block-boundary, partial, full and past-the-
    table rows: within tolerance of its plain version and of K3 run on
    q.float() over the f32-dequantised cache, two launches bitwise equal,
    each row bitwise its solo launch."""
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import kv_quant as kq
    from infinistore_tpu_torch.cuda import paged_attention as pa

    bt, n, max_blocks = 16, 40, 9
    q = _randn(30, (6, h, d), dtype, dev)
    kd, ks = kq.quantize_kv(_randn(31, (n, bt, kvh, d), torch.float32, dev) * 3)
    vd, vs = kq.quantize_kv(_randn(32, (n, bt, kvh, d), torch.float32, dev))
    g = torch.Generator().manual_seed(33)
    tables = torch.stack([torch.randperm(n, generator=g)[:max_blocks] for _ in range(6)])
    tables = tables.to(device=dev, dtype=torch.int32)
    lens = torch.tensor([0, 1, bt, 3 * bt + 5, max_blocks * bt, max_blocks * bt + 50],
                        dtype=torch.int32, device=dev)
    before = _ext.LAUNCHES["paged_decode_attention_quantized"]
    got = kq.paged_decode_attention_quantized(q, kd, ks, vd, vs, tables, lens)
    assert _ext.LAUNCHES["paged_decode_attention_quantized"] == before + 1
    _assert_k8_contract(kq, pa, q, kd, ks, vd, vs, tables, lens, got)
    assert torch.all(got[0] == 0)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_stats_match_plain_and_combine_to_k3_k6_bitwise(dev, d, dtype):
    """K5 and K7 against their plain statistics (the empty row: acc 0, l 0,
    m -1e30), and their one-shard combine bitwise K3 / K6."""
    from infinistore_tpu_torch.cuda import paged_attention as pa

    bt, n, width, h, kvh = 16, 40, 6, 16, 4
    q = _randn(34, (6, h, d), dtype, dev)
    kc = _randn(35, (n, bt, kvh, d), dtype, dev)
    vc = _randn(36, (n, bt, kvh, d), dtype, dev)
    g = torch.Generator().manual_seed(37)
    tables = torch.stack([torch.randperm(n, generator=g)[:width] for _ in range(6)])
    tables = tables.to(device=dev, dtype=torch.int32)
    lens = torch.tensor([0, 1, bt, 3 * bt + 5, width * bt, 2 * bt - 1], dtype=torch.int32,
                        device=dev)
    ident = lambda t: t  # noqa: E731
    stats = pa._decode_attention_stats(q, kc, vc, tables, lens)
    plain = pa.decode_attention_stats_plain(q, kc, vc, tables, lens)
    for a, b in zip(stats, plain):
        assert _err(a, b) <= 1e-4 * max(1.0, float(b.abs().max()))
    assert torch.all(stats[1][0] == -1e30) and torch.all(stats[2][0] == 0)
    assert torch.all(stats[0][0] == 0)
    k3 = pa.paged_decode_attention_batched(q, kc, vc, tables, lens)
    assert torch.equal(pa.combine_stats(*stats, dtype, ident, ident), k3)

    m = pa.build_ragged_wave([t.cpu().numpy() for t in tables], lens.cpu().numpy(), bt,
                             pad_to_pow2=True)
    meta = [torch.from_numpy(x).to(dev) for x in (m.pages, m.page_rows, m.page_starts,
                                                    m.seq_lens)]
    rstats = pa._decode_attention_stats_ragged(q, kc, vc, *meta, table_width=width)
    rplain = pa.decode_attention_stats_ragged_plain(q, kc, vc, meta[0], meta[2], meta[3], width)
    for a, b in zip(rstats, rplain):
        assert _err(a, b) <= 1e-4 * max(1.0, float(b.abs().max()))
    k6 = pa.paged_decode_attention_ragged(q, kc, vc, *meta, table_width=width)
    assert torch.equal(pa.combine_stats(*rstats, dtype, ident, ident), k6)
    assert torch.equal(k6, k3)


@pytest.mark.parametrize("enable_shm", [True, False], ids=["shm", "socket"])
def test_quantized_store_roundtrip_through_pinned_staging(dev, enable_shm):
    from infinistore_tpu_torch import config, lib
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import kv_quant as kq
    from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec

    spec = PagedKVCacheSpec(3, 24, 16, 8, 128, torch.bfloat16)
    caches = [(kq.quantize_kv(_randn(50 + i, spec.cache_shape, spec.dtype, dev)),
               kq.quantize_kv(_randn(60 + i, spec.cache_shape, spec.dtype, dev)))
              for i in range(3)]
    srv = lib.start_local_server(prealloc_bytes=64 << 20, block_bytes=16 << 10)
    conn = lib.InfinityConnection(config.ClientConfig(
        host_addr="127.0.0.1", service_port=srv.port, log_level="error", enable_shm=enable_shm))
    conn.connect()
    qc = kq.QuantizedKVConnector(conn, spec, "cuda-q8", max_blocks=6, device=dev)
    try:
        tokens = list(range(96))  # 6 blocks
        src = np.array([3, 9, 0, 17, 22, 12], np.int32)
        dst = np.array([1, 2, 5, 8, 13, 21], np.int32)
        before = dict(_ext.LAUNCHES)
        assert asyncio.run(qc.save(tokens, caches, src)) == 2 * 3 * 6
        fresh = [((torch.zeros(spec.cache_shape, dtype=torch.int8, device=dev),
                   torch.zeros(spec.cache_shape[:-1], device=dev)),
                  (torch.zeros(spec.cache_shape, dtype=torch.int8, device=dev),
                   torch.zeros(spec.cache_shape[:-1], device=dev))) for _ in range(3)]
        loaded, n = asyncio.run(qc.load(tokens, fresh, dst))
        torch.cuda.synchronize()
        assert n == 6
        for layer in range(3):
            for side in (0, 1):
                for part in (0, 1):
                    assert torch.equal(loaded[layer][side][part][dst.tolist()],
                                       caches[layer][side][part][src.tolist()])
                    # The loaded scales landed in the caller's own tensors.
                    assert loaded[layer][side][part].data_ptr() == \
                        fresh[layer][side][part].data_ptr()
        # One launch a layer and plane (data, scales), each on the bulk ring.
        for name in ("gather_blocks", "gather_blocks_bulk", "scatter_blocks",
                     "scatter_blocks_bulk"):
            assert _ext.LAUNCHES[name] - before[name] == 2 * 3, name
    finally:
        qc.close()
        conn.close()
        srv.stop()


# The split-KV decode fold (csrc/decode_fold.cuh): a row of n pages folds in
# about 8 splits of 4 to 16 pages (one of 4 pages up to 4 pages, 16-page ones
# from 128 pages up), merged in split order by the row's last CTA. Rows at
# and around the split edges, many splits long, every supported group,
# head_dim and dtype.
SPLIT_BT = 16
# 0 and 1 token; one 4-page split, less, equal and more by a token; 8 splits
# of 4 pages, and 7 of 5; 8 splits of 16 pages, less, equal and more by a
# token; 10 splits of 16 pages.
SPLIT_EDGE_LENS = [0, 1, 4 * SPLIT_BT - 1, 4 * SPLIT_BT, 4 * SPLIT_BT + 1, 32 * SPLIT_BT,
                   32 * SPLIT_BT + 1, 128 * SPLIT_BT - 1, 128 * SPLIT_BT, 128 * SPLIT_BT + 1,
                   150 * SPLIT_BT + 7]


def _split_case(dtype, d, h, kvh, dev, seed):
    """Rows of SPLIT_EDGE_LENS tokens, tables padded 4 pages past the
    longest. Returns (q, k, v, good tables, tables whose entries past each
    row's sequence are out of range, lens)."""
    bt = SPLIT_BT
    lens = SPLIT_EDGE_LENS
    width = -(-max(lens) // bt) + 4
    n = len(lens) * width
    g = torch.Generator().manual_seed(seed)
    good = torch.randperm(n, generator=g)[: len(lens) * width].reshape(len(lens), width)
    bad = good.clone()
    for r, length in enumerate(lens):
        used = -(-length // bt)
        bad[r, used:] = torch.tensor([-1, n, n + 1000, -7] * width)[: width - used]
    q = _randn(seed + 1, (len(lens), h, d), dtype, dev)
    k = _randn(seed + 2, (n, bt, kvh, d), dtype, dev)
    v = _randn(seed + 3, (n, bt, kvh, d), dtype, dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, good.to(dev, torch.int32), bad.to(dev, torch.int32), lens_t


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("h,kvh", GROUPS2, ids=GROUP_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_k3_k6_at_split_edges(dev, d, h, kvh, dtype):
    """K3 and K6 against their plain versions around every split edge;
    padding past the sequence with out-of-range ids changes nothing; two
    launches are bitwise equal; K6 is bitwise K3 per row."""
    from infinistore_tpu_torch.cuda import paged_attention as pa

    q, k, v, good, bad, lens = _split_case(dtype, d, h, kvh, dev, 70)
    got = pa.paged_decode_attention_batched(q, k, v, bad, lens)
    again = pa.paged_decode_attention_batched(q, k, v, bad, lens)
    on_good = pa.paged_decode_attention_batched(q, k, v, good, lens)
    want = pa.paged_decode_attention_plain_batched(q, k, v, good, lens)
    torch.cuda.synchronize()
    assert _err(got, want) <= TOL[dtype]
    assert torch.equal(got, again) and torch.equal(got, on_good)
    assert torch.all(got[0] == 0)

    bt, width = k.shape[1], good.shape[1]
    m = pa.build_ragged_wave([t.cpu().numpy() for t in good], lens.cpu().numpy(), bt,
                             pad_to_pow2=True)
    meta = [torch.from_numpy(x).to(dev) for x in (m.pages, m.page_rows, m.page_starts,
                                                    m.seq_lens)]
    k6 = pa.paged_decode_attention_ragged(q, k, v, *meta, table_width=width)
    k6_again = pa.paged_decode_attention_ragged(q, k, v, *meta, table_width=width)
    k6_plain = pa.paged_decode_attention_ragged_plain(q, k, v, meta[0], meta[2], meta[3], width)
    torch.cuda.synchronize()
    assert torch.equal(k6, got) and torch.equal(k6, k6_again)
    assert _err(k6, k6_plain) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_rows_equal_their_solo_launch(dev, dtype):
    """A wave whose rows span 1 to 5 splits of 4 pages, 8 of 9 and 13 of 16
    (beside a one-token row): each row is bitwise its solo launch and its K3
    launch."""
    from infinistore_tpu_torch.cuda import paged_attention as pa

    bt, h, kvh, d = SPLIT_BT, 32, 8, 128
    lens = [4 * s * bt - 3 for s in range(1, 6)] + [1, 72 * bt, 200 * bt + 5]
    width = 201
    g = torch.Generator().manual_seed(71)
    tables = [torch.randperm(len(lens) * width, generator=g)[:width].numpy()
              for _ in lens]
    k = _randn(72, (len(lens) * width, bt, kvh, d), dtype, dev)
    v = _randn(73, (len(lens) * width, bt, kvh, d), dtype, dev)
    q = _randn(74, (len(lens), h, d), dtype, dev)
    m = pa.build_ragged_wave(tables, lens, bt, pad_to_pow2=True)
    wave = pa.paged_decode_attention_ragged(q, k, v, m.pages, m.page_rows, m.page_starts,
                                            m.seq_lens, table_width=width)
    for r in range(len(lens)):
        solo = pa.build_ragged_wave([tables[r]], [lens[r]], bt)
        one = pa.paged_decode_attention_ragged(q[r:r + 1].contiguous(), k, v, solo.pages,
                                               solo.page_rows, solo.page_starts, solo.seq_lens,
                                               table_width=width)
        k3 = pa.paged_decode_attention_batched(
            q[r:r + 1].contiguous(), k, v,
            torch.from_numpy(tables[r][None].astype(np.int32)).to(dev),
            torch.tensor([lens[r]], dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        assert torch.equal(one[0], wave[r]), r
        assert torch.equal(k3[0], wave[r]), r


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("h,kvh", GROUPS2, ids=GROUP_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_stats_combine_to_k3_k6_bitwise(dev, d, h, kvh, dtype):
    """K5 and K7 at the split edges: within tolerance of their plain
    statistics (the empty row: acc 0, l 0, m -1e30), and their one-shard
    combine bitwise K3 / K6."""
    from infinistore_tpu_torch.cuda import paged_attention as pa

    q, k, v, good, bad, lens = _split_case(dtype, d, h, kvh, dev, 80)
    ident = lambda t: t  # noqa: E731
    stats = pa._decode_attention_stats(q, k, v, bad, lens)
    plain = pa.decode_attention_stats_plain(q, k, v, good, lens)
    torch.cuda.synchronize()
    for a, b in zip(stats, plain):
        assert _err(a, b) <= 1e-4 * max(1.0, float(b.abs().max()))
    assert torch.all(stats[1][0] == -1e30) and torch.all(stats[2][0] == 0)
    assert torch.all(stats[0][0] == 0)
    k3 = pa.paged_decode_attention_batched(q, k, v, bad, lens)
    assert torch.equal(pa.combine_stats(*stats, dtype, ident, ident), k3)

    bt, width = k.shape[1], good.shape[1]
    m = pa.build_ragged_wave([t.cpu().numpy() for t in good], lens.cpu().numpy(), bt,
                             pad_to_pow2=True)
    meta = [torch.from_numpy(x).to(dev) for x in (m.pages, m.page_rows, m.page_starts,
                                                    m.seq_lens)]
    rstats = pa._decode_attention_stats_ragged(q, k, v, *meta, table_width=width)
    k6 = pa.paged_decode_attention_ragged(q, k, v, *meta, table_width=width)
    torch.cuda.synchronize()
    assert torch.equal(pa.combine_stats(*rstats, dtype, ident, ident), k6)
    for a, b in zip(rstats, stats):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("h,kvh", GROUPS2, ids=GROUP_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_quantized_decode_is_k3_over_the_dequantised_cache(dev, d, h, kvh, dtype):
    """K8 at K3's split edges, over tables padded with out-of-range ids:
    within tolerance of its plain version and of K3 run on q.float() over
    the f32-dequantised cache, two launches bitwise equal, each row bitwise
    its solo launch."""
    from infinistore_tpu_torch.cuda import kv_quant as kq
    from infinistore_tpu_torch.cuda import paged_attention as pa

    q, k, v, good, bad, lens = _split_case(torch.float32, d, h, kvh, dev, 90)
    q = q.to(dtype)
    kd, ks = kq.quantize_kv(k * 3)
    vd, vs = kq.quantize_kv(v)
    got = kq.paged_decode_attention_quantized(q, kd, ks, vd, vs, bad, lens)
    _assert_k8_contract(kq, pa, q, kd, ks, vd, vs, bad, lens, got, plain_tables=good)
    assert torch.all(got[0] == 0)


def test_split_ragged_row_is_clamped_to_the_table_width(dev):
    """A ragged row that asks for more pages than the wave's table width
    attends to the first table_width pages, as the plain version's rebuilt
    tables do."""
    from infinistore_tpu_torch.cuda import paged_attention as pa

    bt, h, kvh, d = SPLIT_BT, 8, 2, 128
    pages_row = 150
    k = _randn(91, (pages_row, bt, kvh, d), torch.bfloat16, dev)
    v = _randn(92, (pages_row, bt, kvh, d), torch.bfloat16, dev)
    q = _randn(93, (1, h, d), torch.bfloat16, dev)
    table = np.arange(pages_row, dtype=np.int32)
    m = pa.build_ragged_wave([table], [pages_row * bt], bt)
    for width in (pages_row - 1, 129, 128, 33, 5):
        got = pa.paged_decode_attention_ragged(q, k, v, m.pages, m.page_rows, m.page_starts,
                                               m.seq_lens, table_width=width)
        want = pa.paged_decode_attention_ragged_plain(
            q, k, v, *(torch.from_numpy(x).to(dev) for x in (m.pages, m.page_starts,
                                                              m.seq_lens)), width)
        torch.cuda.synchronize()
        assert _err(got, want) <= TOL[torch.bfloat16], width


def test_split_count_covers_every_row_of_the_width(dev):
    """The library's split count for a table width (the grid's split
    dimension, by which the wrappers size their scratch) is the most splits
    any row of at most that many pages takes: a row of n pages folds in
    about 8 splits of 4 to 16 pages, a count that is not monotone in n."""
    from infinistore_tpu_torch.cuda import _ext

    def row_splits(n):
        per = min(max(-(-n // 8), 4), 16)
        return max(1, -(-n // per))

    lib = _ext.kernels()
    for width in list(range(1, 300)) + [511, 512, 513, 600, 2048, 4097]:
        want = max(row_splits(n) for n in range(width + 1))
        assert lib.its_decode_splits(width) == want, width


@pytest.mark.parametrize("h,kvh", GROUPS2, ids=GROUP_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_merge_past_one_chunk_of_splits(dev, h, kvh, dtype):
    """Long rows, merged in the tree: 512 / G splits of 16 pages (the most
    one chunk of the merge stages), three splits and a part past it, and
    twice that and one page: K3 against its plain version, two launches
    bitwise equal, K6 bitwise K3 per row, K5's one-shard combine bitwise K3,
    K8 within 1e-5 (and bf16's rounding) of K3 over the dequantised cache.
    (The merge of the groups reaches its chunks only past 16 x 512 / G
    splits: test_split_merge_tree_past_one_chunk_of_groups.)"""
    from infinistore_tpu_torch.cuda import kv_quant as kq
    from infinistore_tpu_torch.cuda import paged_attention as pa

    bt, d = SPLIT_BT, 128
    chunk = 16 * (512 // (h // kvh))  # pages in one chunk of 16-page splits
    pages = [chunk, chunk + 3 * 16 + 5, 2 * chunk + 1, 0]
    lens = [max(0, n * bt - 5 * (i % 2)) for i, n in enumerate(pages)]
    width = max(pages)
    n = width + 8
    g = torch.Generator().manual_seed(95)
    tables_np = [torch.randperm(n, generator=g)[:width].numpy().astype(np.int32)
                 for _ in pages]
    tables = torch.from_numpy(np.stack(tables_np)).to(dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = _randn(96, (len(pages), h, d), dtype, dev)
    k = _randn(97, (n, bt, kvh, d), torch.float32, dev)
    v = _randn(98, (n, bt, kvh, d), torch.float32, dev)
    kc, vc = k.to(dtype), v.to(dtype)

    got = pa.paged_decode_attention_batched(q, kc, vc, tables, lens_t)
    again = pa.paged_decode_attention_batched(q, kc, vc, tables, lens_t)
    want = pa.paged_decode_attention_plain_batched(q, kc, vc, tables, lens_t)
    torch.cuda.synchronize()
    assert _err(got, want) <= TOL[dtype]
    assert torch.equal(got, again) and torch.all(got[-1] == 0)

    m = pa.build_ragged_wave(tables_np, lens, bt, pad_to_pow2=True)
    k6 = pa.paged_decode_attention_ragged(q, kc, vc, m.pages, m.page_rows, m.page_starts,
                                          m.seq_lens, table_width=width)
    ident = lambda t: t  # noqa: E731
    stats = pa._decode_attention_stats(q, kc, vc, tables, lens_t)
    torch.cuda.synchronize()
    assert torch.equal(k6, got)
    assert torch.equal(pa.combine_stats(*stats, dtype, ident, ident), got)

    kd, ks = kq.quantize_kv(k)
    vd, vs = kq.quantize_kv(v)
    k8 = kq.paged_decode_attention_quantized(q, kd, ks, vd, vs, tables, lens_t)
    k3 = pa.paged_decode_attention_batched(
        q.float(), kq.dequantize_kv(kd, ks), kq.dequantize_kv(vd, vs), tables, lens_t).to(dtype)
    torch.cuda.synchronize()
    _assert_near_k3(k8, k3, dtype)


# K8's split policy (the fold's, decode_fold.cuh): about 8 splits of 4 to 16 pages
# (4-page splits up to 32 pages, 16-page ones from 128 up), and a row of
# more than 16 splits merges in the tree. 0 and 1 token, one page; a 4-page
# split, less, equal and more by a token; 8 splits of 4 pages and a token
# more (7 of 5); 8 of 16 pages, less, equal and more by a token; 16 and 17
# splits of 16 pages (the tree's edge); 32 splits and a part past them.
Q8_EDGE_LENS = [0, 1, SPLIT_BT, 4 * SPLIT_BT - 1, 4 * SPLIT_BT, 4 * SPLIT_BT + 1, 32 * SPLIT_BT,
                32 * SPLIT_BT + 1, 128 * SPLIT_BT - 1, 128 * SPLIT_BT, 128 * SPLIT_BT + 1,
                256 * SPLIT_BT, 257 * SPLIT_BT, 512 * SPLIT_BT + 7]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("h,kvh", GROUPS2, ids=GROUP_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_decode_at_its_own_split_edges(dev, d, h, kvh, dtype):
    """K8 on rows either side of its split edges, a one-page and a
    zero-length row, over tables padded past each row with out-of-range
    pages: its contract (plain version, K3 over the dequantised cache, two
    launches, solo rows), zeros for the empty row, and the pages past a row
    read nothing (the tables padded with valid pages give the same bits)."""
    from infinistore_tpu_torch.cuda import kv_quant as kq
    from infinistore_tpu_torch.cuda import paged_attention as pa

    bt, lens = SPLIT_BT, Q8_EDGE_LENS
    width = -(-max(lens) // bt) + 4
    n = len(lens) * width
    g = torch.Generator().manual_seed(110 + d + h)
    good = torch.randperm(n, generator=g)[:n].reshape(len(lens), width)
    bad = good.clone()
    for r, length in enumerate(lens):
        used = -(-length // bt)
        bad[r, used:] = torch.tensor([-1, n, n + 1000, -7] * width)[: width - used]
    good, bad = good.to(dev, torch.int32), bad.to(dev, torch.int32)
    q = _randn(111, (len(lens), h, d), dtype, dev)
    kd, ks = kq.quantize_kv(_randn(112, (n, bt, kvh, d), torch.float32, dev) * 2)
    vd, vs = kq.quantize_kv(_randn(113, (n, bt, kvh, d), torch.float32, dev))
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = kq.paged_decode_attention_quantized(q, kd, ks, vd, vs, bad, lens_t)
    on_good = kq.paged_decode_attention_quantized(q, kd, ks, vd, vs, good, lens_t)
    torch.cuda.synchronize()
    assert torch.equal(got, on_good)
    assert torch.all(got[0] == 0)
    _assert_k8_contract(kq, pa, q, kd, ks, vd, vs, bad, lens_t, got, plain_tables=good)


def test_quantized_decode_at_the_int8_round_trips_wave(dev):
    """K8 at the int8 round trip's wave (4 rows of 2,048 tokens, 8 splits of
    16 pages each; Llama-3-8B widths) in both q dtypes, and its tickets left
    zero."""
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import kv_quant as kq
    from infinistore_tpu_torch.cuda import paged_attention as pa

    bt, h, kvh, d, rows, width = SPLIT_BT, 32, 8, 128, 4, 128
    n = rows * width + 16
    g = torch.Generator().manual_seed(120)
    tables = torch.randperm(n, generator=g)[: rows * width].reshape(rows, width)
    tables = tables.to(dev, torch.int32)
    lens = torch.full((rows,), width * bt, dtype=torch.int32, device=dev)
    kd, ks = kq.quantize_kv(_randn(121, (n, bt, kvh, d), torch.float32, dev))
    vd, vs = kq.quantize_kv(_randn(122, (n, bt, kvh, d), torch.float32, dev))
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn(123, (rows, h, d), dtype, dev)
        got = kq.paged_decode_attention_quantized(q, kd, ks, vd, vs, tables, lens)
        _assert_k8_contract(kq, pa, q, kd, ks, vd, vs, tables, lens, got)
    _, tickets = _ext._WORKSPACE[(q.device, _ext.stream_of(q))]
    assert not tickets.any()


@pytest.mark.parametrize("h,kvh", [(1, 1), (2, 1), (4, 1), (8, 1)], ids=["g1", "g2", "g4", "g8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_merge_tree_combines_to_k3_bitwise(dev, h, kvh, dtype):
    """Rows of 16 splits (one merge), 17 (the tree: a group of 16 and one of
    1), 128 and 2,048 splits of 16 pages (a 524,288-token row), beside a
    short row and an empty one: K3 within tolerance of its plain version
    (the longest row against the plain statistics), two launches bitwise
    equal, K5's one-shard combine and K6 bitwise K3, and the tickets left
    zero."""
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import paged_attention as pa

    bt, d = SPLIT_BT, 128
    pages = [16 * 16, 17 * 16 - 3, 128 * 16, 2048 * 16, 5, 0]
    lens = [max(0, p * bt - 3 * (i % 2)) for i, p in enumerate(pages)]
    width = max(pages)
    n = width + 8
    g = torch.Generator().manual_seed(130)
    tables_np = [torch.randperm(n, generator=g)[:width].numpy().astype(np.int32)
                 for _ in pages]
    tables = torch.from_numpy(np.stack(tables_np)).to(dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = _randn(131, (len(pages), h, d), dtype, dev)
    kc = _randn(132, (n, bt, kvh, d), dtype, dev)
    vc = _randn(133, (n, bt, kvh, d), dtype, dev)

    got = pa.paged_decode_attention_batched(q, kc, vc, tables, lens_t)
    again = pa.paged_decode_attention_batched(q, kc, vc, tables, lens_t)
    short = [0, 1, 2, 4, 5]
    want = pa.paged_decode_attention_plain_batched(q[short], kc, vc, tables[short],
                                                   lens_t[short])
    long_stats = pa.decode_attention_stats_plain(q[3:4], kc, vc, tables[3:4], lens_t[3:4])
    torch.cuda.synchronize()
    assert _err(got[short], want) <= TOL[dtype]
    long_want = long_stats[0] / torch.clamp(long_stats[2], min=1e-30)
    assert _err(got[3:4], long_want) <= TOL[dtype]
    assert torch.equal(got, again) and torch.all(got[-1] == 0)

    ident = lambda t: t  # noqa: E731
    stats = pa._decode_attention_stats(q, kc, vc, tables, lens_t)
    m = pa.build_ragged_wave(tables_np, lens, bt, pad_to_pow2=True)
    k6 = pa.paged_decode_attention_ragged(q, kc, vc, m.pages, m.page_rows, m.page_starts,
                                          m.seq_lens, table_width=width)
    torch.cuda.synchronize()
    assert torch.equal(pa.combine_stats(*stats, dtype, ident, ident), got)
    assert torch.equal(k6, got)
    _, tickets = _ext._WORKSPACE[(q.device, _ext.stream_of(q))]
    assert not tickets.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_merge_tree_past_one_chunk_of_groups(dev, dtype):
    """At G = 8 the last group merger stages the groups' (m, l) 64 at a
    time: rows of exactly 64 groups of 16 splits (16,384 pages, 262,144
    tokens), three groups and a part past them, and 128 groups and one page
    merge the groups chunk by chunk. K3 against its plain statistics row by
    row, two launches bitwise equal, K5's one-shard combine and K6 bitwise
    K3, the tickets left zero."""
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import paged_attention as pa

    bt, h, kvh, d = SPLIT_BT, 16, 2, 128
    chunk = 16 * 16 * (512 // (h // kvh))  # pages in one chunk of groups
    pages = [chunk, chunk + 3 * 256 + 5, 2 * chunk + 1]
    lens = [n * bt - 5 * (i % 2) for i, n in enumerate(pages)]
    width = max(pages)
    n = width + 8
    g = torch.Generator().manual_seed(140)
    tables_np = [torch.randperm(n, generator=g)[:width].numpy().astype(np.int32)
                 for _ in pages]
    tables = torch.from_numpy(np.stack(tables_np)).to(dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = _randn(141, (len(pages), h, d), dtype, dev)
    kc = _randn(142, (n, bt, kvh, d), dtype, dev)
    vc = _randn(143, (n, bt, kvh, d), dtype, dev)

    got = pa.paged_decode_attention_batched(q, kc, vc, tables, lens_t)
    again = pa.paged_decode_attention_batched(q, kc, vc, tables, lens_t)
    for r, used in enumerate(pages):
        acc, _, l = pa.decode_attention_stats_plain(
            q[r:r + 1], kc, vc, tables[r:r + 1, :used].contiguous(), lens_t[r:r + 1])
        torch.cuda.synchronize()
        assert _err(got[r:r + 1], acc / torch.clamp(l, min=1e-30)) <= TOL[dtype], r
    assert torch.equal(got, again)

    ident = lambda t: t  # noqa: E731
    stats = pa._decode_attention_stats(q, kc, vc, tables, lens_t)
    m = pa.build_ragged_wave(tables_np, lens, bt, pad_to_pow2=True)
    k6 = pa.paged_decode_attention_ragged(q, kc, vc, m.pages, m.page_rows, m.page_starts,
                                          m.seq_lens, table_width=width)
    torch.cuda.synchronize()
    assert torch.equal(pa.combine_stats(*stats, dtype, ident, ident), got)
    assert torch.equal(k6, got)
    _, tickets = _ext._WORKSPACE[(q.device, _ext.stream_of(q))]
    assert not tickets.any()


# A launch over tables W pages wide runs grid_splits(W) splits a row: the
# grid's split dimension, and the count the split merge takes (all at once up
# to 16; in the tree past it). Launch widths of 1, 2, 5, 7, 8, 9, 13 and 16
# splits, and of 17 and 33 (the tree); rows of 0 and 1 token, one page, half
# the width less a few tokens (fewer splits than the launch: CTAs that fold
# nothing), the width less a page and a token, and the whole width.
LAUNCH_SPLIT_WIDTHS = [4, 8, 20, 28, 32, 144, 208, 256, 272, 520]


@pytest.mark.parametrize("width", LAUNCH_SPLIT_WIDTHS)
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("h,kvh", GROUPS2, ids=GROUP_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_family_at_every_launch_split_count(dev, width, d, h, kvh, dtype):
    """K3, K5, K6, K7 and K8 at every launch split count: two launches
    bitwise equal, each row bitwise its solo launch (K3, K7, K8), K6 bitwise
    K3 per row, K5's and K7's one-shard combines bitwise K3 and K6 and K7's
    rows K5's, against their plain versions within tolerance, the empty row
    zeros, and the tickets left zero."""
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import kv_quant as kq
    from infinistore_tpu_torch.cuda import paged_attention as pa

    bt = SPLIT_BT
    lens = [0, 1, bt, max(1, width // 2 * bt - 3), (width - 1) * bt + 1, width * bt]
    rows, n = len(lens), len(lens) * width + 8
    g = torch.Generator().manual_seed(150 + width)
    tables_np = [torch.randperm(n, generator=g)[:width].numpy().astype(np.int32)
                 for _ in lens]
    tables = torch.from_numpy(np.stack(tables_np)).to(dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = _randn(151, (rows, h, d), dtype, dev)
    k = _randn(152, (n, bt, kvh, d), torch.float32, dev)
    v = _randn(153, (n, bt, kvh, d), torch.float32, dev)
    kc, vc = k.to(dtype), v.to(dtype)
    ident = lambda t: t  # noqa: E731

    k3 = pa.paged_decode_attention_batched(q, kc, vc, tables, lens_t)
    k3_again = pa.paged_decode_attention_batched(q, kc, vc, tables, lens_t)
    want = pa.paged_decode_attention_plain_batched(q, kc, vc, tables, lens_t)
    stats = pa._decode_attention_stats(q, kc, vc, tables, lens_t)
    torch.cuda.synchronize()
    assert _err(k3, want) <= TOL[dtype]
    assert torch.equal(k3, k3_again) and torch.all(k3[0] == 0)
    assert torch.equal(pa.combine_stats(*stats, dtype, ident, ident), k3)

    m = pa.build_ragged_wave(tables_np, lens, bt, pad_to_pow2=True)
    meta = [torch.from_numpy(x).to(dev) for x in (m.pages, m.page_rows, m.page_starts,
                                                    m.seq_lens)]
    k6 = pa.paged_decode_attention_ragged(q, kc, vc, *meta, table_width=width)
    rstats = pa._decode_attention_stats_ragged(q, kc, vc, *meta, table_width=width)
    rstats_again = pa._decode_attention_stats_ragged(q, kc, vc, *meta, table_width=width)
    torch.cuda.synchronize()
    assert torch.equal(k6, k3)
    assert torch.equal(pa.combine_stats(*rstats, dtype, ident, ident), k6)
    for a, b, c in zip(rstats, rstats_again, stats):
        assert torch.equal(a, b) and torch.equal(a, c)

    for r in range(rows):
        solo_k3 = pa.paged_decode_attention_batched(q[r:r + 1].contiguous(), kc, vc,
                                                    tables[r:r + 1].contiguous(),
                                                    lens_t[r:r + 1].contiguous())
        solo = pa.build_ragged_wave([tables_np[r]], [lens[r]], bt)
        solo_k7 = pa._decode_attention_stats_ragged(
            q[r:r + 1].contiguous(), kc, vc, *(torch.from_numpy(x).to(dev) for x in (
                solo.pages, solo.page_rows, solo.page_starts, solo.seq_lens)),
            table_width=width)
        torch.cuda.synchronize()
        assert torch.equal(solo_k3[0], k3[r]), r
        for a, b in zip(solo_k7, rstats):
            assert torch.equal(a[0], b[r]), r

    kd, ks = kq.quantize_kv(k)
    vd, vs = kq.quantize_kv(v)
    k8 = kq.paged_decode_attention_quantized(q, kd, ks, vd, vs, tables, lens_t)
    _assert_k8_contract(kq, pa, q, kd, ks, vd, vs, tables, lens_t, k8)
    assert torch.all(k8[0] == 0)
    _, tickets = _ext._WORKSPACE[(q.device, _ext.stream_of(q))]
    assert not tickets.any()


def test_disagg_overlapped_leg_on_the_card_is_bitwise_its_local_leg(dev):
    """The handoff on the card (K4 and K2 in the streamed prefill, K1 in the
    ships, K2 in the per-layer installs on the install stream, K3 in the
    decode layers): the overlapped and blocking legs are bitwise the local
    recompute on the card, and every leg is within 2e-4 of the same leg on
    the CPU (the plain versions), tokens identical."""
    from infinistore_tpu_torch import config as tconfig
    from infinistore_tpu_torch import disagg
    from infinistore_tpu_torch import lib as tlib

    cfg = disagg.demo_config(n_layers=4, dim=256, ffn_dim=256)  # head_dim 64
    srv = tlib.start_local_server(prealloc_bytes=64 << 20, block_bytes=64 << 10)
    out = {}
    try:
        for device in ("cuda", "cpu"):
            conns = []

            def make_conn():
                c = tlib.InfinityConnection(tconfig.ClientConfig(
                    host_addr="127.0.0.1", service_port=srv.port, log_level="error"))
                c.connect()
                conns.append(c)
                return c

            h = disagg.DisaggHarness(make_conn, cfg, num_blocks=16, req_blocks=2,
                                     model_id=f"disagg-card-test-{device}", device=device)
            try:
                prompt = h.prompt(seed=1)

                async def legs():
                    got = {"local": (await h.run_local(prompt, gen_tokens=4))["result"]}
                    got["overlapped"] = (await h.run_overlapped(
                        prompt, watermark=1, gen_tokens=4))["result"]
                    h.drop(prompt)
                    got["blocking"] = (await h.run_blocking(prompt, gen_tokens=4))["result"]
                    return got

                out[device] = asyncio.run(legs())
            finally:
                h.close()
                for c in conns:
                    c.close()
    finally:
        srv.stop()
    card, cpu = out["cuda"], out["cpu"]
    for name in ("overlapped", "blocking"):
        assert not card[name].fallback
        assert np.array_equal(card[name].first_logits, card["local"].first_logits)
        assert card[name].tokens == card["local"].tokens
    for name, res in card.items():
        np.testing.assert_allclose(res.first_logits, cpu[name].first_logits, rtol=0, atol=2e-4)
        assert res.tokens == cpu[name].tokens


def _saved_prefix(dev, spec, model_id, seed):
    """A store with one prompt's prefix saved from random caches; returns
    (server, connection, connector, prompt, the source caches, their block
    ids)."""
    from infinistore_tpu_torch import config, lib
    from infinistore_tpu_torch.connector import KVConnector

    srv = lib.start_local_server(prealloc_bytes=64 << 20, block_bytes=32 << 10)
    conn = lib.InfinityConnection(config.ClientConfig(
        host_addr="127.0.0.1", service_port=srv.port, log_level="error"))
    conn.connect()
    kv = KVConnector(conn, spec, model_id, max_blocks=4, device=dev)
    caches = [(_randn(seed + 2 * i, spec.cache_shape, spec.dtype, dev),
               _randn(seed + 2 * i + 1, spec.cache_shape, spec.dtype, dev))
              for i in range(spec.num_layers)]
    prompt = list(range(4 * spec.block_tokens))
    src = np.array([3, 9, 0, 7], np.int32)
    asyncio.run(kv.save(prompt, caches, src))
    return srv, conn, kv, prompt, caches, src


def test_prefetch_install_scatters_on_the_callers_stream(dev):
    """LayerwisePrefetch.install uploads and scatters (K2) in an executor
    thread, on its CALLER's current stream: with the default stream held
    busy, a copy queued on the caller's side stream once install() returned
    reads the installed bytes (on the executor thread's own default stream
    the scatter would still wait behind the hold)."""
    from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec

    spec = PagedKVCacheSpec(2, 16, 16, 8, 128, torch.bfloat16)
    srv, conn, kv, prompt, caches, src = _saved_prefix(dev, spec, "install-stream", 60)
    dst = np.array([5, 1, 12, 8], np.int32)
    side = torch.cuda.Stream(dev)
    try:
        out = spec.make_caches(dev)
        torch.cuda.synchronize()

        async def install():
            handle = await kv.start_fetch_async(prompt)
            await handle.primed()
            with torch.cuda.stream(torch.cuda.default_stream(dev)):
                torch.cuda._sleep(200_000_000)  # about 0.1 s on the default stream
            with torch.cuda.stream(side):
                got, n = await handle.install(out, dst)
                snapshot = [(k.clone(), v.clone()) for k, v in got]
            return n, snapshot

        n, snapshot = asyncio.run(install())
        torch.cuda.synchronize()
        assert n == 4
        for layer in range(spec.num_layers):
            for kind in (0, 1):
                assert torch.equal(snapshot[layer][kind][dst.tolist()],
                                   caches[layer][kind][src.tolist()]), (layer, kind)
    finally:
        kv.close()
        conn.close()
        srv.stop()


def test_v1_layer_wait_orders_the_runners_stream_after_the_load(dev, monkeypatch):
    """The v1 worker loads on its own stream; wait_for_layer_load returns
    once a layer's scatter is enqueued and makes the runner's stream wait
    for it on the device. With every install's scatter held on the device
    (a spin queued before it on its stream, after its block ids are on the
    card), a copy the runner queues on its own stream after each layer's
    wait reads the loaded bytes."""
    import types

    from infinistore_tpu_torch.cuda.layerwise import LayerwisePrefetch
    from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec
    from infinistore_tpu_torch.vllm_v1 import (
        InfiniStoreConnectorMetadata, InfiniStoreKVConnectorV1, KVConnectorRole, _LoadSpec,
    )

    upload_and_scatter = LayerwisePrefetch._upload_and_scatter

    def held(self, caches, ids_dev, kv_host, stream):
        with torch.cuda.stream(stream):
            torch.cuda._sleep(100_000_000)  # about 50 ms before the scatter
        return upload_and_scatter(self, caches, ids_dev, kv_host, stream)

    monkeypatch.setattr(LayerwisePrefetch, "_upload_and_scatter", held)
    spec = PagedKVCacheSpec(3, 16, 16, 8, 128, torch.bfloat16)
    srv, conn, kv, prompt, caches, src = _saved_prefix(dev, spec, "v1-stream", 80)
    dst = np.array([2, 14, 6, 11], np.int32)
    runner = torch.cuda.Stream(dev)
    cfg = types.SimpleNamespace(kv_transfer_config=types.SimpleNamespace(
        kv_connector_extra_config={"kv_connector": kv}))
    worker = InfiniStoreKVConnectorV1(cfg, KVConnectorRole.WORKER)
    try:
        names = [f"layer{i}" for i in range(spec.num_layers)]
        with torch.cuda.stream(runner):
            out = spec.make_caches(dev)
            worker.register_kv_caches(dict(zip(names, out)))
            worker.bind_connector_metadata(InfiniStoreConnectorMetadata(loads=[_LoadSpec(
                req_id="r", token_ids=prompt, block_ids=dst, num_tokens=len(prompt),
                first_block=0)]))
            worker.start_load_kv(forward_context=None)
            snapshot = []
            for name in names:
                worker.wait_for_layer_load(name)
                k, v = worker.kv_cache(name)
                snapshot.append((k.clone(), v.clone()))
            worker.wait_for_save()
            worker.clear_connector_metadata()
        torch.cuda.synchronize()
        assert worker.loaded_tokens("r") == len(prompt)
        for layer in range(spec.num_layers):
            for kind in (0, 1):
                assert torch.equal(snapshot[layer][kind][dst.tolist()],
                                   caches[layer][kind][src.tolist()]), (layer, kind)
    finally:
        worker.close()
        kv.close()
        conn.close()
        srv.stop()


# The JAX package's own kernel cases, on the card against the plain
# versions: tests/test_paged_attention.py:34-40 (num_blocks, block_tokens,
# kv_heads, head_dim, q_heads, table_len), tests/test_flash_prefill.py:36-41
# (B, S, H, KVH, D; its block sizes have no counterpart here) and
# tests/test_kv_quant.py:24 (16 blocks of 8 tokens, 2 KV heads, head_dim 32),
# the groups 3 and 7 beside them, and the model tests' config
# (tests/test_flash_prefill.py:107, tests/test_paged_attention.py:137 and
# :557: LlamaConfig(dim=32, n_heads=4, n_kv_heads=2), head_dim 8, block 8, 8
# cache blocks, tables of 4, prompts of 16 and 24 tokens).
REFERENCE_DECODE_CASES = [(16, 8, 4, 16, 8, 8), (32, 16, 2, 32, 8, 16), (8, 8, 8, 16, 8, 4),
                          (16, 8, 1, 64, 4, 16), (16, 8, 2, 16, 6, 8), (16, 8, 2, 32, 14, 8),
                          (8, 8, 2, 8, 4, 4)]
REFERENCE_PREFILL_CASES = [(1, 32, 4, 2, 16), (2, 64, 8, 8, 32), (1, 16, 4, 1, 64),
                           (1, 48, 2, 2, 16), (1, 40, 6, 2, 16), (2, 70, 14, 2, 32),
                           (1, 24, 4, 2, 8)]


@pytest.mark.parametrize("case", REFERENCE_DECODE_CASES,
                         ids=["gqa2-d16", "gqa4-d32", "mha-d16", "mqa-d64", "g3-d16", "g7-d32",
                              "model-d8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_decode_cases_k3_k5_k6_k7(dev, case, dtype):
    """K3 at the reference's sequence lengths (one token, a partial block, a
    block boundary, mid-table, the full table) and a zero-length row, within
    tolerance of its plain version; two launches bitwise equal; each row
    bitwise its solo launch; the table's entries past a row's sequence
    (out-of-range ids here) change nothing; K6 bitwise K3 per row; K5's and
    K7's one-shard combines bitwise K3 and K6."""
    from infinistore_tpu_torch.cuda import paged_attention as pa

    n, bt, kvh, d, h, ntbl = case
    g = torch.Generator().manual_seed(200)
    kc = _randn(201, (n, bt, kvh, d), dtype, dev)
    vc = _randn(202, (n, bt, kvh, d), dtype, dev)
    lens = [1, bt - 1, bt, ntbl * bt // 2 + 3, ntbl * bt, 0]
    rows = len(lens)
    q = _randn(203, (rows, h, d), dtype, dev)
    tables_np = [torch.randperm(n, generator=g)[:ntbl].numpy().astype(np.int32)
                 for _ in range(rows)]
    tables = torch.from_numpy(np.stack(tables_np)).to(dev)
    masked = tables.clone()
    for r, length in enumerate(lens):
        masked[r, -(-length // bt):] = -1
    seq = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = pa.paged_decode_attention_batched(q, kc, vc, tables, seq)
    again = pa.paged_decode_attention_batched(q, kc, vc, tables, seq)
    on_masked = pa.paged_decode_attention_batched(q, kc, vc, masked, seq)
    want = pa.paged_decode_attention_plain_batched(q, kc, vc, tables, seq)
    torch.cuda.synchronize()
    assert _err(got, want) <= TOL[dtype]
    assert torch.equal(got, again) and torch.equal(got, on_masked)
    assert torch.all(got[-1] == 0)
    for r in range(rows):
        solo = pa.paged_decode_attention_batched(q[r:r + 1].contiguous(), kc, vc,
                                                 tables[r:r + 1].contiguous(),
                                                 seq[r:r + 1].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(solo[0], got[r]), r
    ident = lambda t: t  # noqa: E731
    assert torch.equal(pa.combine_stats(*pa._decode_attention_stats(q, kc, vc, tables, seq),
                                        dtype, ident, ident), got)
    m = pa.build_ragged_wave(tables_np, lens, bt, pad_to_pow2=True)
    meta = [torch.from_numpy(x).to(dev) for x in (m.pages, m.page_rows, m.page_starts,
                                                    m.seq_lens)]
    k6 = pa.paged_decode_attention_ragged(q, kc, vc, *meta, table_width=ntbl)
    k6_plain = pa.paged_decode_attention_ragged_plain(q, kc, vc, meta[0], meta[2], meta[3], ntbl)
    rstats = pa._decode_attention_stats_ragged(q, kc, vc, *meta, table_width=ntbl)
    torch.cuda.synchronize()
    assert _err(k6, k6_plain) <= TOL[dtype]
    assert torch.equal(k6, got)
    assert torch.equal(pa.combine_stats(*rstats, dtype, ident, ident), k6)


@pytest.mark.parametrize("case", REFERENCE_PREFILL_CASES,
                         ids=["gqa2-d16", "mha-d32", "mqa-d64", "d16", "g3-d16", "g7-d32",
                              "model-d8"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_prefill_cases_k4(dev, case, causal, dtype):
    """K4 at the reference's prefill cases, causal and full, bf16 on its
    tensor-core kernel and f32 on its CUDA-core one (each launch counted by
    its kernel's counter), within tolerance of the plain version."""
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import flash_prefill as fp

    b, s, h, kvh, d = case
    q = _randn(210, (b, s, h, d), dtype, dev)
    k = _randn(211, (b, s, kvh, d), dtype, dev)
    v = _randn(212, (b, s, kvh, d), dtype, dev)
    before = dict(_ext.LAUNCHES)
    got = fp.flash_prefill_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["flash_prefill"] == before["flash_prefill"] + 1
    assert _ext.LAUNCHES["flash_prefill_wgmma"] == (before["flash_prefill_wgmma"]
                                                    + int(dtype is torch.bfloat16))
    assert _err(got, fp.flash_prefill_plain(q, k, v, causal=causal)) <= TOL[dtype]


@pytest.mark.parametrize("h,d", [(4, 32), (8, 32), (4, 16), (6, 32), (14, 16), (4, 8)],
                         ids=["g2-d32", "g4-d32", "g2-d16", "g3-d32", "g7-d16", "g2-d8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_int8_geometry_k8(dev, h, d, dtype):
    """K8 at tests/test_kv_quant.py's geometry (16 blocks of 8 tokens, 2 KV
    heads, head_dim 32) and at head_dim 16, groups 2, 4, 3 and 7: its
    contract (plain version, K3 over the dequantised cache, two launches and
    solo rows bitwise), a zero-length row zeros."""
    from infinistore_tpu_torch.cuda import kv_quant as kq
    from infinistore_tpu_torch.cuda import paged_attention as pa

    n, bt, kvh, ntbl = 16, 8, 2, 4
    q = _randn(220, (5, h, d), dtype, dev)
    kd, ks = kq.quantize_kv(_randn(221, (n, bt, kvh, d), torch.float32, dev) * 3)
    vd, vs = kq.quantize_kv(_randn(222, (n, bt, kvh, d), torch.float32, dev))
    g = torch.Generator().manual_seed(223)
    tables = torch.stack([torch.randperm(n, generator=g)[:ntbl] for _ in range(5)])
    tables = tables.to(device=dev, dtype=torch.int32)
    lens = torch.tensor([0, 1, bt, 2 * bt + 3, ntbl * bt], dtype=torch.int32, device=dev)
    got = kq.paged_decode_attention_quantized(q, kd, ks, vd, vs, tables, lens)
    _assert_k8_contract(kq, pa, q, kd, ks, vd, vs, tables, lens, got)
    assert torch.all(got[0] == 0)
