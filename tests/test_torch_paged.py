"""The PyTorch port's paged block ops (infinistore_tpu_torch/cuda/paged.py)
against the JAX package's: the Pallas gather/scatter kernels in interpret
mode and their XLA forms, on the same numpy inputs. On the CPU the port runs
the plain versions of kernels K1/K2 (index_select / in-place index_copy_);
both sides must agree bit for bit. The batched entry points
(``gather_blocks_many`` / ``scatter_blocks_many``) are held against the JAX
package's per-cache calls and their concatenate, and the CUDA wrappers'
dispatch (bulk ring or vector kernel, pointer tables, launches per
``MAX_CACHES`` caches, counters, no fallback) against a fake kernel library
on CPU tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.tpu.paged import (
    PagedKVCacheSpec as JaxPagedKVCacheSpec,
    _gather_blocks_pallas,
    _scatter_blocks_pallas,
    gather_blocks_xla,
    scatter_blocks_xla,
)
from infinistore_tpu_torch.cuda import _ext, paged
from infinistore_tpu_torch.cuda.paged import (
    PagedKVCacheSpec,
    gather_blocks,
    gather_blocks_many,
    scatter_blocks,
    scatter_blocks_many,
)

SHAPE = (32, 8, 2, 64)  # [num_blocks, block_tokens, kv_heads, head_dim]
DTYPES = [
    (torch.float32, jnp.float32),
    (torch.bfloat16, jnp.bfloat16),
]


def _pair(seed, shape, dtypes):
    """The same values as a torch tensor and a jax array (bf16 rounded once,
    from the same f32 numbers, on both sides)."""
    t_dtype, j_dtype = dtypes
    base = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(base).to(t_dtype), jnp.asarray(base).astype(j_dtype)


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_gather_matches_jax_pallas_and_xla(dtypes):
    cache_t, cache_j = _pair(0, SHAPE, dtypes)
    assert _bytes(cache_t) == _bytes(cache_j)
    ids = np.array([7, 0, 13, 2, 31], dtype=np.int32)
    got = gather_blocks(cache_t, torch.from_numpy(ids))
    assert tuple(got.shape) == (5, *SHAPE[1:])
    want_pallas = _gather_blocks_pallas(cache_j, jnp.asarray(ids), interpret=True)
    want_xla = gather_blocks_xla(cache_j, jnp.asarray(ids))
    assert _bytes(got) == _bytes(want_pallas) == _bytes(want_xla)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_scatter_matches_jax_pallas_and_xla(dtypes):
    cache_t, cache_j = _pair(1, SHAPE, dtypes)
    blocks_t, blocks_j = _pair(2, (4, *SHAPE[1:]), dtypes)
    ids = np.array([5, 9, 30, 1], dtype=np.int32)
    got = scatter_blocks(cache_t, torch.from_numpy(ids), blocks_t)
    assert got is cache_t  # in place
    want_pallas = _scatter_blocks_pallas(cache_j + 0, jnp.asarray(ids), blocks_j, interpret=True)
    want_xla = scatter_blocks_xla(cache_j, jnp.asarray(ids), blocks_j)
    assert _bytes(got) == _bytes(want_pallas) == _bytes(want_xla)


def test_scatter_aliasing_regression():
    """Mirror of the JAX package's donation-aliasing regression: the scatter
    writes in place, so make_caches must hand out distinct tensors and
    blocks a scatter does not name must keep their bytes."""
    spec = PagedKVCacheSpec(2, 16, 8, 2, 64, torch.bfloat16)
    caches = spec.make_caches(device="cpu")
    ptrs = {t.data_ptr() for kv in caches for t in kv}
    assert len(ptrs) == 2 * spec.num_layers, "aliased zeros tensor across K/V caches"
    for k, v in caches:
        assert tuple(k.shape) == spec.cache_shape and not k.any() and not v.any()

    cache, _ = _pair(11, SHAPE, DTYPES[1])
    before = cache.clone()
    blocks, _ = _pair(12, (2, *SHAPE[1:]), DTYPES[1])
    ids = torch.tensor([5, 9], dtype=torch.int32)
    out = scatter_blocks(cache, ids, blocks)
    assert out.data_ptr() == cache.data_ptr()
    untouched = [i for i in range(SHAPE[0]) if i not in (5, 9)]
    assert torch.equal(out[untouched], before[untouched])
    assert torch.equal(out[[5, 9]], blocks)

    # Scattering into one layer's K leaves every other cache untouched.
    k0, _ = caches[0]
    scatter_blocks(k0, ids, blocks)
    assert all(not t.any() for kv in caches[1:] for t in kv) and not caches[0][1].any()


@pytest.mark.parametrize("t_dtype,j_dtype", DTYPES, ids=["f32", "bf16"])
def test_spec_block_nbytes_matches_jax(t_dtype, j_dtype):
    args = (4, 32, 16, 8, 128)
    assert PagedKVCacheSpec(*args, t_dtype).block_nbytes == JaxPagedKVCacheSpec(*args, j_dtype).block_nbytes
    assert PagedKVCacheSpec(*args, t_dtype).cache_shape == JaxPagedKVCacheSpec(*args, j_dtype).cache_shape


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel paths never take a CPU tensor (the dispatchers send those to
    the plain versions); handed one, they raise before any build or launch."""
    cache = torch.zeros(SHAPE)
    ids = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged._gather_many_cuda([cache], ids)
    with pytest.raises(ValueError):
        paged._scatter_many_cuda([cache], ids, cache[:1].clone())
    with pytest.raises(ValueError, match="int32"):
        paged._gather_many_cuda([cache], ids.long())


# ---------------------------------------------------------------------------
# The batched entry points against the JAX package's per-cache calls.
# ---------------------------------------------------------------------------


def _caches(seed, count, dtypes, shape=SHAPE):
    pairs = [_pair(seed + c, shape, dtypes) for c in range(count)]
    return [t for t, _ in pairs], [j for _, j in pairs]


@pytest.mark.parametrize("count", [1, 2, 5])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_gather_many_matches_jax_concatenate(dtypes, count):
    caches_t, caches_j = _caches(20, count, dtypes)
    ids = np.array([7, 0, 13, 2, 31, 13], dtype=np.int32)
    got = gather_blocks_many(caches_t, torch.from_numpy(ids))
    assert tuple(got.shape) == (count * len(ids), *SHAPE[1:])
    ids_j = jnp.asarray(ids)
    want_pallas = jnp.concatenate(
        [_gather_blocks_pallas(c, ids_j, interpret=True) for c in caches_j])
    want_xla = jnp.concatenate([gather_blocks_xla(c, ids_j) for c in caches_j])
    assert _bytes(got) == _bytes(want_pallas) == _bytes(want_xla)
    assert _bytes(got) == _bytes(paged.gather_blocks_many_plain(caches_t, torch.from_numpy(ids)))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "sequence"])
@pytest.mark.parametrize("count", [1, 2, 5])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_scatter_many_matches_jax_per_cache(dtypes, count, packed):
    caches_t, caches_j = _caches(40, count, dtypes)
    ids = np.array([5, 9, 30, 1], dtype=np.int32)
    n = len(ids)
    blocks_t, blocks_j = _pair(60, (count * n, *SHAPE[1:]), dtypes)
    sources = blocks_t if packed else [blocks_t[c * n:(c + 1) * n].clone() for c in range(count)]
    ptrs = [c.data_ptr() for c in caches_t]
    got = scatter_blocks_many(caches_t, torch.from_numpy(ids), sources)
    assert [c.data_ptr() for c in got] == ptrs  # in place
    ids_j = jnp.asarray(ids)
    for c in range(count):
        part = blocks_j[c * n:(c + 1) * n]
        want_pallas = _scatter_blocks_pallas(caches_j[c] + 0, ids_j, part, interpret=True)
        want_xla = scatter_blocks_xla(caches_j[c], ids_j, part)
        assert _bytes(got[c]) == _bytes(want_pallas) == _bytes(want_xla)


def test_many_with_one_cache_is_the_single_cache_call():
    (cache,), _ = _caches(70, 1, DTYPES[1])
    ids = torch.tensor([3, 3, 0, 17], dtype=torch.int32)
    assert torch.equal(gather_blocks_many([cache], ids), gather_blocks(cache, ids))
    blocks, _ = _pair(71, (4, *SHAPE[1:]), DTYPES[1])
    blocks = blocks[[0, 0, 2, 3]]  # duplicate ids carry equal blocks: no race to lose
    want = scatter_blocks(cache.clone(), ids, blocks)
    assert torch.equal(scatter_blocks_many([cache], ids, blocks)[0], want)


def test_many_takes_more_caches_than_one_launch_holds():
    count = paged.MAX_CACHES + 1
    caches, _ = _caches(80, count, DTYPES[0], shape=(6, 2, 1, 4))
    ids = torch.tensor([4, 1], dtype=torch.int32)
    got = gather_blocks_many(caches, ids)
    assert torch.equal(got, torch.cat([c[[4, 1]] for c in caches]))
    fresh = [torch.zeros_like(c) for c in caches]
    scatter_blocks_many(fresh, ids, got)
    for c, f in zip(caches, fresh):
        assert torch.equal(f[[4, 1]], c[[4, 1]]) and not f[[0, 2, 3, 5]].any()


def test_many_with_no_blocks():
    caches, _ = _caches(90, 2, DTYPES[1])
    ids = torch.zeros(0, dtype=torch.int32)
    got = gather_blocks_many(caches, ids)
    assert tuple(got.shape) == (0, *SHAPE[1:]) and got.dtype == torch.bfloat16
    before = [c.clone() for c in caches]
    scatter_blocks_many(caches, ids, got)
    assert all(torch.equal(c, b) for c, b in zip(caches, before))


@pytest.mark.parametrize("other,match", [
    (torch.zeros((32, 8, 2, 64), dtype=torch.bfloat16), "share device, dtype"),
    (torch.zeros((31, 8, 2, 64)), "share device, dtype"),
    (torch.zeros((32, 8, 2, 32)), "share device, dtype"),
], ids=["dtype", "num_blocks", "block_shape"])
def test_many_refuses_mismatched_caches(other, match):
    cache = torch.zeros(SHAPE)
    ids = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        gather_blocks_many([cache, other], ids)
    with pytest.raises(ValueError, match=match):
        scatter_blocks_many([cache, other], ids, torch.zeros((2, *SHAPE[1:])))
    with pytest.raises(ValueError, match="no caches"):
        gather_blocks_many([], ids)


@pytest.mark.parametrize("blocks,match", [
    (torch.zeros((3, *SHAPE[1:])), "blocks must be"),
    ([torch.zeros((1, *SHAPE[1:]))], "1 sources for 2 caches"),
    ([torch.zeros((1, *SHAPE[1:])), torch.zeros((1, *SHAPE[1:]), dtype=torch.bfloat16)],
     "blocks must be"),
], ids=["packed-rows", "sources", "source-dtype"])
def test_scatter_many_refuses_wrong_sources(blocks, match):
    caches = [torch.zeros(SHAPE), torch.zeros(SHAPE)]
    with pytest.raises(ValueError, match=match):
        scatter_blocks_many(caches, torch.tensor([1], dtype=torch.int32), blocks)
    assert not any(c.any() for c in caches)


# ---------------------------------------------------------------------------
# The CUDA wrappers' dispatch, on CPU tensors, against a fake kernel library
# that records its calls: which entry (bulk ring or vector kernel) each call
# reaches, with which pointer tables, and which counters move.
# ---------------------------------------------------------------------------

_STREAM = 0x5EED


class _FakeLib:
    def __init__(self, code=0):
        self.calls = []
        self.code = code

    def __getattr__(self, name):
        if name not in _ext.ARGTYPES:
            raise AttributeError(name)

        def call(*args):
            argtypes = _ext.ARGTYPES[name]
            assert len(args) == len(argtypes), (name, args)
            for kind, arg in zip(argtypes, args):
                kind.from_param(arg)  # converts as ctypes will convert it
            caches, flats, ids, *rest = args
            self.calls.append((name, list(caches), list(flats), ids, *rest))
            return self.code

        return call


@pytest.fixture()
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_ext, "kernels", lambda: lib)
    monkeypatch.setattr(_ext, "require_cuda", lambda name, device, **tensors: None)
    monkeypatch.setattr(_ext, "stream_of", lambda t: _STREAM)
    monkeypatch.setattr(_ext, "LAUNCHES", dict.fromkeys(_ext.LAUNCHES, 0))
    return lib


def _counts():
    return {k: v for k, v in _ext.LAUNCHES.items() if "blocks" in k}


def _zeros(count, shape=SHAPE, dtype=torch.bfloat16):
    return [torch.zeros(shape, dtype=dtype) for _ in range(count)]


def test_aligned_gather_reaches_the_bulk_entry(fake_lib):
    caches = _zeros(2)
    ids = torch.tensor([3, 1, 4], dtype=torch.int32)
    out = paged._gather_many_cuda(caches, ids)
    bb = 8 * 2 * 64 * 2
    assert tuple(out.shape) == (6, *SHAPE[1:])
    # caches, flats, ids, C, n, num_blocks, block_bytes, stream: its argtypes' order.
    assert fake_lib.calls == [(
        "its_gather_blocks_many", [c.data_ptr() for c in caches],
        [out.data_ptr(), out.data_ptr() + 3 * bb], ids.data_ptr(), 2, 3, 32, bb, _STREAM)]
    assert _counts() == {"gather_blocks": 1, "gather_blocks_bulk": 1,
                         "scatter_blocks": 0, "scatter_blocks_bulk": 0}


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "sequence"])
def test_aligned_scatter_reaches_the_bulk_entry(fake_lib, packed):
    caches = _zeros(2)
    ids = torch.tensor([3, 1], dtype=torch.int32)
    bb = 8 * 2 * 64 * 2
    if packed:
        blocks = torch.zeros((4, *SHAPE[1:]), dtype=torch.bfloat16)
        flats = [blocks.data_ptr(), blocks.data_ptr() + 2 * bb]
    else:
        blocks = _zeros(2, shape=(2, *SHAPE[1:]))
        flats = [b.data_ptr() for b in blocks]
    got = paged._scatter_many_cuda(caches, ids, blocks)
    assert [g.data_ptr() for g in got] == [c.data_ptr() for c in caches]
    assert fake_lib.calls == [(
        "its_scatter_blocks_many", [c.data_ptr() for c in caches], flats, ids.data_ptr(),
        2, 2, 32, bb, _STREAM)]
    assert _counts() == {"gather_blocks": 0, "gather_blocks_bulk": 0,
                         "scatter_blocks": 1, "scatter_blocks_bulk": 1}


def test_single_cache_calls_take_the_same_entries(fake_lib):
    """``gather_blocks`` / ``scatter_blocks`` on a tensor that is not on the
    CPU (a meta tensor stands in for the card's) reach the batched entries
    with C = 1."""
    cache = torch.zeros(SHAPE, dtype=torch.bfloat16, device="meta")
    ids = torch.tensor([2, 5], dtype=torch.int32, device="meta")
    out = gather_blocks(cache, ids)
    assert tuple(out.shape) == (2, *SHAPE[1:]) and out.device.type == "meta"
    assert scatter_blocks(cache, ids, out) is cache
    bb = 8 * 2 * 64 * 2
    assert fake_lib.calls == [
        ("its_gather_blocks_many", [None], [None], 0, 1, 2, 32, bb, _STREAM),
        ("its_scatter_blocks_many", [None], [None], 0, 1, 2, 32, bb, _STREAM)]
    assert _counts() == {"gather_blocks": 1, "gather_blocks_bulk": 1,
                         "scatter_blocks": 1, "scatter_blocks_bulk": 1}


def test_a_60_byte_block_takes_the_vector_entry(fake_lib):
    caches = _zeros(2, shape=(9, 15), dtype=torch.float32)  # 60 bytes a block
    ids = torch.tensor([8, 0], dtype=torch.int32)
    out = paged._gather_many_cuda(caches, ids)
    paged._scatter_many_cuda(caches, ids, out)
    assert fake_lib.calls == [
        ("its_gather_blocks_many_vec", [c.data_ptr() for c in caches],
         [out.data_ptr(), out.data_ptr() + 120], ids.data_ptr(), 2, 2, 9, 60, _STREAM),
        ("its_scatter_blocks_many_vec", [c.data_ptr() for c in caches],
         [out.data_ptr(), out.data_ptr() + 120], ids.data_ptr(), 2, 2, 9, 60, _STREAM)]
    assert _counts() == {"gather_blocks": 1, "gather_blocks_bulk": 0,
                         "scatter_blocks": 1, "scatter_blocks_bulk": 0}


def test_a_misaligned_pointer_takes_the_vector_entry(fake_lib):
    (cache,) = _zeros(1)
    shifted = torch.empty(cache.numel() + 1, dtype=torch.bfloat16)[1:].view(SHAPE)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    ids = torch.tensor([1], dtype=torch.int32)
    paged._gather_many_cuda([cache, shifted], ids)
    assert fake_lib.calls[0][0] == "its_gather_blocks_many_vec"
    assert _counts()["gather_blocks"] == 1 and _counts()["gather_blocks_bulk"] == 0


def test_65_caches_take_two_launches_in_order(fake_lib):
    count = paged.MAX_CACHES + 1
    caches = _zeros(count, shape=(4, 16))
    ids = torch.tensor([2, 0, 3], dtype=torch.int32)
    out = paged._gather_many_cuda(caches, ids)
    step = 3 * 16 * 2
    ptrs = [c.data_ptr() for c in caches]
    flats = [out.data_ptr() + c * step for c in range(count)]
    assert fake_lib.calls == [
        ("its_gather_blocks_many", ptrs[:64], flats[:64], ids.data_ptr(), 64, 3, 4, 32, _STREAM),
        ("its_gather_blocks_many", ptrs[64:], flats[64:], ids.data_ptr(), 1, 3, 4, 32, _STREAM)]
    assert _counts()["gather_blocks"] == 2 and _counts()["gather_blocks_bulk"] == 2
    paged._scatter_many_cuda(caches, ids, out)
    assert [c[4] for c in fake_lib.calls[2:]] == [64, 1]
    assert _counts()["scatter_blocks"] == 2 and _counts()["scatter_blocks_bulk"] == 2


def test_no_blocks_launch_nothing(fake_lib):
    caches = _zeros(2)
    ids = torch.zeros(0, dtype=torch.int32)
    out = paged._gather_many_cuda(caches, ids)
    paged._scatter_many_cuda(caches, ids, out)
    assert tuple(out.shape) == (0, *SHAPE[1:])
    assert fake_lib.calls == [] and not any(_counts().values())


def test_mismatched_caches_raise_before_any_launch(fake_lib):
    ids = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError, match="share device, dtype"):
        paged._gather_many_cuda([torch.zeros(SHAPE), torch.zeros((16, *SHAPE[1:]))], ids)
    with pytest.raises(ValueError, match="blocks must be"):
        paged._scatter_many_cuda(_zeros(2), ids, torch.zeros((2, *SHAPE[1:])))
    assert fake_lib.calls == [] and not any(_counts().values())


@pytest.mark.parametrize("shape,entry", [(SHAPE, "its_gather_blocks_many"),
                                         ((9, 15), "its_gather_blocks_many_vec")],
                         ids=["bulk", "vector"])
def test_a_failed_launch_raises_and_nothing_falls_back(fake_lib, shape, entry):
    fake_lib.code = 700
    with pytest.raises(RuntimeError, match="gather_blocks: CUDA error 700"):
        paged._gather_many_cuda(_zeros(2, shape=shape, dtype=torch.float32),
                                torch.tensor([1], dtype=torch.int32))
    # The one call went to the route its alignment chose; nothing else was tried.
    assert [c[0] for c in fake_lib.calls] == [entry]
    with pytest.raises(RuntimeError, match="scatter_blocks: CUDA error 700"):
        paged._scatter_many_cuda(_zeros(2, shape=shape, dtype=torch.float32),
                                 torch.tensor([1], dtype=torch.int32),
                                 torch.zeros((2, *shape[1:])))
    assert len(fake_lib.calls) == 2


def test_chip_smoke_copy_shapes_rehearsal_on_cpu():
    """``chip_smoke.py``'s K1/K2 shapes (``copy_calls``) run here on the CPU
    at a tiny block: the batched calls, the unfused sequences they are timed
    against and the plain versions move the same bytes at every shape."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    inp = cs.copy_inputs(torch, torch.Generator().manual_seed(3), torch.bfloat16, (2, 1, 8), 64,
                         device="cpu")
    fused = (gather_blocks, scatter_blocks, gather_blocks_many, scatter_blocks_many)
    plain = (paged.gather_blocks_plain, paged.scatter_blocks_plain,
             paged.gather_blocks_many_plain, paged.scatter_blocks_many_plain)
    keys = set(cs.copy_calls(inp, *fused))
    assert keys == {(kind, shape) for kind, shapes in cs.COPY_SHAPES.items()
                    for shape in (*shapes, "table")}
    for key in sorted(keys):
        assert cs.copy_matches(torch, inp, key, fused, plain), key
        runs = []
        for calls in (fused, (gather_blocks, scatter_blocks)):
            mine = dict(inp, caches=[c.clone() for c in inp["caches"]])
            got = cs.copy_calls(mine, *calls)[key]()
            if key[0] == "gather_blocks":
                runs.append(torch.cat(got) if isinstance(got, list) else got)
            else:
                runs.append(torch.stack(mine["caches"]))
        assert torch.equal(runs[0], runs[1]), key
