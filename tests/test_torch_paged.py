"""The PyTorch port's paged block ops (infinistore_tpu_torch/cuda/paged.py)
against the JAX package's: the Pallas gather/scatter kernels in interpret
mode and their XLA forms, on the same numpy inputs. On the CPU the port runs
the plain versions of kernels K1/K2 (index_select / in-place index_copy_);
both sides must agree bit for bit."""

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
from infinistore_tpu_torch.cuda import paged
from infinistore_tpu_torch.cuda.paged import (
    PagedKVCacheSpec,
    gather_blocks,
    scatter_blocks,
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
        paged._gather_blocks_cuda(cache, ids)
    with pytest.raises(ValueError):
        paged._scatter_blocks_cuda(cache, ids, cache[:1].clone())
    with pytest.raises(ValueError, match="int32"):
        paged._gather_blocks_cuda(cache, ids.long())
